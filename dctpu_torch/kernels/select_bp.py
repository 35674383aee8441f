"""K1 and K2: exact adaptive-selection totals (FORMAT §4.1), per block.

Counterparts of ``dctpu/kernels/select_bp.py``: ``adaptive_totals_xbp`` (K1,
the DELTA and DOUBLE_DELTA candidates derived from the raw samples in one
read) and ``adaptive_totals_bp`` (K2, one candidate's zigzag values). K2 has
a second form, :func:`adaptive_totals_lpc`, which derives one LPC
candidate's residuals from the raw samples in the kernel; adaptive
selection runs it for the LPC candidates. Each returns, per block, the
exact RICE coded-bit total for every k in [0, k_max] and the exact VERTICAL
word count. The CUDA kernels are in ``dctpu_torch/csrc/select.cu``.

The kernels reach the RICE totals from a bit-length histogram, not a pass
per k: :func:`rice_totals_from_lengths` is that arithmetic in plain torch,
and the twins use it.

Each wrapper runs its plain torch twin for tensors on the CPU and launches
its kernel for tensors on a CUDA device; its ``launches`` attribute counts
the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import bitlen, to_u32
from dctpu_torch.codec.predict import residuals_for_candidate
from dctpu_torch.codec.rice import zigzag
from dctpu_torch.constants import DELTA, DOUBLE_DELTA, LPC, MAX_CODE_BITS
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.args import check_x, lpc_coeffs
from dctpu_torch.kernels.vertical import vertical_total_words


def _check_args(block_len: int, k_max: int) -> None:
    if not 0 <= k_max < 28:
        raise ValueError(f"k_max must be in [0, 28), got {k_max}")
    if block_len * MAX_CODE_BITS >= 2**26:
        raise ValueError(f"block_len {block_len} too large for the packed key")


def length_counts(z: torch.Tensor, n: torch.Tensor):
    """Bit-length histogram of each block's valid zigzag values.

    Returns (C [B, 33], S [B, 3, 33]) int64: C[b] = #{samples with bit
    length b}, S[:, j-1, b] = #{samples with bit length b whose bit b-1-j
    is set}, j = 1..3 (the three bits below the leading one)."""
    B, L = z.shape
    valid = torch.arange(L, device=z.device)[None, :] < n.to(torch.int64)[:, None]
    u = torch.where(valid, to_u32(z), 0)
    bl = bitlen(u)

    def hist(w):
        return torch.zeros((B, 33), dtype=torch.int64, device=z.device).scatter_add_(
            1, bl, w
        )

    S = [
        hist(torch.where(bl > j, (u >> (bl - 1 - j).clamp(min=0)) & 1, 0))
        for j in (1, 2, 3)
    ]
    return hist(torch.ones_like(bl)), torch.stack(S, dim=1)


def rice_totals_from_lengths(
    z: torch.Tensor, n: torch.Tensor, k_max: int
) -> torch.Tensor:
    """Exact RICE coded bits per block and k, [B, k_max + 1] int64, for
    k_max < 28, from the bit-length histogram (the arithmetic of K1/K2):

      L(k) = 48 G + (k+1) (n - G)
             + sum_{d=1..4} (2^(d-1) C[k+d] + sum_{j=1..d-1} 2^(d-1-j) S_j[k+d])

    with G = #{bit length > k+4}. The same integers as
    ``rice.rice_totals``, which sums the definition per k."""
    C, S = length_counts(z, n)
    nb = n.to(torch.int64).clamp(0, z.shape[1])[:, None]
    above = C.flip(1).cumsum(1).flip(1)  # above[b] = #{bit length >= b}
    k = torch.arange(k_max + 1, device=z.device)
    G = above[:, k + 5]
    t = MAX_CODE_BITS * G + (k + 1) * (nb - G)
    for d in range(1, 5):
        t = t + (C[:, k + d] << (d - 1))
        for j in range(1, d):
            t = t + (S[:, j - 1, k + d] << (d - 1 - j))
    return t


def adaptive_totals_bp_plain(z, n, block_len: int, k_max: int):
    """Plain twin of K2: (totals [B, k_max+1] int32, vwords [B] int32)."""
    return (
        rice_totals_from_lengths(z, n, k_max).to(torch.int32),
        vertical_total_words(z, n, block_len).to(torch.int32),
    )


def adaptive_totals_bp(
    z: torch.Tensor,  # [B, L] int32 zigzag bit patterns (garbage past n)
    n: torch.Tensor,  # [B] valid counts
    block_len: int,
    k_max: int,
):
    """K2: (rice_totals [B, k_max+1] int32, vertical_words [B] int32)."""
    _check_args(block_len, k_max)
    if z.device.type == "cpu":
        return adaptive_totals_bp_plain(z, n, block_len, k_max)
    if z.device.type != "cuda":
        raise ValueError(f"adaptive_totals_bp: unsupported device {z.device}")
    n = n.to(torch.int32).contiguous()
    _build.check_tensors("adaptive_totals_bp", z, n)
    B, L = z.shape
    if L != block_len or n.shape != (B,):
        raise ValueError("adaptive_totals_bp: expects z [B, block_len], n [B]")
    out = torch.empty((B, k_max + 2), dtype=torch.int32, device=z.device)
    if B:
        _build.launch(
            "dct_select_bp", z,
            z.data_ptr(), n.data_ptr(), out.data_ptr(), B, L, k_max,
        )
        adaptive_totals_bp.launches += 1
    return out[:, : k_max + 1], out[:, k_max + 1]


adaptive_totals_bp.launches = 0


def adaptive_totals_lpc_plain(x, history, n, coeffs, block_len: int, k_max: int):
    """Plain twin of K2's LPC form: K2's twin on the candidate's zigzag
    residuals."""
    return adaptive_totals_bp_plain(
        zigzag(residuals_for_candidate(x, history, LPC, coeffs)),
        n, block_len, k_max,
    )


def adaptive_totals_lpc(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    coeffs,                 # four int32 Q16 coefficients of one LPC table
    block_len: int,
    k_max: int,
):
    """K2, LPC form: the totals of one LPC candidate, its residuals derived
    from x in the kernel (wrapping int64 accumulator, arithmetic >> 16, as
    ``predict.residuals_for_candidate``).

    Returns (rice_totals [B, k_max+1] int32, vertical_words [B] int32).
    Raises ValueError for a coefficient outside int32, the frame's type."""
    _check_args(block_len, k_max)
    coeffs = lpc_coeffs(coeffs)
    if x.device.type == "cpu":
        return adaptive_totals_lpc_plain(x, history, n, coeffs, block_len, k_max)
    if x.device.type != "cuda":
        raise ValueError(f"adaptive_totals_lpc: unsupported device {x.device}")
    n = check_x("adaptive_totals_lpc", x, history, n, block_len)
    B, L = x.shape
    out = torch.empty((B, k_max + 2), dtype=torch.int32, device=x.device)
    if B:
        _build.launch(
            "dct_select_lpc", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), out.data_ptr(),
            B, L, k_max, *coeffs,
        )
        adaptive_totals_lpc.launches += 1
    return out[:, : k_max + 1], out[:, k_max + 1]


adaptive_totals_lpc.launches = 0


def adaptive_totals_xbp_plain(x, history, n, block_len: int, k_max: int):
    """Plain twin of K1: (totals [2, B, k_max+1], vwords [2, B]) int32."""
    res = [
        adaptive_totals_bp_plain(
            zigzag(residuals_for_candidate(x, history, pred, None)),
            n, block_len, k_max,
        )
        for pred in (DELTA, DOUBLE_DELTA)
    ]
    return (
        torch.stack([t for t, _ in res]),
        torch.stack([v for _, v in res]),
    )


def adaptive_totals_xbp(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    block_len: int,
    k_max: int,
):
    """K1: DELTA + DOUBLE_DELTA totals from one read of x.

    Returns (totals [2, B, k_max+1] int32, vwords [2, B] int32), candidate
    axis order (DELTA, DOUBLE_DELTA)."""
    _check_args(block_len, k_max)
    if x.device.type == "cpu":
        return adaptive_totals_xbp_plain(x, history, n, block_len, k_max)
    if x.device.type != "cuda":
        raise ValueError(f"adaptive_totals_xbp: unsupported device {x.device}")
    n = check_x("adaptive_totals_xbp", x, history, n, block_len)
    B, L = x.shape
    out = torch.empty((B, 2, k_max + 2), dtype=torch.int32, device=x.device)
    if B:
        _build.launch(
            "dct_select_xbp", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), out.data_ptr(),
            B, L, k_max,
        )
        adaptive_totals_xbp.launches += 1
    out = out.permute(1, 0, 2)
    return out[:, :, : k_max + 1], out[:, :, k_max + 1]


adaptive_totals_xbp.launches = 0
