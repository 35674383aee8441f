"""K6: exact RICE coded bits per block and k, for the coder="rice" k choice.

The counterpart of ``dctpu/kernels/select_pallas.py`` ``rice_totals_pallas``:
for every block, the exact total of RICE codeword lengths over its valid
samples for each k in [0, k_max] (FORMAT §4). The CUDA kernels are K1/K2's
template without the VERTICAL word count (``dctpu_torch/csrc/select.cu``),
in three forms:

  * :func:`rice_totals` (``dct_rice_totals``): one candidate's zigzag
    values, the reference's contract (``rice.choose_k_auto``);
  * :func:`rice_totals_xbp` (``dct_rice_totals_xbp``): DELTA and
    DOUBLE_DELTA, their residuals derived from the raw samples in one read;
  * :func:`rice_totals_lpc` (``dct_rice_totals_lpc``): one LPC candidate,
    its residuals derived from the raw samples.

``encode.select_blocks`` runs the two x forms, so the rice selection reads
only the samples. The twins sum the definition per k (``rice.rice_totals``)
on torch's residuals, an arithmetic apart from the kernels' histogram.

Each wrapper runs its plain torch twin for tensors on the CPU and launches
its kernel for tensors on a CUDA device; its ``launches`` attribute counts
the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch.codec import rice
from dctpu_torch.codec.predict import residuals_for_candidate
from dctpu_torch.constants import DELTA, DOUBLE_DELTA, LPC, MAX_CODE_BITS
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.args import check_x, lpc_coeffs


def _check_args(block_len: int, k_max: int) -> None:
    # the reference RICE coder's own bound (dctpu/codec/rice.py choose_k_auto)
    if not 0 <= k_max <= 24:
        raise ValueError(f"RICE k_max must be in [0, 24], got {k_max}")
    if block_len * MAX_CODE_BITS >= 2**26:
        raise ValueError(f"block_len {block_len} too large for the packed key")


def rice_totals_plain(z, n, block_len: int, k_max: int) -> torch.Tensor:
    """Plain twin of K6: totals [B, k_max+1] int32."""
    return rice.rice_totals(z, n, k_max).to(torch.int32)


def rice_totals(
    z: torch.Tensor,  # [B, L] int32 zigzag bit patterns (garbage past n)
    n: torch.Tensor,  # [B] valid counts
    block_len: int,
    k_max: int,
) -> torch.Tensor:
    """K6: exact RICE coded bits [B, k_max+1] int32."""
    _check_args(block_len, k_max)
    if z.device.type == "cpu":
        return rice_totals_plain(z, n, block_len, k_max)
    if z.device.type != "cuda":
        raise ValueError(f"rice_totals: unsupported device {z.device}")
    n = n.to(torch.int32).contiguous()
    _build.check_tensors("rice_totals", z, n)
    B, L = z.shape
    if L != block_len or n.shape != (B,):
        raise ValueError("rice_totals: expects z [B, block_len], n [B]")
    out = torch.empty((B, k_max + 1), dtype=torch.int32, device=z.device)
    if B:
        _build.launch(
            "dct_rice_totals", z,
            z.data_ptr(), n.data_ptr(), out.data_ptr(), B, L, k_max,
        )
        rice_totals.launches += 1
    return out


rice_totals.launches = 0


def _candidate_plain(x, history, n, pred, coeffs, block_len, k_max):
    return rice_totals_plain(
        rice.zigzag(residuals_for_candidate(x, history, pred, coeffs)),
        n, block_len, k_max,
    )


def rice_totals_xbp_plain(x, history, n, block_len: int, k_max: int):
    """Plain twin of K6's DELTA + DOUBLE_DELTA form: [2, B, k_max+1] int32."""
    return torch.stack([
        _candidate_plain(x, history, n, pred, None, block_len, k_max)
        for pred in (DELTA, DOUBLE_DELTA)
    ])


def rice_totals_xbp(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    block_len: int,
    k_max: int,
) -> torch.Tensor:
    """K6, DELTA + DOUBLE_DELTA form: exact RICE coded bits
    [2, B, k_max+1] int32 from one read of x, candidate axis order (DELTA,
    DOUBLE_DELTA)."""
    _check_args(block_len, k_max)
    if x.device.type == "cpu":
        return rice_totals_xbp_plain(x, history, n, block_len, k_max)
    if x.device.type != "cuda":
        raise ValueError(f"rice_totals_xbp: unsupported device {x.device}")
    n = check_x("rice_totals_xbp", x, history, n, block_len)
    B, L = x.shape
    out = torch.empty((B, 2, k_max + 1), dtype=torch.int32, device=x.device)
    if B:
        _build.launch(
            "dct_rice_totals_xbp", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), out.data_ptr(),
            B, L, k_max,
        )
        rice_totals_xbp.launches += 1
    return out.permute(1, 0, 2)


rice_totals_xbp.launches = 0


def rice_totals_lpc_plain(x, history, n, coeffs, block_len: int, k_max: int):
    """Plain twin of K6's LPC form: [B, k_max+1] int32."""
    return _candidate_plain(x, history, n, LPC, coeffs, block_len, k_max)


def rice_totals_lpc(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    coeffs,                 # four int32 Q16 coefficients of one LPC table
    block_len: int,
    k_max: int,
) -> torch.Tensor:
    """K6, LPC form: exact RICE coded bits [B, k_max+1] int32 of one LPC
    candidate, its residuals derived from x in the kernel (wrapping int64
    accumulator, arithmetic >> 16, as ``predict.residuals_for_candidate``).
    Raises ValueError for a coefficient outside int32, the frame's type."""
    _check_args(block_len, k_max)
    coeffs = lpc_coeffs(coeffs)
    if x.device.type == "cpu":
        return rice_totals_lpc_plain(x, history, n, coeffs, block_len, k_max)
    if x.device.type != "cuda":
        raise ValueError(f"rice_totals_lpc: unsupported device {x.device}")
    n = check_x("rice_totals_lpc", x, history, n, block_len)
    B, L = x.shape
    out = torch.empty((B, k_max + 1), dtype=torch.int32, device=x.device)
    if B:
        _build.launch(
            "dct_rice_totals_lpc", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), out.data_ptr(),
            B, L, k_max, *coeffs,
        )
        rice_totals_lpc.launches += 1
    return out


rice_totals_lpc.launches = 0
