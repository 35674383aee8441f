"""K7: adaptive-selection totals (FORMAT §4.1), the reduction formulation.

The counterpart of ``dctpu/kernels/select_pallas.py``
``adaptive_totals_pallas``: K2's contract (per block, the exact RICE
coded-bit total for every k in [0, k_max] and the exact VERTICAL word
count), computed per 128-sample sub-block row from the per-k lengths and
the exceed table, then summed per block. The reference keeps it beside K2
as ``adaptive_select(..., backend="reduce")``. The CUDA kernel,
``dct_select_reduce`` in ``dctpu_torch/csrc/select.cu``, launches K2's
bit-length-histogram code (the per-k formulation only cut the TPU's lane
reductions); the plain twin keeps the per-sub-row, per-k formulation, an
arithmetic apart from the kernel's.

``adaptive_totals_reduce`` runs the plain torch twin for tensors on the
CPU and launches the kernel for tensors on a CUDA device;
``adaptive_totals_reduce.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch.constants import MAX_CODE_BITS, SUB_BLOCK, sub_caps, subs_per_block
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.vertical import select_width, sub_rows


def _check_args(block_len: int, k_max: int) -> None:
    # the reference's asserts (select_pallas.py adaptive_totals_pallas)
    if not 0 <= k_max <= 24:
        raise ValueError(f"k_max must be in [0, 24] (k_max + 4 <= 28), got {k_max}")
    if block_len * MAX_CODE_BITS >= 2**26:
        raise ValueError(f"block_len {block_len} too large for the packed key")


def adaptive_totals_reduce_plain(z, n, block_len: int, k_max: int):
    """Plain twin of K7, in its per-sub-row formulation: (totals
    [B, k_max+1] int32, vwords [B] int32)."""
    B = z.shape[0]
    S = subs_per_block(block_len)
    rows = sub_rows(z, n, block_len)  # [B*S, 128] int64, zero past n
    start = torch.arange(S, device=z.device) * SUB_BLOCK
    cnt = torch.clamp(n.to(torch.int64)[:, None] - start, 0, SUB_BLOCK).reshape(-1)
    valid = torch.arange(SUB_BLOCK, device=z.device)[None, :] < cnt[:, None]
    lens = []
    for k in range(k_max + 1):
        ln = torch.where(
            (rows >> (k + 4)) != 0, MAX_CODE_BITS, ((rows >> k) & 15) + k + 1
        )
        lens.append(torch.where(valid, ln, 0).sum(1))
    E = torch.stack([((rows >> b) != 0).sum(1) for b in range(33)], dim=1)
    pw = torch.tensor(
        [(c + 31) // 32 for c in sub_caps(block_len)], device=z.device
    ).repeat(B)
    _, words, _, _ = select_width(E, pw)
    totals = torch.stack(lens, dim=1).reshape(B, S, k_max + 1).sum(1)
    return totals.to(torch.int32), words.reshape(B, S).sum(1).to(torch.int32)


def adaptive_totals_reduce(
    z: torch.Tensor,  # [B, L] int32 zigzag bit patterns (garbage past n)
    n: torch.Tensor,  # [B] valid counts
    block_len: int,
    k_max: int,
):
    """K7: (rice_totals [B, k_max+1] int32, vertical_words [B] int32).
    Raises ValueError where the reference asserts: k_max > 24, or
    block_len * 48 >= 2**26."""
    _check_args(block_len, k_max)
    if z.device.type == "cpu":
        return adaptive_totals_reduce_plain(z, n, block_len, k_max)
    if z.device.type != "cuda":
        raise ValueError(f"adaptive_totals_reduce: unsupported device {z.device}")
    n = n.to(torch.int32).contiguous()
    _build.check_tensors("adaptive_totals_reduce", z, n)
    B, L = z.shape
    if L != block_len or n.shape != (B,):
        raise ValueError("adaptive_totals_reduce: expects z [B, block_len], n [B]")
    out = torch.empty((B, k_max + 2), dtype=torch.int32, device=z.device)
    if B:
        err = _build.library().dct_select_reduce(
            z.data_ptr(), n.data_ptr(), out.data_ptr(), B, L, k_max,
            _build.stream_of(z),
        )
        _build.check(err, "dct_select_reduce")
        adaptive_totals_reduce.launches += 1
    return out[:, : k_max + 1], out[:, k_max + 1]


adaptive_totals_reduce.launches = 0
