"""K6: exact RICE coded bits per block and k, for the coder="rice" k choice.

The counterpart of ``dctpu/kernels/select_pallas.py`` ``rice_totals_pallas``:
for every block, the exact total of RICE codeword lengths over its valid
samples for each k in [0, k_max] (FORMAT §4). The CUDA kernel is K2's RICE
half (``dctpu_torch/csrc/select.cu``, ``dct_rice_totals``).

``rice_totals`` runs the plain torch twin for tensors on the CPU and
launches the kernel for tensors on a CUDA device; ``rice_totals.launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch.codec import rice
from dctpu_torch.constants import MAX_CODE_BITS
from dctpu_torch.kernels import _build


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
        err = _build.library().dct_rice_totals(
            z.data_ptr(), n.data_ptr(), out.data_ptr(), B, L, k_max,
            _build.stream_of(z),
        )
        _build.check(err, "dct_rice_totals")
        rice_totals.launches += 1
    return out


rice_totals.launches = 0
