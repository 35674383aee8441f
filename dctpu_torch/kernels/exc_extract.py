"""K8: VERTICAL exception extraction at given widths.

The counterpart of ``dctpu/kernels/vertical_pallas.py``
``exc_extract_pallas``: for each 128-sample sub-block row and its width b,
the exceptions (``z >> b != 0``; none for b >= 32) in ascending position
order — the first EXC_CAP = 16 values ``z >> b``, and their positions
packed four u8 per word (``lane << 8*(rank & 3)`` in word ``rank >> 2``).
Ranks of 16 and above are dropped; slots past the count are zero. The
reference runs it in the staged VERTICAL emission under
``backend="pallas"``. The CUDA kernel is in ``dctpu_torch/csrc/exc.cu``.

``exc_extract`` runs the plain torch twin for tensors on the CPU and
launches the kernel for tensors on a CUDA device; ``exc_extract.launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import MASK32, to_i32, to_u32
from dctpu_torch.constants import EXC_CAP, SUB_BLOCK
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.vertical import POS_REGION


def exc_extract_plain(zs: torch.Tensor, best_b: torch.Tensor):
    """Plain twin of K8, the formulation of ``vertical_xla.exc_extract_xla``:
    rank by a prefix sum, then one masked sum per value slot and per
    position word. Returns (pos_words [B, S, 4], vals [B, S, 16]) int32."""
    u = to_u32(zs)
    bb = (best_b.to(torch.int64) & MASK32)[:, :, None]  # u32, as the reference
    high = torch.where(bb >= 32, 0, u >> torch.clamp(bb, max=31))
    is_exc = high != 0
    rank = torch.where(is_exc, torch.cumsum(is_exc, dim=2) - 1, 255)
    vals = torch.stack(
        [torch.where(rank == j, high, 0).sum(2) for j in range(EXC_CAP)], dim=2
    )
    lane = torch.arange(SUB_BLOCK, device=zs.device)
    contrib = torch.where(is_exc, lane << ((rank & 3) << 3), 0)
    pos = torch.stack(
        [torch.where(rank >> 2 == m, contrib, 0).sum(2) for m in range(POS_REGION)],
        dim=2,
    )
    return to_i32(pos), to_i32(vals)


def exc_extract(zs: torch.Tensor, best_b: torch.Tensor):
    """K8 on zs [B, S, 128] int32 bit patterns (zero past each sub-block's
    valid count) and best_b [B, S] widths. Returns (pos_words [B, S, 4],
    vals [B, S, 16]) int32 bit patterns."""
    if zs.device.type == "cpu":
        return exc_extract_plain(zs, best_b)
    if zs.device.type != "cuda":
        raise ValueError(f"exc_extract: unsupported device {zs.device}")
    best_b = best_b.to(torch.int32).contiguous()
    _build.check_tensors("exc_extract", zs, best_b)
    B, S, W = zs.shape
    if W != SUB_BLOCK or best_b.shape != (B, S):
        raise ValueError("exc_extract: expects zs [B, S, 128], best_b [B, S]")
    R = B * S
    pos = torch.empty((B, S, POS_REGION), dtype=torch.int32, device=zs.device)
    vals = torch.empty((B, S, EXC_CAP), dtype=torch.int32, device=zs.device)
    if R:
        _build.launch(
            "dct_exc_extract", zs,
            zs.data_ptr(), best_b.data_ptr(), pos.data_ptr(), vals.data_ptr(),
            R,
        )
        exc_extract.launches += 1
    return pos, vals


exc_extract.launches = 0
