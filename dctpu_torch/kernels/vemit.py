"""K3: VERTICAL emit analysis per 128-sample sub-block row.

The counterpart of ``dctpu/kernels/vemit_pallas.py`` (``vertical_emit_mega``):
the bit-plane transpose in disk bit order, the width b by the FORMAT §2.2
min key (smallest b on ties), and the exceptions (at most EXC_CAP = 16)
compacted in ascending position order. The b-dependent region assembly
that follows is plain torch (``kernels/vertical.assemble_rows``), as it was
XLA on the TPU. The CUDA kernel is in ``dctpu_torch/csrc/vemit.cu``.

``vertical_emit`` runs the plain torch twin for tensors on the CPU and
launches the kernel for tensors on a CUDA device; ``vertical_emit.launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import to_i32
from dctpu_torch.constants import EXC_CAP, SUB_BLOCK, subs_per_block
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.vertical import (
    bit_transpose32,
    exceed_counts,
    plane_word_counts,
    select_width,
    sub_rows,
)


def _pack_positions(cpos: torch.Tensor) -> torch.Tensor:
    """[R, 16] positions (0 past n_exc) -> [R, 4] words, 4 u8 per word."""
    sh = torch.tensor([0, 8, 16, 24], device=cpos.device)
    return (cpos.to(torch.int64).reshape(-1, 4, 4) << sh).sum(-1)


def vertical_emit_plain(z: torch.Tensor, n: torch.Tensor, block_len: int):
    """Plain twin of K3; returns the 7 outputs of :func:`vertical_emit`."""
    B = z.shape[0]
    S = subs_per_block(block_len)
    rows = sub_rows(z, n, block_len)  # [R, 128] int64
    R = rows.shape[0]
    pw = plane_word_counts(block_len, z.device).repeat(B)
    b, words, n_exc, e = select_width(exceed_counts(rows), pw)

    # plane (p, w) bit c = bit p of sample 32w + c; stored p-major (p*4 + w)
    planes = bit_transpose32(rows.reshape(R, 4, 32)).transpose(1, 2)

    # exceptions: high bits at width b, placed at their rank
    high = torch.where(
        b[:, None] >= 32, 0, rows >> torch.clamp(b, max=31)[:, None]
    )
    is_exc = high != 0
    rank = torch.cumsum(is_exc, dim=1) - 1
    slot = torch.where(is_exc & (rank < EXC_CAP), rank, EXC_CAP)
    cval = torch.zeros((R, EXC_CAP + 1), dtype=torch.int64, device=z.device)
    cval.scatter_(1, slot, torch.where(is_exc, high, 0))
    lane = torch.arange(SUB_BLOCK, device=z.device).expand(R, SUB_BLOCK)
    cpos = torch.zeros((R, EXC_CAP + 1), dtype=torch.int64, device=z.device)
    cpos.scatter_(1, slot, torch.where(is_exc, lane, 0))
    sh = (B, S)
    return (
        to_i32(planes.reshape(sh + (4 * 32,))),
        *(t.to(torch.int32).reshape(sh) for t in (b, words, n_exc, e)),
        to_i32(_pack_positions(cpos[:, :EXC_CAP])).reshape(sh + (4,)),
        to_i32(cval[:, :EXC_CAP]).reshape(sh + (EXC_CAP,)),
    )


def vertical_emit(z: torch.Tensor, n: torch.Tensor, block_len: int):
    """K3 on z [B, L] int32 zigzag bit patterns (garbage past n), n [B].

    Returns (plane_region [B, S, 128] p-major, best_b, best_words,
    best_exc, best_e [B, S], pos_words [B, S, 4], vals [B, S, 16]), u32
    words as int32 bit patterns — the outputs of the reference's
    vertical_emit_mega."""
    if z.device.type == "cpu":
        return vertical_emit_plain(z, n, block_len)
    if z.device.type != "cuda":
        raise ValueError(f"vertical_emit: unsupported device {z.device}")
    n = n.to(torch.int32).contiguous()
    B, L = z.shape
    _build.check_tensors("vertical_emit", z, n)
    if L != block_len or n.shape != (B,):
        raise ValueError("vertical_emit: expects z [B, block_len], n [B]")
    S = subs_per_block(block_len)
    R = B * S
    kw = dict(dtype=torch.int32, device=z.device)
    planes = torch.empty((R, 4 * 32), **kw)
    meta = torch.empty((R, 4), **kw)
    cval = torch.empty((R, EXC_CAP), **kw)
    cpos = torch.empty((R, EXC_CAP), **kw)
    if R:
        err = _build.library().dct_vemit(
            z.data_ptr(), n.data_ptr(), planes.data_ptr(), meta.data_ptr(),
            cval.data_ptr(), cpos.data_ptr(), B, L, _build.stream_of(z),
        )
        _build.check(err, "dct_vemit")
        vertical_emit.launches += 1
    sh = (B, S)
    return (
        planes.reshape(sh + (4 * 32,)),
        *(meta[:, j].reshape(sh) for j in range(4)),
        to_i32(_pack_positions(cpos)).reshape(sh + (4,)),
        cval.reshape(sh + (EXC_CAP,)),
    )


vertical_emit.launches = 0
