"""K3: VERTICAL emission, straight into the staged payload rows.

The counterpart of ``dctpu/kernels/vemit_pallas.py`` (``vertical_emit_mega``)
plus the region assembly of ``dctpu/kernels/vertical_xla.py``
``encode_vertical`` that followed it on the TPU. The CUDA kernel
(``dctpu_torch/csrc/vemit.cu``) writes the payload rows and bit lengths of
``encode.emit_blocks(..., coder="vertical")`` in one launch per coder
group, in two forms:

  * :func:`vertical_emit_rows`, the x form: it derives each block's chosen
    candidate's residuals from the raw samples, as the selection kernels
    do; the default VERTICAL emission runs it;
  * :func:`vertical_emit_rows_z`, the z form, on zigzag values: the
    reference's ``encode_vertical(z, n, L)`` signature.

:func:`vertical_emit` is the per-sub-block analysis of the reference's
``vertical_emit_mega`` (planes, width, exceptions) in plain torch; with
``kernels/vertical.assemble_rows`` after it, it is both forms' twin.

Each wrapper runs its plain torch twin for tensors on the CPU and launches
the kernel for tensors on a CUDA device; its ``launches`` attribute counts
the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import to_i32
from dctpu_torch.codec import predict, rice
from dctpu_torch.constants import EXC_CAP, SUB_BLOCK, subs_per_block
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.args import candidate_table, check_x, rows_out
from dctpu_torch.kernels.vertical import (
    assemble_rows,
    bit_planes32_plain,
    exceed_counts,
    padded_words_vertical,
    plane_word_counts,
    select_width,
    sub_rows,
)


def _pack_positions(cpos: torch.Tensor) -> torch.Tensor:
    """[R, 16] positions (0 past n_exc) -> [R, 4] words, 4 u8 per word."""
    sh = torch.tensor([0, 8, 16, 24], device=cpos.device)
    return (cpos.to(torch.int64).reshape(-1, 4, 4) << sh).sum(-1)


def vertical_emit(z: torch.Tensor, n: torch.Tensor, block_len: int):
    """The reference's vertical_emit_mega in plain torch, on z [B, L] int32
    zigzag bit patterns (garbage past n), n [B].

    Returns (plane_region [B, S, 128] p-major, best_b, best_words,
    best_exc, best_e [B, S], pos_words [B, S, 4], vals [B, S, 16]), u32
    words as int32 bit patterns: the bit planes in disk bit order, the
    width b by the FORMAT §2.2 min key (smallest b on ties), and the
    exceptions (at most EXC_CAP = 16) compacted in ascending position
    order."""
    B = z.shape[0]
    S = subs_per_block(block_len)
    rows = sub_rows(z, n, block_len)  # [R, 128] int64
    R = rows.shape[0]
    pw = plane_word_counts(block_len, z.device).repeat(B)
    b, words, n_exc, e = select_width(exceed_counts(rows), pw)

    # plane (p, w) bit c = bit p of sample 32w + c; stored p-major (p*4 + w)
    planes = bit_planes32_plain(rows)

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
        planes.reshape(sh + (4 * 32,)),
        *(t.to(torch.int32).reshape(sh) for t in (b, words, n_exc, e)),
        to_i32(_pack_positions(cpos[:, :EXC_CAP])).reshape(sh + (4,)),
        to_i32(cval[:, :EXC_CAP]).reshape(sh + (EXC_CAP,)),
    )


def vertical_emit_rows_z_plain(z: torch.Tensor, n: torch.Tensor, block_len: int):
    """Plain twin of K3's z form: :func:`vertical_emit`, then the region
    assembly."""
    planes, b, words, n_exc, e, pos_words, vals = vertical_emit(z, n, block_len)
    payload = assemble_rows(planes, b, n_exc, e, pos_words, vals, block_len)
    return payload, 32 * words.to(torch.int64).sum(1)


def vertical_emit_rows_z(z: torch.Tensor, n: torch.Tensor, block_len: int):
    """K3, z form: z [B, block_len] int32 zigzag bit patterns (garbage past
    n), n [B] -> (payload [B, SW + S*REGION_PAD] int32 bit patterns,
    bit_len [B] int64)."""
    if z.device.type == "cpu":
        return vertical_emit_rows_z_plain(z, n, block_len)
    if z.device.type != "cuda":
        raise ValueError(f"vertical_emit_rows_z: unsupported device {z.device}")
    n = n.to(torch.int32).contiguous()
    _build.check_tensors("vertical_emit_rows_z", z, n)
    B, L = z.shape
    if L != block_len or n.shape != (B,):
        raise ValueError("vertical_emit_rows_z: expects z [B, block_len], n [B]")
    payload, bit_len = rows_out(B, L, padded_words_vertical(L), z.device)
    if B:
        _build.launch(
            "dct_vemit_rows_z", z,
            z.data_ptr(), n.data_ptr(), payload.data_ptr(), bit_len.data_ptr(),
            B, L,
        )
        vertical_emit_rows_z.launches += 1
    return payload, bit_len


vertical_emit_rows_z.launches = 0


def vertical_emit_rows_plain(x, history, n, choice, cfg):
    """Plain twin of K3's x form: each block's chosen candidate's zigzag
    residuals, then the z form's twin."""
    r = predict.chosen_residuals(x, history, choice, predict.candidate_coeffs(cfg))
    return vertical_emit_rows_z_plain(rice.zigzag(r), n, x.shape[1])


def vertical_emit_rows(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    choice: torch.Tensor,   # [B] index into cfg.candidates()
    cfg,                    # the CodecConfig whose candidates choice indexes
):
    """K3, x form: the VERTICAL payload rows of each block's chosen
    candidate, its residuals derived from x in the kernel.

    Returns (payload [B, SW + S*REGION_PAD] int32 bit patterns, bit_len [B]
    int64). Raises ValueError for an LPC coefficient outside int32, the
    frame's type."""
    table = candidate_table(cfg, x.device)
    if x.device.type == "cpu":
        return vertical_emit_rows_plain(x, history, n, choice, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"vertical_emit_rows: unsupported device {x.device}")
    n = check_x("vertical_emit_rows", x, history, n, cfg.block_len)
    choice = choice.to(torch.int32).contiguous()
    _build.check_tensors("vertical_emit_rows", x, choice)
    B, L = x.shape
    if choice.shape != (B,):
        raise ValueError("vertical_emit_rows: expects choice [B]")
    payload, bit_len = rows_out(B, L, padded_words_vertical(L), x.device)
    if B:
        _build.launch(
            "dct_vemit_rows", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), choice.data_ptr(),
            table.data_ptr(), table.shape[0], payload.data_ptr(), bit_len.data_ptr(),
            B, L,
        )
        vertical_emit_rows.launches += 1
    return payload, bit_len


vertical_emit_rows.launches = 0
