"""Block-batch decoder: the frame's payload words + headers -> [B, L] samples.

The counterpart of ``dctpu/codec/decode.py``'s decode_blocks, in its two
stages so that each can be timed: ``decode_z`` (VERTICAL blocks through
K4, ``kernels/vdec.py``, at every block length; RICE blocks through K5b,
``kernels/rice_unpack.py``; both read each block's words in place), then
``reconstruct`` (unzigzag and the predictor inverse, through R,
``kernels/reconstruct.py``, once for all of a range's coder groups). Every
block decodes on its own (FORMAT §2.1).

:func:`decode_blocks` is the reference's decode_blocks itself, on payload
rows (those of ``encode.encode_blocks``): RICE rows through K5b, read in
place (``kernels/api.unpack``), VERTICAL rows through K4's slot form, then
one R. ``decode_blocks_body`` is its reference name.
"""

from __future__ import annotations

import torch

from dctpu_torch.constants import DOUBLE_DELTA, LPC
from dctpu_torch.kernels import api as kernels
from dctpu_torch.kernels import reconstruct as recon
from dctpu_torch.kernels import vdec
from dctpu_torch.kernels.args import lpc_coeffs
from dctpu_torch.kernels.rice_unpack import rice_unpack_words
from dctpu_torch.kernels.vdec import decode_vertical_words_plain, launch_vdec_words


def decode_z(words, start, count, k, n, block_len: int, coder: str):
    """The blocks at words[start_i : start_i + count_i] -> (zigzag values
    [B, block_len] int32 bit patterns, bad). One launch of K4 or K5b per
    call on a card.

    bad is K4's per-block flags on a card, left unread so that the caller
    can launch other devices' work before its first host read; the caller
    checks them with ``vdec.raise_if_bad``. It is None where the decode
    checked its blocks itself (RICE, and the CPU twin, which raises)."""
    if coder != "vertical":
        return rice_unpack_words(words, start, count, k, n, block_len), None
    if words.device.type == "cpu":
        return decode_vertical_words_plain(words, start, count, n, block_len), None
    return launch_vdec_words(words, start, count, n, block_len)


def reconstruct(zs, src, n, predictor, table_idx, history, table_coeffs,
                out_off=None, out_len=None) -> torch.Tensor:
    """A decode range's coder groups' zigzag values (zs: one or two [Bg, L]
    tensors) -> the range's samples [B, L] int32 in block order, zeros past
    n, or with out_off [B] int64 and out_len, R's flat form: [out_len], block
    b's n valid samples at out_off[b]; block b's row is zs[0][src[b]] for
    src[b] >= 0 and zs[1][-1 - src[b]] for src[b] < 0; table_coeffs [T, 4]
    int32. One launch of R per call on a card."""
    return recon.reconstruct(zs[0], n, predictor, table_idx, history,
                             table_coeffs, src=src,
                             z1=zs[1] if len(zs) > 1 else None,
                             out_off=out_off, out_len=out_len)


def table_coeffs_i32(table_coeffs, device) -> torch.Tensor:
    """[T, 4] Q16 coefficients -> int32 on device, [[0, 0, 0, 0]] for no
    table; ValueError for a coefficient outside int32, the frame's type."""
    rows = torch.as_tensor(table_coeffs).to("cpu", torch.int64).reshape(-1, 4)
    rows = [lpc_coeffs(r) for r in rows.tolist()] or [(0, 0, 0, 0)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def launch_decode_blocks(payload, k, n, predictor, table_idx, history,
                         coeffs, block_len: int, has_lpc: bool,
                         backend: str | None = "xla", coder: str = "rice",
                         max_planes: int = 32, buf_words: int = 0):
    """:func:`decode_blocks` with coeffs from :func:`table_coeffs_i32` ->
    (x, bad): bad is K4's slot flags, left unread for
    ``vdec.raise_if_bad_slots`` so that a caller can launch other devices'
    work first, or None where nothing is left to check."""
    dev = payload.device
    n, k, predictor, table_idx, history = (
        torch.as_tensor(t).to(dev, torch.int32).contiguous()
        for t in (n, k, predictor, table_idx, history)
    )
    bad = None
    if coder == "vertical":
        if dev.type == "cpu":
            z = vdec.decode_vertical_slots_plain(payload, n, block_len, max_planes)
        else:
            z, bad = vdec.launch_vdec_slots(payload, n, block_len, max_planes)
    else:
        z = kernels.unpack(payload, k, n, block_len, backend, buf_words)
    if not has_lpc:  # the reference's inverse then takes LPC blocks as DOUBLE_DELTA
        predictor = torch.where(predictor == LPC, DOUBLE_DELTA, predictor)
    return recon.reconstruct(z, n, predictor, table_idx, history, coeffs), bad


def decode_blocks(
    payload: torch.Tensor,  # [B, Wp] int32 bit patterns: payload rows
    k: torch.Tensor,        # [B]
    n: torch.Tensor,        # [B]
    predictor: torch.Tensor,  # [B]
    table_idx: torch.Tensor,  # [B]
    history: torch.Tensor,    # [B, 4]
    table_coeffs,             # [T, 4] Q16 coefficients (any integer type)
    block_len: int,
    has_lpc: bool,
    backend: str | None = "xla",
    coder: str = "rice",
    max_planes: int = 32,
    buf_words: int = 0,
) -> torch.Tensor:
    """Payload rows of one coder -> x [B, block_len] int32, zeros past n:
    the reference's decode_blocks. One launch of K5b (RICE) or K4's slot
    form (VERTICAL), then one of R in its [B, L] form (src = arange(B)), on
    a card; the plain twins on the CPU.

    The rows are those of the reference's ``backend="xla"`` contract under
    every name: RICE, the pack rows followed by at least 2 zero words
    (``kernels/api.unpack``); VERTICAL, [B, >= SW + S * 192], each
    sub-block's live words at the start of its 192-word slot, zeros after.
    The reference's ``"auto"``/``"scan"`` RICE rows (``stage_rice_scan``) are
    a TPU staging layout that the port does not have. As there, a RICE
    call raises ValueError for a backend name ``kernels/api.unpack`` does
    not know. ``max_planes`` is the reference's static bound on a
    sub-block's width: a wider one, whose output lies outside the
    reference's contract, raises ValueError, as does a malformed sync
    table. ``buf_words`` is a TPU bound, accepted and unused. With
    ``has_lpc`` false, LPC blocks decode as DOUBLE_DELTA, as in the
    reference."""
    x, bad = launch_decode_blocks(
        payload, k, n, predictor, table_idx, history,
        table_coeffs_i32(table_coeffs, payload.device), block_len, has_lpc,
        backend, coder, max_planes, buf_words,
    )
    if bad is not None:
        vdec.raise_if_bad_slots(bad)
    return x


decode_blocks_body = decode_blocks  # the reference's name
