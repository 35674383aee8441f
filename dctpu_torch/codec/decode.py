"""Block-batch decoder: the frame's payload words + headers -> [B, L] samples.

The counterpart of ``dctpu/codec/decode.py``'s decode_blocks, in its two
stages so that each can be timed: ``decode_z`` (VERTICAL blocks through
K4, ``kernels/vdec.py``, at every block length; RICE blocks through K5b,
``kernels/unpack.py``; both read each block's words in place), then
``reconstruct`` (unzigzag and the predictor inverse, through R,
``kernels/reconstruct.py``, once for all of a range's coder groups). Every
block decodes on its own (FORMAT §2.1).
"""

from __future__ import annotations

import torch

from dctpu_torch.kernels import reconstruct as recon
from dctpu_torch.kernels.unpack import rice_unpack_words
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


def reconstruct(zs, src, n, predictor, table_idx, history,
                table_coeffs) -> torch.Tensor:
    """A decode range's coder groups' zigzag values (zs: one or two [Bg, L]
    tensors) -> the range's samples [B, L] int32 in block order, zeros past
    n; block b's row is zs[0][src[b]] for src[b] >= 0 and zs[1][-1 - src[b]]
    for src[b] < 0; table_coeffs [T, 4] int32. One launch of R per call on
    a card."""
    return recon.reconstruct(zs[0], n, predictor, table_idx, history,
                             table_coeffs, src=src,
                             z1=zs[1] if len(zs) > 1 else None)
