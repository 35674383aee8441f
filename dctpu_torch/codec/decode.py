"""Block-batch decoder: the frame's payload words + headers -> [B, L] samples.

The counterpart of ``dctpu/codec/decode.py``'s decode_blocks, in its two
stages so that each can be timed: ``decode_z`` (VERTICAL blocks through
K4, ``kernels/vdec.py``, at every block length; RICE blocks through K5b,
``kernels/unpack.py``; both read each block's words in place), then
``reconstruct`` (unzigzag and the predictor inverse, through R,
``kernels/reconstruct.py``). Every block decodes on its own (FORMAT §2.1).
"""

from __future__ import annotations

import torch

from dctpu_torch.kernels import reconstruct as recon
from dctpu_torch.kernels.unpack import rice_unpack_words
from dctpu_torch.kernels.vdec import decode_vertical_words


def decode_z(words, start, count, k, n, block_len: int, coder: str) -> torch.Tensor:
    """The blocks at words[start_i : start_i + count_i] -> zigzag values
    [B, block_len] int32 bit patterns. One launch of K4 or K5b per call on
    a card."""
    if coder == "vertical":
        return decode_vertical_words(words, start, count, n, block_len)
    return rice_unpack_words(words, start, count, k, n, block_len)


def reconstruct(z, n, predictor, table_idx, history, table_coeffs) -> torch.Tensor:
    """Zigzag values -> samples [B, L] int32, zeros past n; table_coeffs
    [T, 4] int32. One launch of R per call on a card."""
    return recon.reconstruct(z, n, predictor, table_idx, history, table_coeffs)
