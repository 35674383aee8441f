"""Block-batch decoder: staged payload rows + headers -> [B, L] samples.

The counterpart of ``dctpu/codec/decode.py``'s decode_blocks, in its two
stages so that each can be timed: ``decode_z`` (VERTICAL rows through K4,
``kernels/vdec.py``, at every block length; RICE rows through K5b,
``kernels/unpack.py``), then ``reconstruct`` (unzigzag and the predictor
inverse, through R, ``kernels/reconstruct.py``). Every block decodes on its
own (FORMAT §2.1).
"""

from __future__ import annotations

import torch

from dctpu_torch.kernels import reconstruct as recon
from dctpu_torch.kernels.unpack import rice_unpack
from dctpu_torch.kernels.vdec import decode_vertical


def decode_z(payload, k, n, block_len: int, coder: str) -> torch.Tensor:
    """Staged rows -> zigzag values [B, block_len] int32 bit patterns."""
    if coder == "vertical":
        return decode_vertical(payload, n, block_len)
    return rice_unpack(payload, k, n, block_len)


def reconstruct(z, n, predictor, table_idx, history, table_coeffs) -> torch.Tensor:
    """Zigzag values -> samples [B, L] int32, zeros past n; table_coeffs
    [T, 4] int32. One launch of R per call on a card."""
    return recon.reconstruct(z, n, predictor, table_idx, history, table_coeffs)
