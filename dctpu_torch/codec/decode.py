"""Block-batch decoder: staged payload rows + headers -> [B, L] samples.

The counterpart of ``dctpu/codec/decode.py``'s decode_blocks, in its two
stages so that each can be timed: ``decode_z`` (VERTICAL rows through K4,
``kernels/vdec.py``, at every block length; RICE rows through K5b,
``kernels/unpack.py``), then ``reconstruct`` (unzigzag and the predictor
inverse). Every block decodes on its own (FORMAT §2.1).
"""

from __future__ import annotations

import torch

from dctpu_torch.codec import predict, rice
from dctpu_torch.kernels.unpack import rice_unpack
from dctpu_torch.kernels.vdec import decode_vertical


def decode_z(payload, k, n, block_len: int, coder: str) -> torch.Tensor:
    """Staged rows -> zigzag values [B, block_len] int32 bit patterns."""
    if coder == "vertical":
        return decode_vertical(payload, n, block_len)
    return rice_unpack(payload, k, n, block_len)


def reconstruct(z, n, predictor, table_idx, history, table_coeffs) -> torch.Tensor:
    """Zigzag values -> samples [B, L] int32, zeros past n."""
    x = predict.reconstruct_all(
        rice.unzigzag(z), history, predictor, table_coeffs, table_idx
    )
    L = x.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] < n.to(torch.int64)[:, None]
    return torch.where(valid, x, 0)
