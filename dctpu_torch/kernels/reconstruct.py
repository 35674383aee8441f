"""R: reconstruction of decoded blocks, zigzag values -> samples.

The tail of the reference's ``decode_blocks_body`` (``dctpu/codec/decode.py``):
unzigzag, the per-block predictor inverse (``dctpu/codec/predict.py``
``reconstruct_all``: prefix sums for DELTA and DOUBLE_DELTA, the LPC
recurrence as an XLA ``lax.scan``) and zeros past n. There was no Pallas
kernel for it on the TPU; on the card it is one CUDA kernel per coder group,
``dctpu_torch/csrc/recon.cu``, that reads each block's predictor itself.

``reconstruct`` runs the plain torch twin for tensors on the CPU and
launches the kernel for tensors on a CUDA device; ``reconstruct.launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch.codec import predict, rice
from dctpu_torch.kernels import _build


def reconstruct_plain(z, n, predictor, table_idx, history, table_coeffs):
    """Plain twin of R: ``predict.reconstruct_all`` on the unzigzagged
    values, then zeros past n."""
    x = predict.reconstruct_all(
        rice.unzigzag(z), history, predictor, table_coeffs, table_idx
    )
    L = x.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] < n.to(torch.int64)[:, None]
    return torch.where(valid, x, 0)


def reconstruct(
    z: torch.Tensor,             # [B, L] int32 zigzag bit patterns
    n: torch.Tensor,             # [B] valid counts
    predictor: torch.Tensor,     # [B] predictor ids
    table_idx: torch.Tensor,     # [B] LPC table of each LPC block
    history: torch.Tensor,       # [B, 4] int32 pre-block history
    table_coeffs: torch.Tensor,  # [T, 4] int32 Q16 coefficients, T >= 1
) -> torch.Tensor:
    """R: samples [B, L] int32, zeros past n."""
    if z.device.type == "cpu":
        return reconstruct_plain(z, n, predictor, table_idx, history, table_coeffs)
    if z.device.type != "cuda":
        raise ValueError(f"reconstruct: unsupported device {z.device}")
    n, predictor, table_idx = (
        t.to(torch.int32).contiguous() for t in (n, predictor, table_idx)
    )
    _build.check_tensors(
        "reconstruct", z, n, predictor, table_idx, history, table_coeffs
    )
    B, L = z.shape
    T = table_coeffs.shape[0]
    if (n.shape != (B,) or predictor.shape != (B,) or table_idx.shape != (B,)
            or history.shape != (B, 4) or table_coeffs.shape != (T, 4) or T < 1):
        raise ValueError(
            "reconstruct: expects z [B, L], n, predictor, table_idx [B], "
            "history [B, 4], table_coeffs [T >= 1, 4]"
        )
    x = torch.empty((B, L), dtype=torch.int32, device=z.device)
    if B:
        _build.launch(
            "dct_reconstruct", z,
            z.data_ptr(), n.data_ptr(), predictor.data_ptr(), table_idx.data_ptr(),
            history.data_ptr(), table_coeffs.data_ptr(), T, x.data_ptr(), B, L,
        )
        reconstruct.launches += 1
    return x


reconstruct.launches = 0
