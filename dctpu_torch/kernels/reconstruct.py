"""R: reconstruction of decoded blocks, zigzag values -> samples.

The tail of the reference's ``decode_blocks_body`` (``dctpu/codec/decode.py``):
unzigzag, the per-block predictor inverse (``dctpu/codec/predict.py``
``reconstruct_all``: prefix sums for DELTA and DOUBLE_DELTA, the LPC
recurrence as an XLA ``lax.scan``) and zeros past n. There was no Pallas
kernel for it on the TPU; on the card it is one CUDA kernel per decode
range, ``dctpu_torch/csrc/recon.cu``, that reads each block's zigzag row
from its coder group's tensor and its predictor itself.

``reconstruct`` runs the plain torch twin for tensors on the CPU and
launches the kernel for tensors on a CUDA device; ``reconstruct.launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch.codec import predict, rice
from dctpu_torch.kernels import _build


def reconstruct_plain(z, n, predictor, table_idx, history, table_coeffs):
    """Plain twin of R's [B, L] form: ``predict.reconstruct_all`` on the
    unzigzagged values, then zeros past n."""
    x = predict.reconstruct_all(
        rice.unzigzag(z), history, predictor, table_coeffs, table_idx
    )
    L = x.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] < n.to(torch.int64)[:, None]
    return torch.where(valid, x, 0)


def gather_rows(z, src, z1=None):
    """[B, L]: row src[b] of z for src[b] >= 0, row -1 - src[b] of z1 for
    src[b] < 0 (a decode range's blocks from its two coder groups)."""
    src = src.to(torch.int64)
    first = src >= 0
    out = torch.empty((src.numel(), z.shape[1]), dtype=z.dtype, device=z.device)
    out[first] = z[src[first]]
    if z1 is not None:
        out[~first] = z1[-1 - src[~first]]
    elif not bool(first.all()):
        raise ValueError("reconstruct: a negative source row without z1")
    return out


def reconstruct_range_plain(z, n, predictor, table_idx, history, table_coeffs,
                            src, z1=None):
    """Plain twin of R's range form: gather each block's row by its source,
    then the [B, L] twin."""
    return reconstruct_plain(gather_rows(z, src, z1), n, predictor, table_idx,
                             history, table_coeffs)


def reconstruct(
    z: torch.Tensor,             # [Bz, L] int32 zigzag bit patterns
    n: torch.Tensor,             # [B] valid counts
    predictor: torch.Tensor,     # [B] predictor ids
    table_idx: torch.Tensor,     # [B] LPC table of each LPC block
    history: torch.Tensor,       # [B, 4] int32 pre-block history
    table_coeffs: torch.Tensor,  # [T, 4] int32 Q16 coefficients, T >= 1
    src: torch.Tensor | None = None,  # [B] int32 source rows (range form)
    z1: torch.Tensor | None = None,   # [Bz1, L] the second group's z
) -> torch.Tensor:
    """R: samples [B, L] int32, zeros past n.

    Block b's zigzag row is z[b] when src is None (the [B, L] form); else
    z[src[b]] for src[b] >= 0 and z1[-1 - src[b]] for src[b] < 0 (the range
    form: one call for a decode range's two coder groups, in block order)."""
    if z.device.type == "cpu":
        if src is None:
            return reconstruct_plain(z, n, predictor, table_idx, history,
                                     table_coeffs)
        return reconstruct_range_plain(z, n, predictor, table_idx, history,
                                       table_coeffs, src, z1)
    if z.device.type != "cuda":
        raise ValueError(f"reconstruct: unsupported device {z.device}")
    n, predictor, table_idx = (
        t.to(torch.int32).contiguous() for t in (n, predictor, table_idx)
    )
    extra = [t for t in (src, z1) if t is not None]
    _build.check_tensors(
        "reconstruct", z, n, predictor, table_idx, history, table_coeffs, *extra
    )
    B = n.shape[0]
    L = z.shape[1]
    T = table_coeffs.shape[0]
    if (z.dim() != 2 or predictor.shape != (B,) or table_idx.shape != (B,)
            or history.shape != (B, 4) or table_coeffs.shape != (T, 4) or T < 1
            or (src is None and (z.shape[0] != B or z1 is not None))
            or (src is not None and src.shape != (B,))
            or (z1 is not None and (z1.dim() != 2 or z1.shape[1] != L))):
        raise ValueError(
            "reconstruct: expects z [B, L] (or z [Bz, L], z1 [Bz1, L] and "
            "src [B]), n, predictor, table_idx [B], history [B, 4], "
            "table_coeffs [T >= 1, 4]"
        )
    x = torch.empty((B, L), dtype=torch.int32, device=z.device)
    if B and L:
        _build.launch(
            "dct_reconstruct", z,
            z.data_ptr(), z1.data_ptr() if z1 is not None else None,
            src.data_ptr() if src is not None else None,
            n.data_ptr(), predictor.data_ptr(), table_idx.data_ptr(),
            history.data_ptr(), table_coeffs.data_ptr(), T, x.data_ptr(), B, L,
        )
        reconstruct.launches += 1
    return x


reconstruct.launches = 0
