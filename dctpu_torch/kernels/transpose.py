"""K9: grouped 32x32 bit-matrix transpose of [R, 128] u32 rows.

The counterpart of ``dctpu/kernels/transpose_pallas.py``
(``grouped_bit_transpose32``). Each 32-word group of a row is a 32x32 bit
matrix. The kernel keeps the TPU butterfly's lane-reversed order:
``rev(K9(rev(x))) == bit_transpose32(x)``, rev reversing the words of each
group and ``bit_transpose32`` the counterpart of
``vertical_xla.bit_transpose32`` in ``kernels/vertical.py``. That order
differs from the disk order of the plane words K3 writes; the staged
VERTICAL emission (``codec/encode.py``) reverses around it. The CUDA
kernel is in ``dctpu_torch/csrc/transpose.cu``.

``grouped_bit_transpose32`` runs the plain torch twin for tensors on the
CPU and launches the kernel for tensors on a CUDA device;
``grouped_bit_transpose32.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import to_i32
from dctpu_torch.constants import SUB_BLOCK
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.vertical import bit_transpose32


def grouped_bit_transpose32_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain twin of K9: [R, 128] -> [R, 128] int32, rev . bit_transpose32
    . rev per 32-word group."""
    g = rows.reshape(-1, SUB_BLOCK // 32, 32).flip(-1)
    return to_i32(bit_transpose32(g).flip(-1).reshape(rows.shape))


def grouped_bit_transpose32(rows: torch.Tensor) -> torch.Tensor:
    """K9 on rows [R, 128] int32 bit patterns (lane-reversed groups) ->
    [R, 128] int32: output word l of a group has bit c = bit (31 - l) of
    input word 31 - c."""
    if rows.device.type == "cpu":
        return grouped_bit_transpose32_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"grouped_bit_transpose32: unsupported device {rows.device}")
    _build.check_tensors("grouped_bit_transpose32", rows)
    if rows.dim() != 2 or rows.shape[1] != SUB_BLOCK:
        raise ValueError("grouped_bit_transpose32: expects rows [R, 128]")
    out = torch.empty_like(rows)
    if rows.shape[0]:
        err = _build.library().dct_bit_transpose(
            rows.data_ptr(), out.data_ptr(), rows.shape[0], _build.stream_of(rows)
        )
        _build.check(err, "dct_bit_transpose")
        grouped_bit_transpose32.launches += 1
    return out


grouped_bit_transpose32.launches = 0
