"""K9: the bit planes of [R, 128] u32 rows, in disk order.

The counterpart of ``dctpu/kernels/transpose_pallas.py``
(``grouped_bit_transpose32``). Each 32-word group w of a row is a 32x32 bit
matrix; :func:`bit_planes32` writes its plane p at word ``p*4 + w``, bit c
being bit p of word ``32w + c``: the plane order of the VERTICAL payload,
which the staged VERTICAL emission (``codec/encode.py``) takes as it is.
Its plain twin, ``vertical.bit_planes32_plain``, is
``vertical_xla.encode_vertical``'s ``swapaxes(bit_transpose32(zg), 2, 3)``.
The CUDA kernel is in ``dctpu_torch/csrc/transpose.cu``.

The TPU kernel gave the groups lane-reversed (a Mosaic limit):
:func:`grouped_bit_transpose32_plain` keeps that contract, the bridge to
the reference's ``grouped_bit_transpose32`` in the tests:
``rev(grouped(rev(x)))`` is the per-group transpose.

``bit_planes32`` runs the plain twin for tensors on the CPU and launches
the kernel for tensors on a CUDA device; ``bit_planes32.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import to_i32
from dctpu_torch.constants import SUB_BLOCK
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.vertical import bit_planes32_plain, bit_transpose32


def grouped_bit_transpose32_plain(rows: torch.Tensor) -> torch.Tensor:
    """The reference's lane-reversed contract: [R, 128] -> [R, 128] int32,
    rev . bit_transpose32 . rev per 32-word group."""
    g = rows.reshape(-1, SUB_BLOCK // 32, 32).flip(-1)
    return to_i32(bit_transpose32(g).flip(-1).reshape(rows.shape))


def bit_planes32(rows: torch.Tensor) -> torch.Tensor:
    """K9 on rows [R, 128] int32 bit patterns -> [R, 128] int32: output word
    p*4 + w has bit c = bit p of input word 32w + c."""
    if rows.device.type == "cpu":
        return bit_planes32_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"bit_planes32: unsupported device {rows.device}")
    _build.check_tensors("bit_planes32", rows)
    if rows.dim() != 2 or rows.shape[1] != SUB_BLOCK:
        raise ValueError("bit_planes32: expects rows [R, 128]")
    out = torch.empty_like(rows)
    if rows.shape[0]:
        err = _build.library().dct_bit_planes32(
            rows.data_ptr(), out.data_ptr(), rows.shape[0],
            _build.stream_of(rows),
        )
        _build.check(err, "dct_bit_planes32")
        bit_planes32.launches += 1
    return out


bit_planes32.launches = 0
