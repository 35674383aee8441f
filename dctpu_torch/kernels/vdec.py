"""K4: VERTICAL decode of staged payload rows.

The counterpart of ``dctpu/kernels/vdec_pallas.py`` (``decode_vertical_mega``)
with its staged-row contract: rows ``[sync words | one REGION_PAD slot per
sub-block]``, each slot holding the sub's live disk words then zeros
(``kernels/vertical.py``). It un-transposes the planes below b, reads the
exception values raw or un-planes them, and patches the <= 16 positions.
Unlike the TPU kernel it also covers ``block_len % 128 != 0``. The CUDA
kernel is in ``dctpu_torch/csrc/vdec.cu``.

``decode_vertical`` runs the plain torch twin for tensors on the CPU and
launches the kernel for tensors on a CUDA device;
``decode_vertical.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import to_i32, to_u32
from dctpu_torch.constants import (
    EXC_CAP,
    SUB_BLOCK,
    subs_per_block,
    sync_words,
)
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.vertical import (
    POS_REGION,
    REGION_PAD,
    bit_transpose32,
    padded_words_vertical,
    parse_sync,
    plane_word_counts,
)


def decode_vertical_plain(
    payload: torch.Tensor, n: torch.Tensor, block_len: int
) -> torch.Tensor:
    """Plain twin of K4 (the semantics of vertical_xla.decode_vertical)."""
    B = payload.shape[0]
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    R = B * S
    dev = payload.device
    u = to_u32(payload)
    b, n_exc, e, _ = (t.reshape(R) for t in parse_sync(u[:, :SW], S))
    span = u[:, SW:].reshape(R, REGION_PAD)
    pw = plane_word_counts(block_len, dev).repeat(B)[:, None]

    # plane (p, w) sits at slot p*pw + w; zero for p >= b and w >= pw
    p_ax = torch.arange(32, device=dev)[None, :, None]
    w_ax = torch.arange(4, device=dev)[None, None, :]
    pw3 = pw[:, :, None]
    slot = (p_ax * pw3 + w_ax).clamp(max=REGION_PAD - 1).reshape(R, 128)
    planes = span.gather(1, slot).reshape(R, 32, 4)
    planes = torch.where((w_ax < pw3) & (p_ax < b[:, None, None]), planes, 0)
    # each 32-sample group is the transpose of its [32 planes] words
    z = bit_transpose32(planes.transpose(1, 2)).reshape(R, SUB_BLOCK)

    # tail at word pw*b: [posw position words | value words]
    t0 = pw[:, 0] * b
    posw = (n_exc + 3) // 4
    tidx = (t0[:, None] + torch.arange(20, device=dev)).clamp(max=REGION_PAD - 1)
    tail = span.gather(1, tidx)  # [R, 20]
    pos_words = torch.where(
        torch.arange(POS_REGION, device=dev) < posw[:, None], tail[:, :POS_REGION], 0
    )
    val_words = tail.gather(
        1, (posw[:, None] + torch.arange(EXC_CAP, device=dev)).clamp(max=19)
    )
    # bit-planed layout: plane p = bits [16*(p%2), +16) of word p//2
    vplanes = torch.stack([val_words & 0xFFFF, val_words >> 16], dim=2).reshape(R, 32)
    planed = bit_transpose32(vplanes)[:, :EXC_CAP]
    raw = n_exc <= (e + 1) // 2
    vals = torch.where(raw[:, None], val_words, planed)

    # patch: OR v_j << b into the (distinct) live positions
    j = torch.arange(EXC_CAP, device=dev)
    pos = (pos_words[:, j // 4] >> (8 * (j % 4))) & 0xFF  # [R, 16]
    live = (j < n_exc[:, None]) & (b[:, None] < 32) & (pos < SUB_BLOCK)
    patch = torch.where(
        live, (vals << torch.clamp(b, max=31)[:, None]) & 0xFFFFFFFF, 0
    )
    hit = torch.zeros((R, SUB_BLOCK + 1), dtype=torch.int64, device=dev)
    hit.scatter_add_(1, torch.where(live, pos, SUB_BLOCK), patch)
    z |= hit[:, :SUB_BLOCK]

    z = z.reshape(B, S * SUB_BLOCK)[:, :block_len]
    valid = torch.arange(block_len, device=dev)[None, :] < n.to(torch.int64)[:, None]
    return to_i32(torch.where(valid, z, 0))


def decode_vertical(
    payload: torch.Tensor, n: torch.Tensor, block_len: int
) -> torch.Tensor:
    """K4: staged rows [B, SW + S*REGION_PAD] int32 bit patterns, n [B] ->
    z [B, block_len] int32 bit patterns (zeros past n)."""
    if payload.device.type == "cpu":
        return decode_vertical_plain(payload, n, block_len)
    if payload.device.type != "cuda":
        raise ValueError(f"decode_vertical: unsupported device {payload.device}")
    n = n.to(torch.int32).contiguous()
    B, W = payload.shape
    _build.check_tensors("decode_vertical", payload, n)
    if W != padded_words_vertical(block_len) or n.shape != (B,):
        raise ValueError(
            "decode_vertical: expects payload [B, SW + S*REGION_PAD], n [B]"
        )
    z = torch.empty((B, block_len), dtype=torch.int32, device=payload.device)
    if B:
        err = _build.library().dct_vdec(
            payload.data_ptr(), n.data_ptr(), z.data_ptr(), B, block_len, W,
            _build.stream_of(payload),
        )
        _build.check(err, "dct_vdec")
        decode_vertical.launches += 1
    return z


decode_vertical.launches = 0
