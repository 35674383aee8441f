"""K4: VERTICAL decode of the frame's compact words.

The counterpart of ``dctpu/kernels/vdec_pallas.py`` (``decode_vertical_mega``).
The CUDA kernel (``dctpu_torch/csrc/vdec.cu``) reads each block's words
where they lie in the frame's payload, ``words[start_i : start_i +
count_i]``, and finds each sub-block's words by a scan of the live word
counts its sync entries give. It un-transposes the planes below b, reads
the exception values raw or un-planes them, and patches the <= 16
positions. Unlike the TPU kernel it also covers ``block_len % 128 != 0``.

The plain row twin :func:`decode_vertical_plain` takes the staged-row
contract of ``decode_vertical_mega``: rows ``[sync words | one REGION_PAD
slot per sub-block]``, each slot holding the sub's live disk words then
zeros (``kernels/vertical.py``). :func:`decode_vertical_words_plain` stages
the rows with ``ragged.stage_vertical`` and runs it.

``decode_vertical_words`` runs that twin for tensors on the CPU and
launches the kernel for tensors on a CUDA device;
``decode_vertical_words.launches`` counts the kernel launches. Both raise
ValueError for a block whose sync table does not describe its words.

K4's slot form, :func:`decode_vertical_slots` (``dct_vdec_slots``), reads
those staged rows themselves, the payload rows of the reference's
``encode_vertical`` that its ``decode_blocks`` takes: each sub-block's
words at the start of its slot. Its twin is :func:`decode_vertical_plain`
after the checks of :func:`check_slot_rows`.
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
from dctpu_torch.kernels import _build, ragged
from dctpu_torch.kernels.vertical import (
    POS_REGION,
    REGION_PAD,
    bit_transpose32,
    parse_sync,
    plane_word_counts,
)
from dctpu_torch.trace import span


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


def decode_vertical_words_plain(
    words: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
    n: torch.Tensor, block_len: int,
) -> torch.Tensor:
    """Plain twin of K4: the blocks staged into rows, then
    :func:`decode_vertical_plain`."""
    rows = ragged.stage_vertical(words, start, count, block_len)
    return decode_vertical_plain(rows, n, block_len)


def launch_vdec_words(
    words: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
    n: torch.Tensor, block_len: int,
):
    """K4's launch on CUDA tensors -> (z, bad): bad [B] int32 is 1 where a
    block's sync table does not describe its words, whose z is then not
    written. :func:`decode_vertical_words` reads the flags at once; a
    caller that launches on several devices reads them later with
    :func:`raise_if_bad`."""
    if words.device.type != "cuda":
        raise ValueError(
            f"decode_vertical_words: unsupported device {words.device}"
        )
    start, count, n = _build.block_args(
        "decode_vertical_words", words, start, count, n
    )
    B = start.numel()
    if words.dim() != 1 or count.shape != (B,) or n.shape != (B,):
        raise ValueError(
            "decode_vertical_words: expects words [W], start, count and n [B]"
        )
    z = torch.empty((B, block_len), dtype=torch.int32, device=words.device)
    bad = torch.empty(B, dtype=torch.int32, device=words.device)
    if B:
        _build.launch(
            "dct_vdec_words", words,
            words.data_ptr(), start.data_ptr(), count.data_ptr(), n.data_ptr(),
            z.data_ptr(), bad.data_ptr(), B, block_len,
        )
        decode_vertical_words.launches += 1
    return z, bad


def decode_vertical_words(
    words: torch.Tensor,  # [W] int32 bit patterns: the frame's payload words
    start: torch.Tensor,  # [B] first word of each block
    count: torch.Tensor,  # [B] words of each block, start + count <= W
    n: torch.Tensor,      # [B] valid samples
    block_len: int,
) -> torch.Tensor:
    """K4: z [B, block_len] zigzag values as int32 bit patterns (zeros past
    n) -- the contract of :func:`decode_vertical_words_plain`. One host read
    of the kernel's per-block flags raises the twin's ValueError."""
    if words.device.type == "cpu":
        return decode_vertical_words_plain(words, start, count, n, block_len)
    z, bad = launch_vdec_words(words, start, count, n, block_len)
    raise_if_bad(bad)
    return z


def raise_if_bad(bad) -> None:
    """One host read of :func:`launch_vdec_words`' flags (None: nothing to
    read) -> the twin's ValueError if a block's sync table was bad."""
    if bad is None:
        return
    with span("sync.flags"):
        is_bad = bool(bad.any())
    if is_bad:
        raise ValueError(ragged.BAD_VERTICAL_TABLE)


decode_vertical_words.launches = 0


BAD_MAX_PLANES = "a VERTICAL sub-block's width exceeds max_planes"


def check_slot_rows(payload: torch.Tensor, block_len: int, max_planes: int) -> None:
    """The rows that K4's slot form decodes: at least SW + S * REGION_PAD
    words wide, every sync entry well formed (its live words then fit the
    slot) and no width above max_planes; raises ValueError otherwise."""
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    if payload.dim() != 2 or payload.shape[1] < SW + S * REGION_PAD:
        raise ValueError(
            f"decode_vertical_slots: expects rows [B, >= {SW + S * REGION_PAD}]"
        )
    b, n_exc, _, _ = parse_sync(payload[:, :SW], S)
    if bool(((b > 32) | (n_exc > EXC_CAP)).any()):
        raise ValueError(ragged.BAD_VERTICAL_TABLE)
    if bool((b > max_planes).any()):
        raise ValueError(BAD_MAX_PLANES)


def decode_vertical_slots_plain(
    payload: torch.Tensor, n: torch.Tensor, block_len: int, max_planes: int = 32
) -> torch.Tensor:
    """Plain twin of K4's slot form: :func:`check_slot_rows`, then
    :func:`decode_vertical_plain` on the rows' first SW + S * REGION_PAD
    words."""
    check_slot_rows(payload, block_len, max_planes)
    width = sync_words(block_len) + subs_per_block(block_len) * REGION_PAD
    return decode_vertical_plain(payload[:, :width], n, block_len)


def launch_vdec_slots(payload: torch.Tensor, n: torch.Tensor, block_len: int,
                      max_planes: int = 32):
    """K4's slot form on CUDA tensors -> (z, bad): bad [B] int32 is 1 where
    a row's sync table is malformed, 2 where a width exceeds max_planes;
    such a row's z is not written. Read the flags with
    :func:`raise_if_bad_slots`."""
    if payload.device.type != "cuda":
        raise ValueError(
            f"decode_vertical_slots: unsupported device {payload.device}"
        )
    n = n.to(torch.int32).contiguous()
    payload = payload.contiguous()
    _build.check_tensors("decode_vertical_slots", payload, n)
    S = subs_per_block(block_len)
    B = n.numel()
    if (payload.dim() != 2 or payload.shape[0] != B
            or payload.shape[1] < sync_words(block_len) + S * REGION_PAD):
        raise ValueError(
            "decode_vertical_slots: expects rows [B, >= SW + S * REGION_PAD] "
            "and n [B]"
        )
    z = torch.empty((B, block_len), dtype=torch.int32, device=payload.device)
    bad = torch.empty(B, dtype=torch.int32, device=payload.device)
    if B:
        _build.launch(
            "dct_vdec_slots", payload,
            payload.data_ptr(), n.data_ptr(), z.data_ptr(), bad.data_ptr(), B,
            block_len, payload.shape[1], max_planes,
        )
        decode_vertical_slots.launches += 1
    return z, bad


def raise_if_bad_slots(bad) -> None:
    """One host read of :func:`launch_vdec_slots`' flags -> the twin's
    ValueError for a flagged row."""
    with span("sync.flags"):
        flags = bad.cpu()
    if bool((flags == 1).any()):
        raise ValueError(ragged.BAD_VERTICAL_TABLE)
    if bool(flags.any()):
        raise ValueError(BAD_MAX_PLANES)


def decode_vertical_slots(
    payload: torch.Tensor,  # [B, >= SW + S*REGION_PAD] int32 bit patterns
    n: torch.Tensor,        # [B] valid samples
    block_len: int,
    max_planes: int = 32,
) -> torch.Tensor:
    """K4, slot form: z [B, block_len] zigzag values as int32 bit patterns
    (zeros past n) -- the contract of :func:`decode_vertical_slots_plain`,
    whose ValueErrors one host read of the kernel's flags raises."""
    if payload.device.type == "cpu":
        return decode_vertical_slots_plain(payload, n, block_len, max_planes)
    z, bad = launch_vdec_slots(payload, n, block_len, max_planes)
    raise_if_bad_slots(bad)
    return z


decode_vertical_slots.launches = 0
