"""CP: the encode's compaction, a range's payload rows -> its compact words.

The counterpart of the reference's compaction and interleave: the XLA
``compact_rice_semi`` / ``compact_vertical_semi`` (``dctpu/kernels/ragged.py``),
the host ``squeeze_host`` and the host interleave of the coder groups in
block order, with its word counts and offsets (``dctpu/codec/api.py``). On
the card it is two CUDA kernels per encode range,
``dctpu_torch/csrc/compact.cu``: a count pass that gives each block's word
count, frame offset and source row, then the copy, which reads each
block's payload row from its coder group's rows and writes its disk words
at its frame offset.

Each coder group's payload rows are stacked in block order, the groups in
:data:`CODER_GROUPS` order (the first present group ``rows_a``, the other
``rows_b``); the count pass gives block b its row, ``rows_a[src[b]]`` for
``src[b] >= 0`` and ``rows_b[-1 - src[b]]`` for ``src[b] < 0``, as in R's
range form. A block's word count is the reference's (:func:`word_counts`).
A VERTICAL block whose sync table does not describe its words raises
ValueError, on both devices.

``count_range`` and ``compact_range`` run the plain twins
:func:`count_range_plain` and :func:`compact_range_plain` for tensors on
the CPU and launch the kernels for tensors on a CUDA device;
``count_range.launches`` and ``compact_range.launches`` count the
launches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dctpu_torch.constants import (
    CODER_RICE,
    CODER_VERTICAL,
    SUB_BLOCK,
    sync_words,
)
from dctpu_torch.kernels import _build, ragged
from dctpu_torch.trace import span

MAX_BLOCK_LEN = 512 * SUB_BLOCK  # the copy scans at most 512 sub-blocks
_BAD_TABLE, _BAD_ROW = 1, 2      # the kernel's flag bits
# The order a range's coder groups stack their payload rows in: the first
# group present gives rows_a, the other rows_b. The count pass's src
# follows it (csrc/compact.cu count_range_kernel).
CODER_GROUPS = ((CODER_RICE, "rice"), (CODER_VERTICAL, "vertical"))


def word_counts(coder: torch.Tensor, bit_len: torch.Tensor,
                block_len: int) -> torch.Tensor:
    """Each block's disk words (FORMAT §2.1), [B] int64, as the reference
    counts them: RICE sync_words + ceil(bit_len / 32), VERTICAL
    sync_words + bit_len // 32."""
    bl = bit_len.to(torch.int64)
    SW = sync_words(block_len)
    return torch.where(coder == CODER_VERTICAL, SW + bl // 32, SW + (bl + 31) // 32)


def compact_enc_payload(
    payload: torch.Tensor, bit_len: torch.Tensor, block_len: int, coder: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One coder group's payload rows -> (compact disk words, words per
    block), on the rows' device (the semantics of the reference's
    compact_enc_payload_device)."""
    if coder == "vertical":
        return ragged.compact_vertical(payload, bit_len, block_len)
    return (
        ragged.compact_payload(payload, bit_len, block_len),
        ragged.payload_word_counts(bit_len, block_len),
    )


def count_range_plain(coder, bit_len, block_len):
    """Plain twin of the count pass -> (wc [B] int64, off [B] int64 the
    exclusive scan of wc, src [B] int32 each block's rank in its coder
    group, negative as -1 - rank in the second group, total [1] int64),
    on coder's device."""
    wc = word_counts(coder, bit_len, block_len)
    off = torch.cumsum(wc, 0) - wc
    vertical = coder == CODER_VERTICAL
    v = vertical.to(torch.int64)
    v_rank = torch.cumsum(v, 0) - v
    rank = torch.where(vertical, v_rank,
                       torch.arange(coder.numel(), device=coder.device) - v_rank)
    # the first group: the first of CODER_GROUPS with a block here
    has = {CODER_RICE: bool((~vertical).any()),
           CODER_VERTICAL: bool(vertical.any())}
    first_gid = next((gid for gid, _ in CODER_GROUPS if has[gid]), CODER_RICE)
    first = vertical == (first_gid == CODER_VERTICAL)
    src = torch.where(first, rank, -1 - rank).to(torch.int32)
    total = wc.sum().reshape(1)
    return wc, off, src, total


def count_range(coder: torch.Tensor, bit_len: torch.Tensor,
                block_len: int) -> Tuple[torch.Tensor, ...]:
    """The count pass: :func:`count_range_plain`'s (wc, off, src, total)
    for coder [B] and bit_len [B]. On a card one launch of one CTA."""
    if coder.device.type == "cpu":
        return count_range_plain(coder, bit_len, block_len)
    if coder.device.type != "cuda":
        raise ValueError(f"count_range: unsupported device {coder.device}")
    B = coder.numel()
    coder = coder.to(torch.int32).contiguous()
    bit_len = bit_len.to(torch.int64).contiguous()
    if (coder.shape != (B,) or bit_len.shape != (B,)
            or bit_len.device != coder.device):
        raise ValueError("count_range: expects coder and bit_len [B] on one "
                         "device")
    counts = torch.empty(2 * B + 1, dtype=torch.int64, device=coder.device)
    wc, off, total = counts[:B], counts[B:2 * B], counts[2 * B:]
    src = torch.empty(B, dtype=torch.int32, device=coder.device)
    _build.launch("dct_count_range", coder, coder.data_ptr(),
                  bit_len.data_ptr(), wc.data_ptr(), off.data_ptr(),
                  src.data_ptr(), total.data_ptr(), B, block_len)
    count_range.launches += 1
    return wc, off, src, total


def compact_range_plain(rows_a, rows_b, coder, bit_len, block_len):
    """Plain twin of CP: the blocks of each group and coder compacted with
    :func:`compact_enc_payload`, then scattered to their frame offsets."""
    wc, off, src, total = count_range_plain(coder, bit_len, block_len)
    out = torch.empty(int(total), dtype=torch.int32, device=coder.device)
    src = src.to(torch.int64)
    vertical = coder == CODER_VERTICAL
    for rows, mine, row in ((rows_a, src >= 0, src), (rows_b, src < 0, -1 - src)):
        for gname, of_coder in (("rice", ~vertical), ("vertical", vertical)):
            blocks = torch.nonzero(mine & of_coder)[:, 0]
            if blocks.numel() == 0:
                continue
            r = row[blocks]
            if rows is None or bool((r >= rows.shape[0]).any()):
                raise ValueError(ragged.BAD_PAYLOAD_ROW)
            words, wcg = compact_enc_payload(rows[r], bit_len[blocks],
                                             block_len, gname)
            ragged.copy_segments(out, off[blocks], words,
                                 torch.cumsum(wcg, 0) - wcg, wcg)
    return out, wc


def compact_range_flagged(
    rows_a: torch.Tensor | None,  # [Ba, Wa] int32 the first group's rows
    rows_b: torch.Tensor | None,  # [Bb, Wb] int32 the second group's rows
    coder: torch.Tensor,          # [B] coder ids
    bit_len: torch.Tensor,        # [B] int64
    block_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CP -> (buf [total + 1] int32, wc [B] int64): the range's compact
    words, then a flag word that is non-zero where a block could not be
    compacted. On a card the count pass, one host read (the total, to
    size buf) and the copy; the flag is left unread, for the caller's
    download (:func:`host_words`). On the CPU the twin, which raises
    itself."""
    if coder.device.type == "cpu":
        words, wc = compact_range_plain(rows_a, rows_b, coder, bit_len,
                                        block_len)
        return torch.cat([words, words.new_zeros(1)]), wc
    wc, off, src, total = count_range(coder, bit_len.to(coder.device),
                                      block_len)
    with span("sync.total"):
        nwords = int(total)
    buf = torch.empty(nwords + 1, dtype=torch.int32, device=coder.device)
    launch_compact(rows_a, rows_b, src, coder, wc, off, buf, block_len)
    return buf, wc


def launch_compact(rows_a, rows_b, src, coder, wc, off, buf, block_len):
    """CP's copy on CUDA tensors, from the count pass's src, wc and off:
    block b's words into buf[off[b] : off[b] + wc[b]], and the flag bits
    of the blocks that could not be compacted into buf[-1], which the
    entry point zeroes before the launch."""
    if not 1 <= block_len <= MAX_BLOCK_LEN:
        raise ValueError(f"compact_range: block_len {block_len} outside "
                         f"1..{MAX_BLOCK_LEN}")
    B = src.numel()
    coder = coder.to(torch.int32).contiguous()
    groups = [r for r in (rows_a, rows_b) if r is not None]
    _build.check_tensors("compact_range", src, coder, buf, *groups)
    if (coder.shape != (B,) or src.dtype != torch.int32
            or any(r.dim() != 2 for r in groups)
            or any(t.dtype != torch.int64 or not t.is_contiguous()
                   or t.device != src.device for t in (wc, off))
            or wc.shape != (B,) or off.shape != (B,)):
        raise ValueError("compact_range: expects rows_a [Ba, Wa], rows_b "
                         "[Bb, Wb], src [B] int32, coder [B], and wc and off "
                         "[B] int64")
    _build.launch(
        "dct_compact_range", src, *_group(rows_a), *_group(rows_b),
        src.data_ptr(), coder.data_ptr(), wc.data_ptr(), off.data_ptr(),
        buf.data_ptr(), buf[-1:].data_ptr(), B, block_len,
    )
    compact_range.launches += 1


def _group(rows):
    """A group's (pointer, rows, width) arguments; (None, 0, 0) for none."""
    return (None, 0, 0) if rows is None else (rows.data_ptr(), *rows.shape)


def raise_if_bad(flag: int) -> None:
    """The kernel's flag word -> the twin's ValueError, if one is set."""
    if flag & _BAD_ROW:
        raise ValueError(ragged.BAD_PAYLOAD_ROW)
    if flag & _BAD_TABLE:
        raise ValueError(ragged.BAD_VERTICAL_TABLE)


def host_words(buf: torch.Tensor) -> np.ndarray:
    """:func:`compact_range_flagged`'s buf -> the words as a host uint32
    array, in one host read of words and flag together; raises ValueError
    where the flag is set."""
    with span("sync.words"):
        h = buf.cpu().numpy()
    raise_if_bad(int(h[-1]))
    return h[:-1].view(np.uint32)


def compact_range(
    rows_a: torch.Tensor | None,
    rows_b: torch.Tensor | None,
    coder: torch.Tensor,
    bit_len: torch.Tensor,
    block_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CP: (words [total] int32, wc [B] int64), block b's words at
    words[off_b : off_b + wc_b], off the exclusive scan of wc. On a card
    the flag costs a host read of its own; the encode reads it with the
    words instead (:func:`compact_range_flagged`, :func:`host_words`)."""
    buf, wc = compact_range_flagged(rows_a, rows_b, coder, bit_len, block_len)
    with span("sync.flag"):
        flag = int(buf[-1])
    raise_if_bad(flag)
    return buf[:-1], wc


count_range.launches = 0
compact_range.launches = 0
