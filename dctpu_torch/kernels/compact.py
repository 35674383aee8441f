"""CP: the encode's compaction, a range's payload rows -> its compact words.

The counterpart of the reference's compaction and interleave: the XLA
``compact_rice_semi`` / ``compact_vertical_semi`` (``dctpu/kernels/ragged.py``),
the host ``squeeze_host`` and the host interleave of the coder groups in
block order (``dctpu/codec/api.py``). On the card it is one CUDA kernel per
encode range, ``dctpu_torch/csrc/compact.cu``, that reads each block's
payload row from its coder group's rows and writes its disk words at its
frame offset.

Block b's row is ``rows_a[src[b]]`` for ``src[b] >= 0`` and
``rows_b[-1 - src[b]]`` for ``src[b] < 0``, as in R's range form; its word
count is the reference's (:func:`word_counts`). A VERTICAL block whose sync
table does not describe its words raises ValueError, on both devices.

``compact_range`` runs the plain twin :func:`compact_range_plain` for
tensors on the CPU and launches the kernel for tensors on a CUDA device;
``compact_range.launches`` counts the kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dctpu_torch.constants import CODER_VERTICAL, SUB_BLOCK, sync_words
from dctpu_torch.kernels import _build, ragged

MAX_BLOCK_LEN = 512 * SUB_BLOCK  # the kernel scans at most 512 sub-blocks
_BAD_TABLE, _BAD_ROW = 1, 2      # the kernel's flag bits


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


def compact_range_plain(rows_a, rows_b, src, coder, bit_len, block_len):
    """Plain twin of CP: the blocks of each group and coder compacted with
    :func:`compact_enc_payload`, then scattered to their frame offsets."""
    wc = word_counts(coder, bit_len, block_len)
    off = torch.cumsum(wc, 0) - wc
    out = torch.empty(int(wc.sum()), dtype=torch.int32, device=src.device)
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
    src: torch.Tensor,            # [B] int32 each block's source row
    coder: torch.Tensor,          # [B] coder ids
    bit_len: torch.Tensor,        # [B] int64
    block_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CP -> (buf [total + 1] int32, wc [B] int64): the range's compact
    words, then a flag word that is non-zero where a block could not be
    compacted. On a card one host read (the total, to size buf) and one
    launch; the flag is left unread, for the caller's download
    (:func:`host_words`). On the CPU the twin, which raises itself."""
    if src.device.type == "cpu":
        words, wc = compact_range_plain(rows_a, rows_b, src, coder, bit_len,
                                        block_len)
        return torch.cat([words, words.new_zeros(1)]), wc
    if src.device.type != "cuda":
        raise ValueError(f"compact_range: unsupported device {src.device}")
    wc = word_counts(coder, bit_len.to(src.device), block_len)
    off = torch.cumsum(wc, 0) - wc
    buf = torch.empty(int(wc.sum()) + 1, dtype=torch.int32, device=src.device)
    launch_compact(rows_a, rows_b, src, coder, wc, off, buf, block_len)
    return buf, wc


def launch_compact(rows_a, rows_b, src, coder, wc, off, buf, block_len):
    """CP's launch on CUDA tensors: block b's words into buf[off[b] :
    off[b] + wc[b]] (wc and off [B] int64), the flag into buf[-1], which it
    zeroes first."""
    if not 1 <= block_len <= MAX_BLOCK_LEN:
        raise ValueError(f"compact_range: block_len {block_len} outside "
                         f"1..{MAX_BLOCK_LEN}")
    B = src.numel()
    src = src.to(torch.int32).contiguous()
    coder = coder.to(torch.int32).contiguous()
    groups = [r for r in (rows_a, rows_b) if r is not None]
    _build.check_tensors("compact_range", src, coder, buf, *groups)
    if (coder.shape != (B,) or any(r.dim() != 2 for r in groups)
            or any(t.shape != (B,) or t.dtype != torch.int64
                   or not t.is_contiguous() or t.device != src.device
                   for t in (wc, off))):
        raise ValueError("compact_range: expects rows_a [Ba, Wa], rows_b "
                         "[Bb, Wb], src and coder [B], wc and off [B] int64")
    buf[-1] = 0
    if B:
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
    h = buf.cpu().numpy()
    raise_if_bad(int(h[-1]))
    return h[:-1].view(np.uint32)


def compact_range(
    rows_a: torch.Tensor | None,
    rows_b: torch.Tensor | None,
    src: torch.Tensor,
    coder: torch.Tensor,
    bit_len: torch.Tensor,
    block_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CP: (words [total] int32, wc [B] int64), block b's words at
    words[off_b : off_b + wc_b], off the exclusive scan of wc. On a card
    the flag costs a host read of its own; the encode reads it with the
    words instead (:func:`compact_range_flagged`, :func:`host_words`)."""
    buf, wc = compact_range_flagged(rows_a, rows_b, src, coder, bit_len,
                                    block_len)
    raise_if_bad(int(buf[-1]))
    return buf[:-1], wc


compact_range.launches = 0
