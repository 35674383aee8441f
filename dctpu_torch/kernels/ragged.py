"""Device-side ragged copies between payload rows and compact disk words.

The counterpart of ``dctpu/kernels/ragged.py`` and the host transforms it
mirrors (``dctpu/codec/api.py`` compact_payload / pad_payload,
``dctpu/codec/vertical_host.py`` compact_vertical / stage_vertical). Every
transform here is one segment copy on the tensors' device: only the compact
words ever need to cross to the host. The TPU's gather tunings (tile
lattice, shape buckets) are not carried over; they never reach disk.

These are plain twins: the compaction's of CP (``kernels/compact.py``), the
staging's of the decode kernels K4 and K5b, which read the words in place.
No card path runs them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dctpu_torch.constants import EXC_CAP, subs_per_block, sync_words
from dctpu_torch.kernels.vertical import (
    REGION_PAD,
    padded_words_vertical,
    parse_sync,
    region_word_counts,
)

BAD_VERTICAL_TABLE = "VERTICAL sync table does not match the block's words"
BAD_PAYLOAD_ROW = "a block's source row or word count does not fit its payload rows"


def segment_index(start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Flat indices of the segments [start_i, start_i + length_i), in order."""
    length = length.to(torch.int64)
    total = int(length.sum())
    seg = torch.repeat_interleave(
        torch.arange(length.numel(), device=length.device), length,
        output_size=total,
    )
    first = torch.cumsum(length, 0) - length
    within = torch.arange(total, device=length.device) - first[seg]
    return start.to(torch.int64)[seg] + within


def copy_segments(dst, dst_start, src, src_start, length) -> None:
    """dst[dst_start_i + j] = src[src_start_i + j] for j < length_i (flat)."""
    dst[segment_index(dst_start, length)] = src[segment_index(src_start, length)]


def payload_word_counts(bit_len: torch.Tensor, block_len: int) -> torch.Tensor:
    """Sync words + bitstream words per block (FORMAT §2.1), int64."""
    return sync_words(block_len) + (bit_len.to(torch.int64) + 31) // 32


def compact_payload(
    payload: torch.Tensor, bit_len: torch.Tensor, block_len: int
) -> torch.Tensor:
    """[B, W] RICE rows -> concatenated exact-size words (frame layout).
    Raises ValueError when a block's words do not fit its row."""
    B, W = payload.shape
    starts = torch.arange(B, device=payload.device) * W
    wc = payload_word_counts(bit_len, block_len)
    if bool(((wc < sync_words(block_len)) | (wc > W)).any()):
        raise ValueError(BAD_PAYLOAD_ROW)
    return payload.reshape(-1)[segment_index(starts, wc)]


def pad_payload(
    words: torch.Tensor, start: torch.Tensor, count: torch.Tensor, width: int
) -> torch.Tensor:
    """Inverse of compact_payload for the blocks whose words are
    words[start_i : start_i + count_i]: -> [B, width] rows, zero padded."""
    B = start.numel()
    out = torch.zeros((B, width), dtype=words.dtype, device=words.device)
    dst = torch.arange(B, device=words.device) * width
    copy_segments(out.reshape(-1), dst, words, start, count)
    return out


def compact_vertical(
    payload: torch.Tensor, bit_len: torch.Tensor, block_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staged VERTICAL rows [B, W] -> (disk words, words per block [B]
    int64). A block's count is the reference's, SW + bit_len // 32; raises
    ValueError when its sync entries do not describe exactly that many
    words (a width above 32 or more than EXC_CAP exceptions included), or
    when the rows are narrower than padded_words_vertical."""
    B, W = payload.shape
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    dev = payload.device
    if W < padded_words_vertical(block_len):
        raise ValueError(BAD_PAYLOAD_ROW)
    b, n_exc, _, vw = parse_sync(payload[:, :SW], S)
    wc_sub = region_word_counts(b, n_exc, vw, block_len)  # [B, S]
    wc = SW + bit_len.to(torch.int64) // 32
    bad = (b > 32) | (n_exc > EXC_CAP)
    if bool(bad.any()) or bool((SW + wc_sub.sum(1) != wc).any()):
        raise ValueError(BAD_VERTICAL_TABLE)
    row0 = torch.arange(B, device=dev)[:, None] * W
    starts = torch.cat(
        [row0, row0 + SW + torch.arange(S, device=dev) * REGION_PAD], dim=1
    )
    lens = torch.cat([torch.full((B, 1), SW, device=dev), wc_sub], dim=1)
    words = payload.reshape(-1)[segment_index(starts.reshape(-1), lens.reshape(-1))]
    return words, wc


def stage_vertical(
    words: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
    block_len: int,
) -> torch.Tensor:
    """Disk words of the blocks at words[start_i : start_i + count_i] ->
    staged rows [B, SW + S*REGION_PAD], each slot's live words then zeros.

    Raises ValueError when a block's sync entries do not describe exactly
    its count_i words (a width above 32 or more than EXC_CAP exceptions
    included): those words would land outside their slots. Sync words at
    or past count_i read as 0, so no block's words are read past its
    count."""
    B = start.numel()
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    W = padded_words_vertical(block_len)
    dev = words.device
    start = start.to(torch.int64)
    out = torch.zeros((B, W), dtype=words.dtype, device=dev)
    if B == 0:
        return out
    j = torch.arange(SW, device=dev)
    inside = j < count.to(torch.int64)[:, None]
    idx = torch.where(inside, start[:, None] + j, 0)
    out[:, :SW] = torch.where(inside, words[idx], 0)
    b, n_exc, _, vw = parse_sync(out[:, :SW], S)
    wc_sub = region_word_counts(b, n_exc, vw, block_len)  # [B, S]
    bad = (b > 32) | (n_exc > EXC_CAP)
    if bool(bad.any()) or bool((SW + wc_sub.sum(1) != count).any()):
        raise ValueError(BAD_VERTICAL_TABLE)
    src = start[:, None] + SW + torch.cumsum(wc_sub, 1) - wc_sub
    dst = (
        torch.arange(B, device=dev)[:, None] * W + SW
        + torch.arange(S, device=dev) * REGION_PAD
    )
    copy_segments(
        out.reshape(-1), dst.reshape(-1), words, src.reshape(-1),
        wc_sub.reshape(-1),
    )
    return out
