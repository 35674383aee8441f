"""K5b: RICE bit unpacker, the frame's compact words -> zigzag values.

The counterpart of ``dctpu/kernels/attic/unpack_pallas.py``
(``unpack_pallas``). The CUDA kernel (``dctpu_torch/csrc/unpack.cu``)
reads each block's words where they lie in the frame's payload,
``words[start_i : start_i + count_i]``; the TPU kernel's
``stage_rice_scan`` rows were a Mosaic staging choice and are not carried
over.

The plain row twin :func:`unpack` is the ``dctpu/kernels/unpack_xla.py``
formulation on zero-padded rows. The sync table gives every 128-sample
sub-block its starting bit offset, so the decode runs 128 steps with all
B*S sub-blocks active per step: each step reads a 64-bit window at every
sub-block's bit position, counts the unary prefix, and extracts one
codeword. :func:`rice_unpack_words_plain` stages the rows with
``ragged.pad_payload`` and runs it.

``rice_unpack_words`` runs that twin for tensors on the CPU and launches
the kernel for tensors on a CUDA device; ``rice_unpack_words.launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import MASK32, popcount, to_i32, to_u32
from dctpu_torch.constants import (
    ESCAPE_Q,
    MAX_CODE_BITS,
    RAW_BITS,
    SUB_BLOCK,
    subs_per_block,
    sync_words,
)
from dctpu_torch.kernels import _build, ragged
from dctpu_torch.kernels.rice_pack import padded_words


def _funnel(lo: torch.Tensor, hi: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """32-bit window starting s bits into lo: (lo >> s) | (hi << (32-s))."""
    return (lo >> s) | ((hi << (32 - s)) & MASK32)


def _trailing_ones(w: torch.Tensor) -> torch.Tensor:
    """Consecutive 1-bits from bit 0 of a u32 value; all-ones -> 32."""
    return popcount(((~w) & (w + 1)) - 1)


def read_sync_table(payload: torch.Tensor, block_len: int) -> torch.Tensor:
    """[B, Wp] rows -> [B, S] sub-block bit lengths, int64."""
    words = to_u32(payload[:, : sync_words(block_len)])
    lens = torch.stack([words & 0xFFFF, words >> 16], dim=2)
    return lens.reshape(payload.shape[0], -1)[:, : subs_per_block(block_len)]


def unpack(
    payload: torch.Tensor,  # [B, Wp] int32 bit patterns, >= 2 zero words after
    k: torch.Tensor,        # [B]
    n: torch.Tensor,        # [B] valid samples
    block_len: int,
) -> torch.Tensor:
    """Returns z [B, L] zigzag values as int32 bit patterns (zeros past n)."""
    B, Wp = payload.shape
    L = block_len
    S = subs_per_block(L)
    T = min(SUB_BLOCK, L)
    dev = payload.device
    u = to_u32(payload)

    sub_lens = read_sync_table(payload, L)
    p = torch.cumsum(sub_lens, 1) - sub_lens + sync_words(L) * 32  # [B, S]
    sub_start = torch.arange(S, device=dev) * SUB_BLOCK
    cap = torch.clamp(L - sub_start, max=T)
    n_sub = torch.minimum(
        torch.clamp(n.to(torch.int64)[:, None] - sub_start, min=0), cap
    )
    kk = k.to(torch.int64)[:, None]
    kmask = (1 << kk) - 1

    out = torch.empty((B, S, T), dtype=torch.int64, device=dev)
    for t in range(T):
        j = p >> 5
        s = p & 31
        w0, w1, w2 = (u.gather(1, torch.clamp(j + d, max=Wp - 1)) for d in range(3))
        win_lo = _funnel(w0, w1, s)
        win_hi = _funnel(w1, w2, s)
        ones = _trailing_ones(win_lo)
        esc = ones >= ESCAPE_Q
        q = torch.clamp(ones, max=ESCAPE_Q - 1)
        v = ((win_lo >> (q + 1)) | (win_hi << (31 - q))) & MASK32
        z_norm = ((q << kk) | (v & kmask)) & MASK32
        z_esc = ((win_lo >> ESCAPE_Q) | (win_hi << (RAW_BITS - ESCAPE_Q))) & MASK32
        active = t < n_sub
        out[:, :, t] = torch.where(active, torch.where(esc, z_esc, z_norm), 0)
        length = torch.where(esc, MAX_CODE_BITS, q + 1 + kk)
        p = p + torch.where(active, length, 0)
    return to_i32(out.reshape(B, S * T)[:, :L])


def row_words(block_len: int) -> int:
    """Width of the twin's staged rows: the worst-case payload, then 2 zero
    words for the last codeword's 64-bit window."""
    return padded_words(block_len) + 2


def rice_unpack_words_plain(
    words: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
    k: torch.Tensor, n: torch.Tensor, block_len: int,
) -> torch.Tensor:
    """Plain twin of K5b: each block's words staged into a zero-padded row
    (a count past the row's width is cut to it), then :func:`unpack`."""
    W = row_words(block_len)
    count = count.to(torch.int64).clamp(max=W)
    return unpack(ragged.pad_payload(words, start, count, W), k, n, block_len)


def rice_unpack_words(
    words: torch.Tensor,  # [W] int32 bit patterns: the frame's payload words
    start: torch.Tensor,  # [B] first word of each block
    count: torch.Tensor,  # [B] words of each block, start + count <= W
    k: torch.Tensor,      # [B] Rice k, in [0, 30]
    n: torch.Tensor,      # [B] valid samples
    block_len: int,
) -> torch.Tensor:
    """K5b: z [B, block_len] zigzag values as int32 bit patterns (zeros
    past n) -- the contract of :func:`rice_unpack_words_plain`."""
    if words.device.type == "cpu":
        return rice_unpack_words_plain(words, start, count, k, n, block_len)
    if words.device.type != "cuda":
        raise ValueError(f"rice_unpack_words: unsupported device {words.device}")
    start, count, k, n = _build.block_args(
        "rice_unpack_words", words, start, count, k, n
    )
    B = start.numel()
    if words.dim() != 1 or any(t.shape != (B,) for t in (count, k, n)):
        raise ValueError(
            "rice_unpack_words: expects words [W], start, count, k and n [B]"
        )
    z = torch.empty((B, block_len), dtype=torch.int32, device=words.device)
    if B:
        _build.launch(
            "dct_rice_unpack_words", words,
            words.data_ptr(), start.data_ptr(), count.data_ptr(), k.data_ptr(),
            n.data_ptr(), z.data_ptr(), B, block_len, row_words(block_len),
        )
        rice_unpack_words.launches += 1
    return z


rice_unpack_words.launches = 0
