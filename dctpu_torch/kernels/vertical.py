"""VERTICAL coder (docs/FORMAT.md §2.2) in plain torch: the shared math.

The counterpart of ``dctpu/kernels/vertical_xla.py``: sub-block geometry,
the 32x32 bit transpose, the exceed table and width rule, the exact word
count used by adaptive selection, the bit-length cost of coder="vertical"
selection (VC's twin), the region assembly after the emit kernel,
and the sync-entry parse.

Layout of a staged payload row (what the emission writes, and the input
of K4's plain twin): ``[sync words | one REGION_PAD-word slot per
sub-block]``. A slot holds the sub's live disk words — ``pw*b`` plane
words, ``ceil(n_exc/4)`` position words, the value words — then zeros, so
compaction and staging are plain segment copies (kernels/ragged.py). K4
itself reads the compact disk words in place.

u32 words are int64 values in ``[0, 2**32)`` inside this module and int32
bit patterns at its edges (see ``dctpu_torch/_bits.py``).
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import bitlen, to_i32, to_u32
from dctpu_torch.constants import EXC_CAP, SUB_BLOCK, subs_per_block, sync_words

PLANE_REGION = 4 * 32          # 32 planes x 4 words
POS_REGION = EXC_CAP // 4      # 4 words of packed u8 positions
VAL_REGION = EXC_CAP           # 16 exception value words
REGION_WORDS = PLANE_REGION + POS_REGION + VAL_REGION  # 148
REGION_PAD = 192  # slot stride of decode_vertical_mega's staged rows


def padded_words_vertical(block_len: int) -> int:
    return sync_words(block_len) + subs_per_block(block_len) * REGION_PAD


def plane_word_counts(block_len: int, device) -> torch.Tensor:
    """Plane words per sub-block index, pw_s = ceil(cap_s / 32), [S] int64."""
    S = subs_per_block(block_len)
    cap = torch.clamp(
        block_len - torch.arange(S, device=device) * SUB_BLOCK, max=SUB_BLOCK
    )
    return (cap + 31) // 32


def sub_rows(z: torch.Tensor, n: torch.Tensor, block_len: int) -> torch.Tensor:
    """[B, L] u32 bit patterns -> [B*S, 128] int64 u32 rows, zero past n."""
    B, L = z.shape
    S = subs_per_block(block_len)
    valid = torch.arange(L, device=z.device)[None, :] < n.to(torch.int64)[:, None]
    u = torch.where(valid, to_u32(z), 0)
    pad = S * SUB_BLOCK - L
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
    return u.reshape(B * S, SUB_BLOCK)


def bit_transpose32(x: torch.Tensor) -> torch.Tensor:
    """32x32 bit-matrix transpose along the last axis (length 32):
    out[..., a] bit c == x[..., c] bit a. Self-inverse. u32 words in (int32
    bit patterns or int64 values), int64 u32 values out."""
    u = to_u32(x)
    c = torch.arange(32, device=x.device)
    return torch.stack([(((u >> a) & 1) << c).sum(-1) for a in range(32)], dim=-1)


def bit_planes32_plain(rows: torch.Tensor) -> torch.Tensor:
    """The bit planes of each 32-word group, K9's plain twin: [R, 128] u32
    words (int32 bit patterns or int64 values) -> [R, 128] int32, word
    p*4 + w = plane p of group w."""
    R = rows.shape[0]
    planes = bit_transpose32(rows.reshape(R, SUB_BLOCK // 32, 32))
    return to_i32(planes.transpose(1, 2).reshape(R, SUB_BLOCK))


def exceed_counts(rows: torch.Tensor) -> torch.Tensor:
    """[R, 128] u32 rows (zero where invalid) -> E [R, 33] int64,
    E[b] = #{samples with bit length > b}: a bit-length histogram, summed
    from the top."""
    R = rows.shape[0]
    hist = torch.zeros((R, 34), dtype=torch.int64, device=rows.device)
    hist.scatter_add_(1, bitlen(rows), torch.ones_like(rows))
    # all samples less those of bit length <= b
    return (hist.sum(1, keepdim=True) - hist.cumsum(1))[:, :33]


def select_width(E: torch.Tensor, pw: torch.Tensor):
    """FORMAT §2.2 width rule on E [R, 33], pw [R] -> (b, words, n_exc, e),
    each [R] int64. argmin over b of pw*b + ceil(n_exc/4) + vw among widths
    with n_exc <= EXC_CAP, ties to the smallest b (packed words*64 + b key).
    Same integers as vertical_xla._select_width."""
    b_axis = torch.arange(33, device=E.device)
    blmax = (E > 0).sum(1, keepdim=True)
    e_b = torch.clamp(blmax - b_axis, min=0)
    vw = torch.where(E > 0, torch.minimum(E, (e_b + 1) // 2), 0)
    words = pw.to(torch.int64)[:, None] * b_axis + (E + 3) // 4 + vw
    words = torch.where(E <= EXC_CAP, words, 1 << 24)
    key = (words * 64 + b_axis).min(1).values
    b = key & 63
    n_exc = E.gather(1, b[:, None])[:, 0]
    e = torch.where(n_exc > 0, blmax[:, 0] - b, 0)
    return b, key >> 6, n_exc, e


def vertical_selection_cost(z: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """coder="vertical" predictor-selection proxy (FORMAT §2.2): the sum of
    the bit lengths of the valid z, [B] int64. One dense pass (XLA on the
    TPU); the plain twin of VC (``kernels/vertical_cost.py``)."""
    return torch.where(valid, bitlen(z), 0).sum(-1)


def vertical_total_words(
    z: torch.Tensor, n: torch.Tensor, block_len: int
) -> torch.Tensor:
    """Exact VERTICAL coded words per block [B] int64 (FORMAT §4.1 VW_c)."""
    B = z.shape[0]
    S = subs_per_block(block_len)
    rows = sub_rows(z, n, block_len)
    pw = plane_word_counts(block_len, z.device).repeat(B)
    _, words, _, _ = select_width(exceed_counts(rows), pw)
    return words.reshape(B, S).sum(1)


def value_planes(vals: torch.Tensor) -> torch.Tensor:
    """[R, 16] u32 values -> [R, 16] bit-planed words: plane p = bits
    sum_j bit_p(v_j) << j, stored at bits [16*(p%2), +16) of word p//2."""
    j = torch.arange(EXC_CAP, device=vals.device)
    planes = torch.stack(
        [(((vals >> p) & 1) << j).sum(1) for p in range(32)], dim=1
    )  # [R, 32]
    return planes[:, 0::2] | (planes[:, 1::2] << 16)


def value_word_count(n_exc: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Exception value words: the cheaper of raw (n_exc) and bit-planed
    (ceil(e/2)) layouts, 0 without exceptions."""
    return torch.where(n_exc > 0, torch.minimum(n_exc, (e + 1) // 2), 0)


def sync_entries(
    b: torch.Tensor, n_exc: torch.Tensor, e: torch.Tensor
) -> torch.Tensor:
    """[B, S] widths -> [B, SW] u32 sync words: entry b | n_exc<<6 | (e-1)<<11,
    two u16 entries per word (FORMAT §2.1, §2.2)."""
    B, S = b.shape
    e_field = torch.where(n_exc > 0, e - 1, 0)
    entry = b | (n_exc << 6) | (e_field << 11)
    if S % 2:
        entry = torch.nn.functional.pad(entry, (0, 1))
    ep = entry.reshape(B, -1, 2)
    return ep[:, :, 0] | (ep[:, :, 1] << 16)


def parse_sync(sync: torch.Tensor, subs: int):
    """[B, SW] sync words -> (b, n_exc, e, vw), each [B, S] int64."""
    u = to_u32(sync)
    entries = torch.stack([u & 0xFFFF, u >> 16], dim=2).reshape(u.shape[0], -1)
    entries = entries[:, :subs]
    b = entries & 0x3F
    n_exc = (entries >> 6) & 0x1F
    e = torch.where(n_exc > 0, ((entries >> 11) & 0x1F) + 1, 0)
    return b, n_exc, e, value_word_count(n_exc, e)


def region_word_counts(b, n_exc, vw, block_len: int) -> torch.Tensor:
    """Live words per sub-block slot, [B, S] int64."""
    pw = plane_word_counts(block_len, b.device)
    return pw[None, :] * b + (n_exc + 3) // 4 + vw


def assemble_rows(
    plane_region: torch.Tensor,  # [B, S, 128] u32 bit patterns, p-major
    b: torch.Tensor,             # [B, S]
    n_exc: torch.Tensor,         # [B, S]
    e: torch.Tensor,             # [B, S]
    pos_words: torch.Tensor,     # [B, S, 4] u32 bit patterns
    vals: torch.Tensor,          # [B, S, 16] u32 bit patterns, 0 past n_exc
    block_len: int,
) -> torch.Tensor:
    """Emit analysis -> payload rows [B, SW + S*REGION_PAD] int32 bit patterns.

    The tail of vertical_xla.encode_vertical: the exception values in the
    cheaper of the raw and bit-planed layouts, the sync table, and each
    sub's live prefix (planes < b packed pw words apart, positions, values)
    placed in its slot. The slot is built with one gather from
    [planes | positions | values | 0]."""
    B, S, _ = plane_region.shape
    R = B * S
    dev = plane_region.device
    b, n_exc, e = (t.to(torch.int64).reshape(R) for t in (b, n_exc, e))
    vals = to_u32(vals).reshape(R, EXC_CAP)
    raw = n_exc <= (e + 1) // 2
    val_words = torch.where(raw[:, None], vals, value_planes(vals))
    vw = value_word_count(n_exc, e)
    src = torch.cat(
        [
            to_u32(plane_region).reshape(R, PLANE_REGION),
            to_u32(pos_words).reshape(R, POS_REGION),
            val_words,
            torch.zeros((R, 1), dtype=torch.int64, device=dev),
        ],
        dim=1,
    )  # [R, 149]
    pw = plane_word_counts(block_len, dev).repeat(B)[:, None]
    t = torch.arange(REGION_PAD, device=dev)[None, :]
    t0 = pw * b[:, None]
    posw = ((n_exc + 3) // 4)[:, None]
    tv = t - t0 - posw
    idx = torch.where(
        t < t0,
        (t // pw) * 4 + t % pw,
        torch.where(
            t < t0 + posw,
            PLANE_REGION + (t - t0),
            torch.where(
                (tv >= 0) & (tv < vw[:, None]),
                PLANE_REGION + POS_REGION + tv,
                REGION_WORDS,
            ),
        ),
    )
    slots = src.gather(1, idx).reshape(B, S * REGION_PAD)
    sync = sync_entries(b.reshape(B, S), n_exc.reshape(B, S), e.reshape(B, S))
    return to_i32(torch.cat([sync, slots], dim=1))
