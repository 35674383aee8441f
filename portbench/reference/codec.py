"""A plain PyTorch encoder of DCF1 frames, written from docs/FORMAT.md.

The benchmark's yardstick: what a frame of these streams must be, byte for
byte. It imports nothing of the program under test and takes nothing the
program made; it reads the samples the benchmark generated and computes
every block's (predictor, table, coder, k), its payload words and the frame
from them. It runs on any torch device, in slices of blocks.

Each step is the normative rule of the format, in dense tensor form:

  * residuals of each candidate (FORMAT §3): int64 arithmetic, wrapped to
    int32 once; the LPC sum is exact in int64 for tables whose
    coefficients keep |sum c_j x_j| below 2**63, as every table here does;
  * RICE (§2, §4): exact coded bits at every k in 0..k_max, first minimum;
  * VERTICAL (§2.2): the width rule per 128-sample sub-block from a
    bit-length histogram, ties to the smallest width;
  * adaptive coder (§4.1): the first minimum of the words over c0-RICE,
    c0-VERTICAL, c1-RICE, ...;
  * emission: each codeword, plane word, position word and value word is
    placed by its offset into the frame's payload (one scatter a slice).

u32 words are int64 values in [0, 2**32) throughout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
SUB = 128            # samples per sub-block (FORMAT §2.1)
ESCAPE_Q = 16
RAW_BITS = 32
EXC_CAP = 16
HISTORY = 4
LPC_SHIFT = 16
DELTA, DOUBLE_DELTA, LPC = 0, 1, 2
RICE, VERTICAL = 0, 1
SLICE_SAMPLES = 1 << 24  # samples per slice of blocks: bounds the working set


@dataclasses.dataclass(frozen=True)
class Settings:
    """The encoder's parameters (FORMAT §4): block length, candidate
    predictors, the Q16 LPC tables as (order, (c1, c2, c3, c4)), k_max and
    the coder ("rice", "vertical" or "adaptive")."""

    block_len: int
    predictors: Tuple[int, ...]
    lpc_tables: Tuple[Tuple[int, Tuple[int, int, int, int]], ...]
    k_max: int
    coder: str

    def candidates(self) -> List[Tuple[int, int]]:
        """(predictor, table index) in the normative order (FORMAT §4)."""
        out = [(p, 0) for p in (DELTA, DOUBLE_DELTA) if p in self.predictors]
        if LPC in self.predictors:
            out += [(LPC, t) for t in range(len(self.lpc_tables))]
        return out


@dataclasses.dataclass
class Blocks:
    """The per-block columns of a frame (host numpy) and its payload."""

    predictor: np.ndarray   # u8 [B]
    k: np.ndarray           # u8 [B]
    n: np.ndarray           # u16 [B]
    bit_len: np.ndarray     # u32 [B]
    table_idx: np.ndarray   # u8 [B]
    coder: np.ndarray       # u8 [B]
    history: np.ndarray     # i32 [B, 4]
    words: np.ndarray       # u32 [W], every block's payload in block order
    word_off: np.ndarray    # i64 [B + 1], each block's first word in `words`


def subs(block_len: int) -> int:
    return -(-block_len // SUB)


def sync_words(block_len: int) -> int:
    return (subs(block_len) + 1) // 2


def bitlen(u: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values below 2**53 (0 for 0): the
    binary exponent, exact in float64."""
    return torch.frexp(u.to(torch.float64)).exponent.to(torch.int64)


def first_min(v: torch.Tensor, dim: int):
    """(minimum, index of its first occurrence) along dim, by one minimum
    of value * size + index: the same on every device."""
    size = v.shape[dim]
    shape = [1] * v.dim()
    shape[dim] = size
    ax = torch.arange(size, device=v.device).reshape(shape)
    key = (v * size + ax).min(dim).values
    return key // size, key % size


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits, as int64."""
    return ((v & M32) ^ 0x80000000) - 0x80000000


# ------------------------------------------------------------------ blocks


def plan(lens: np.ndarray, block_len: int):
    """Per-stream block counts and first blocks (FORMAT §5)."""
    lens = np.asarray(lens, np.int64)
    nb = -(-lens // block_len)
    first = np.zeros(lens.size, np.int64)
    np.cumsum(nb[:-1], out=first[1:])
    return nb, first


def cut_blocks(flat: torch.Tensor, lens: np.ndarray, block_len: int):
    """Concatenated streams (int32, on any device) -> x [B, L] int64 (zero
    past n), n [B] int64, history [B, 4] int64 (h[j] = the sample j + 1
    before the block in its stream, 0 before the stream's start)."""
    dev = flat.device
    L = block_len
    lens_t = torch.as_tensor(np.asarray(lens, np.int64), device=dev)
    nb = (lens_t + L - 1) // L
    sstart = torch.cumsum(lens_t, 0) - lens_t
    sid = torch.repeat_interleave(torch.arange(lens_t.numel(), device=dev), nb)
    first = torch.cumsum(nb, 0) - nb
    local = torch.arange(sid.numel(), device=dev) - first[sid]
    base = sstart[sid] + local * L
    n = torch.clamp(sstart[sid] + lens_t[sid] - base, max=L)
    t = torch.arange(L, device=dev)
    src = base[:, None] + t
    ok = t[None, :] < n[:, None]
    x = torch.where(ok, flat[torch.where(ok, src, 0)].to(torch.int64), 0)
    j = base[:, None] - 1 - torch.arange(HISTORY, device=dev)
    hok = j >= sstart[sid][:, None]
    hist = torch.where(hok, flat[torch.where(hok, j, 0)].to(torch.int64), 0)
    return x, n, hist


# --------------------------------------------------------------- residuals


def residuals(x: torch.Tensor, hist: torch.Tensor, pred: int, coeffs) -> torch.Tensor:
    """Zigzag residuals [B, L] (int64, u32 values) of one candidate
    (FORMAT §2, §3)."""
    L = x.shape[1]
    ext = torch.cat([hist.flip(1), x], 1)  # ext[:, 4 + t] = x_t

    def lag(j):
        return ext[:, HISTORY - j: HISTORY - j + L]

    if pred == DELTA:
        p = lag(1)
    elif pred == DOUBLE_DELTA:
        p = 2 * lag(1) - lag(2)
    else:
        acc = torch.zeros_like(x)
        for j, c in enumerate(coeffs, start=1):
            if c:
                acc = acc + int(c) * lag(j)
        p = acc >> LPC_SHIFT
    r = wrap32(x - p)
    return ((r << 1) ^ (r >> 31)) & M32


def rice_bits(z: torch.Tensor, valid: torch.Tensor, k_max: int):
    """(best k, its coded bits), each [B] int64: FORMAT §4, ties to the
    smallest k."""
    totals = []
    q = z.clone()
    for k in range(k_max + 1):
        if k:
            q >>= 1
        cost = torch.where(q < ESCAPE_Q, q + 1 + k, ESCAPE_Q + RAW_BITS)
        totals.append(torch.where(valid, cost, 0).sum(1))
    best, k = first_min(torch.stack(totals), 0)
    return k, best


def width_rule(rows: torch.Tensor, pw: int):
    """FORMAT §2.2 on sub-block rows [R, 128] (zero past n) -> (b, words,
    n_exc, e), each [R] int64."""
    bl = bitlen(rows)
    hist = torch.zeros((rows.shape[0], 34), dtype=torch.int64, device=rows.device)
    hist.scatter_add_(1, bl, torch.ones_like(bl))
    exc = (SUB - torch.cumsum(hist, 1))[:, :33]  # exc[:, b] = #{bl > b}
    blmax = bl.max(1, keepdim=True).values
    b_axis = torch.arange(33, device=rows.device)
    e_b = torch.clamp(blmax - b_axis, min=0)
    vw = torch.where(exc > 0, torch.minimum(exc, (e_b + 1) // 2), 0)
    words = pw * b_axis + (exc + 3) // 4 + vw
    words = torch.where(exc <= EXC_CAP, words, 1 << 40)
    wmin, b = first_min(words, 1)  # ties to the smallest width
    n_exc = exc.gather(1, b[:, None])[:, 0]
    e = torch.where(n_exc > 0, blmax[:, 0] - b, 0)
    return b, wmin, n_exc, e


def sub_rows(z: torch.Tensor) -> torch.Tensor:
    B, L = z.shape
    pad = subs(L) * SUB - L
    if pad:
        z = torch.nn.functional.pad(z, (0, pad))
    return z.reshape(-1, SUB)


def plane_words(block_len: int) -> int:
    """Plane words of a sub-block; every sub of a block of a multiple of
    128 samples holds 128."""
    if block_len % SUB:
        raise ValueError("block_len must be a multiple of 128 here")
    return SUB // 32


# ---------------------------------------------------------------- selection


def select(x, n, hist, cfg: Settings):
    """(candidate, coder, k) per block, each [B] int64 (FORMAT §4, §4.1;
    coder="vertical" by the §2.2 proxy cost)."""
    L = x.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] < n[:, None]
    opts, ks = [], []
    for pred, ti in cfg.candidates():
        coeffs = cfg.lpc_tables[ti][1] if pred == LPC else None
        z = torch.where(valid, residuals(x, hist, pred, coeffs), 0)
        if cfg.coder == "vertical":
            opts.append(bitlen(z).sum(1))
            continue
        k, bits = rice_bits(z, valid, cfg.k_max)
        ks.append(k)
        if cfg.coder == "rice":
            opts.append(bits)
            continue
        _, w, _, _ = width_rule(sub_rows(z), plane_words(L))
        opts += [(bits + 31) // 32, w.reshape(x.shape[0], -1).sum(1)]
    _, o = first_min(torch.stack(opts), 0)
    if cfg.coder == "adaptive":
        choice, coder = o // 2, o % 2
    else:
        choice = o
        coder = torch.full_like(o, VERTICAL if cfg.coder == "vertical" else RICE)
    if not ks:
        return choice, coder, torch.zeros_like(choice)
    k = torch.stack(ks).gather(0, choice[None, :])[0]
    return choice, coder, torch.where(coder == RICE, k, 0)


def chosen_z(x, hist, n, choice, cfg: Settings):
    """Each block's zigzag residuals under its chosen candidate, [B, L]."""
    L = x.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] < n[:, None]
    z = torch.zeros_like(x)
    for ci, (pred, ti) in enumerate(cfg.candidates()):
        sel = choice == ci
        if bool(sel.any()):
            coeffs = cfg.lpc_tables[ti][1] if pred == LPC else None
            z[sel] = residuals(x[sel], hist[sel], pred, coeffs)
    return torch.where(valid, z, 0)


# ----------------------------------------------------------------- emission


def rice_payload(z, n, k, L):
    """RICE emission (FORMAT §2, §2.1). Returns (bit_len [B], sync [B, SW],
    code words as (block, word, value) triples of the bitstream)."""
    B = z.shape[0]
    t = torch.arange(L, device=z.device)[None, :]
    valid = t < n[:, None]
    kk = k[:, None]
    q = z >> kk
    esc = q >= ESCAPE_Q
    ln = torch.where(esc, ESCAPE_Q + RAW_BITS, q + 1 + kk)
    qs = torch.clamp(q, max=ESCAPE_Q)
    one = torch.ones_like(z)
    code = torch.where(
        esc, 0xFFFF | (z << 16),
        ((one << qs) - 1) | ((z & ((one << kk) - 1)) << (qs + 1)),
    )
    ln = torch.where(valid, ln, 0)
    code = torch.where(valid, code, 0)
    S = subs(L)
    sub_len = torch.nn.functional.pad(ln, (0, S * SUB - L)).reshape(B, S, SUB).sum(2)
    sync = pack_u16(sub_len)
    off = torch.cumsum(ln, 1) - ln
    bit_len = ln.sum(1)
    w, s = off >> 5, off & 31
    lo, hi = code & M32, code >> 32
    parts = (
        (w, (lo << s) & M32),
        (w + 1, ((lo >> (32 - s)) | (hi << s)) & M32),
        (w + 2, (hi << s) >> 32),
    )
    return bit_len, sync, parts


def pack_u16(entries: torch.Tensor) -> torch.Tensor:
    """[B, S] u16 entries -> [B, ceil(S/2)] u32 words, entry s at bits
    16 * (s % 2) of word s // 2."""
    B, S = entries.shape
    if S % 2:
        entries = torch.nn.functional.pad(entries, (0, 1))
    e = entries.reshape(B, -1, 2)
    return e[:, :, 0] | (e[:, :, 1] << 16)


def vertical_payload(z, L):
    """VERTICAL emission (FORMAT §2.2). Returns (bit_len [B], sync [B, SW],
    the bitstream's words as (block, word, value) triples)."""
    B = z.shape[0]
    S = subs(L)
    pw = plane_words(L)
    dev = z.device
    rows = sub_rows(z)  # [R, 128]
    R = rows.shape[0]
    b, words, n_exc, e = width_rule(rows, pw)
    e_field = torch.where(n_exc > 0, e - 1, 0)
    sync = pack_u16((b | (n_exc << 6) | (e_field << 11)).reshape(B, S))
    bit_len = 32 * words.reshape(B, S).sum(1)
    sub_off = (torch.cumsum(words.reshape(B, S), 1) - words.reshape(B, S)).reshape(R)
    blk = torch.arange(B, device=dev).repeat_interleave(S)

    # bit planes p < b: plane p, word w at p * pw + w
    g = rows.reshape(R, pw, 32)
    lane = torch.arange(32, device=dev)
    planes = torch.stack([(((g >> p) & 1) << lane).sum(2) for p in range(32)], 1)
    p_idx = torch.arange(32 * pw, device=dev)[None, :]
    plane_ok = p_idx < (pw * b)[:, None]
    # exceptions: sub-local positions, ascending
    exc = (rows >> b[:, None]) != 0
    rank = torch.cumsum(exc.to(torch.int64), 1) - 1
    i = torch.arange(SUB, device=dev)[None, :]
    pos = torch.zeros((R, EXC_CAP // 4 + 1), dtype=torch.int64, device=dev)
    pos.scatter_add_(1, torch.where(exc, rank // 4, EXC_CAP // 4),
                     torch.where(exc, i << (8 * (rank % 4)), 0))
    vals = torch.zeros((R, EXC_CAP + 1), dtype=torch.int64, device=dev)
    vals.scatter_add_(1, torch.where(exc, rank, EXC_CAP),
                      torch.where(exc, rows >> b[:, None], 0))
    vals = vals[:, :EXC_CAP]
    j = torch.arange(EXC_CAP, device=dev)
    vplanes = torch.stack([(((vals >> p) & 1) << j).sum(1) for p in range(32)], 1)
    vbits = vplanes[:, 0::2] | (vplanes[:, 1::2] << 16)
    raw = n_exc <= (e + 1) // 2
    vw = torch.where(n_exc > 0, torch.minimum(n_exc, (e + 1) // 2), 0)
    vwords = torch.where(raw[:, None], vals, vbits)
    posw = (n_exc + 3) // 4

    t_pos = pw * b[:, None] + torch.arange(EXC_CAP // 4, device=dev)[None, :]
    pos_ok = torch.arange(EXC_CAP // 4, device=dev)[None, :] < posw[:, None]
    t_val = (pw * b + posw)[:, None] + j[None, :]
    val_ok = j[None, :] < vw[:, None]
    word = torch.cat([p_idx.expand(R, -1), t_pos, t_val], 1) + sub_off[:, None]
    value = torch.cat([planes.reshape(R, 32 * pw), pos[:, :EXC_CAP // 4], vwords], 1)
    ok = torch.cat([plane_ok, pos_ok, val_ok], 1)
    parts = ((torch.where(ok, word, -1), torch.where(ok, value, 0), blk),)
    return bit_len, sync, parts


def encode_slice(x, n, hist, cfg: Settings):
    """Select and emit one slice of blocks. Returns host arrays (predictor,
    k, table_idx, coder, bit_len) and the slice's payload words (u32, its
    blocks' payloads in block order)."""
    L = x.shape[1]
    B = x.shape[0]
    dev = x.device
    SW = sync_words(L)
    choice, coder, k = select(x, n, hist, cfg)
    z = chosen_z(x, hist, n, choice, cfg)
    bit_len = torch.zeros(B, dtype=torch.int64, device=dev)
    sync = torch.zeros((B, SW), dtype=torch.int64, device=dev)
    groups = []
    for cid in (RICE, VERTICAL):
        idx = torch.nonzero(coder == cid)[:, 0]
        if idx.numel() == 0:
            continue
        if cid == RICE:
            bl, sy, parts = rice_payload(z[idx], n[idx], k[idx], L)
            parts = [(w, v, None) for w, v in parts]
        else:
            bl, sy, parts = vertical_payload(z[idx], L)
        bit_len[idx] = bl
        sync[idx] = sy
        groups.append((idx, parts))
    count = SW + (bit_len + 31) // 32
    off = torch.cumsum(count, 0) - count
    total = int(count.sum())
    out = torch.zeros(total + 1, dtype=torch.int64, device=dev)  # +1: a sink
    sw = torch.arange(SW, device=dev)
    out.scatter_add_(0, (off[:, None] + sw).reshape(-1), sync.reshape(-1))
    for idx, parts in groups:
        for w, v, blk in parts:
            rows = idx[:, None] if blk is None else idx[blk][:, None]
            # a zero adds nothing: its word may lie past the block's end
            dest = torch.where((w >= 0) & (v != 0), off[rows] + SW + w, total)
            out.scatter_add_(0, dest.reshape(-1), v.reshape(-1))
    cands = cfg.candidates()
    pred_of = torch.tensor([p for p, _ in cands], device=dev)
    ti_of = torch.tensor([t if p == LPC else 0 for p, t in cands], device=dev)
    host = [t.cpu().numpy() for t in
            (pred_of[choice], k, ti_of[choice], coder, bit_len)]
    return host, out[:total].cpu().numpy().astype(np.uint32)


def encode(flat: torch.Tensor, lens: np.ndarray, cfg: Settings) -> Blocks:
    """All streams' blocks (flat int32 samples on any device, lengths) ->
    :class:`Blocks`, encoded in slices of at most SLICE_SAMPLES samples."""
    L = cfg.block_len
    x, n, hist = cut_blocks(flat, lens, L)
    B = x.shape[0]
    per = max(1, SLICE_SAMPLES // L)
    cols, words = [], []
    for a in range(0, B, per):
        host, w = encode_slice(x[a:a + per], n[a:a + per], hist[a:a + per], cfg)
        cols.append(host)
        words.append(w)
    pred, k, ti, coder, bit_len = (
        np.concatenate(c) for c in zip(*cols)) if cols else [np.zeros(0, np.int64)] * 5
    counts = sync_words(L) + (bit_len.astype(np.int64) + 31) // 32
    word_off = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=word_off[1:])
    return Blocks(
        predictor=pred.astype(np.uint8), k=k.astype(np.uint8),
        n=n.cpu().numpy().astype(np.uint16), bit_len=bit_len.astype(np.uint32),
        table_idx=ti.astype(np.uint8), coder=coder.astype(np.uint8),
        history=hist.cpu().numpy().astype(np.int32),
        words=np.concatenate(words) if words else np.zeros(0, np.uint32),
        word_off=word_off,
    )


def split_frames(blocks: Blocks, first: Sequence[int], count: Sequence[int]) -> List[Blocks]:
    """The blocks of several frames encoded together, cut into each
    frame's blocks: frame i holds blocks first[i] .. first[i] + count[i]."""
    out = []
    for f, c in zip(first, count):
        w0, w1 = blocks.word_off[f], blocks.word_off[f + c]
        out.append(Blocks(
            predictor=blocks.predictor[f:f + c], k=blocks.k[f:f + c],
            n=blocks.n[f:f + c], bit_len=blocks.bit_len[f:f + c],
            table_idx=blocks.table_idx[f:f + c], coder=blocks.coder[f:f + c],
            history=blocks.history[f:f + c], words=blocks.words[w0:w1],
            word_off=blocks.word_off[f:f + c + 1] - w0,
        ))
    return out
