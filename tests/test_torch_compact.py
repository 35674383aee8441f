"""CP's plain twin (``kernels/compact.py``) vs the reference's compaction and
interleave.

The same blocks, made with numpy from a seed, are emitted by both packages
(the reference through its portable XLA emission on the CPU); the port's
``compact_range`` of the two groups' rows must equal, word for word, the
reference's ``compact_enc_payload_device`` of each group followed by its
numpy interleave into block order (``dctpu/codec/api.py``,
``_compress_adaptive``). Tolerance: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import api as ref_api
from dctpu.codec import encode as ref_encode
from dctpu.config import CodecConfig as RefConfig
from dctpu.format.frame import payload_word_counts as ref_word_counts
from dctpu_torch.codec import api, encode
from dctpu_torch.config import CodecConfig, from_reference
from dctpu_torch.constants import EXC_CAP, sync_words
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.kernels import compact, ragged

B = 12
CODERS = ("rice", "vertical")


def _wrap_cumsum(r):
    """x with DELTA residuals r from a zero history (int32, wrapping)."""
    return (np.cumsum(r.astype(np.int64), axis=1) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


def _blocks(L, seed):
    """B blocks of block_len L: an empty block, a one-sample block, a
    full-range block (all-escape RICE at k = 0; VERTICAL width 32), DELTA
    residuals of 2**31 in every sample (b = 32), small DELTA residuals with
    EXC_CAP large ones in each sub-block, then smooth blocks under random
    candidates and k."""
    rng = np.random.default_rng(seed)
    x = (np.cumsum(rng.integers(-40, 41, size=(B, L)), axis=1) + 5000).astype(
        np.int32)
    h = rng.integers(-(2**20), 2**20, size=(B, 4)).astype(np.int32)
    n = np.full(B, L, np.int32)
    n[0], n[1] = 0, 1
    choice = rng.integers(0, 6, size=B).astype(np.int32)
    k = rng.integers(0, 25, size=B).astype(np.int32)
    x[2] = rng.integers(-(2**31), 2**31, size=L, dtype=np.int64)
    choice[2:5], k[2], h[2:5] = 0, 0, 0
    x[3] = _wrap_cumsum(np.full((1, L), 2**31, np.int64))[0]
    r = rng.integers(-3, 4, size=(1, L))
    for s0 in range(0, L, 128):
        cap = min(128, L - s0)
        pos = s0 + rng.choice(cap, size=min(EXC_CAP, cap), replace=False)
        r[0, pos] = rng.integers(2**20, 2**28, size=pos.size)
    x[4] = _wrap_cumsum(r)[0]
    return x, n, h, choice, k


@pytest.fixture(scope="module", params=[1, 200, 4096, 4100])
def emitted(request):
    """Every block emitted by both coders in both packages: L, the port's
    {coder: (rows, bit_len)} and the reference's."""
    L = request.param
    x, n, h, choice, k = _blocks(L, seed=L)
    ref_cfg = RefConfig(block_len=L)
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    port, ref = {}, {}
    for coder in CODERS:
        enc = ref_encode.emit_blocks(
            jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), jnp.asarray(choice),
            jnp.asarray(k), ref_cfg, coder, "xla")
        ref[coder] = (np.asarray(enc.payload), np.asarray(enc.bit_len))
        rows, bl = encode.emit_blocks(
            *(torch.from_numpy(a) for a in (x, n, h, choice, k)), cfg, coder)
        assert np.array_equal(rows.numpy().view(np.uint32), ref[coder][0])
        assert np.array_equal(bl.numpy(), ref[coder][1])
        port[coder] = (rows, bl)
    return L, port, ref


def _coders(layout):
    """Each block's coder id (0 RICE, 1 VERTICAL) under a layout."""
    if layout == "interleaved":
        return np.arange(B) % 2
    if layout in ("rice_only", "vertical_only"):
        return np.full(B, int(layout == "vertical_only"))
    if layout == "vertical_first":  # VERTICAL blocks, then RICE ones
        return (np.arange(B) < B // 2).astype(np.int64)
    return np.random.default_rng(3).integers(0, 2, size=B)


def reference_range(ref, coder, L):
    """The reference's compaction of each coder group, then its interleave
    of the groups into block order."""
    wc = np.zeros(B, np.int64)
    group_words = {}
    for gid, gname in enumerate(CODERS):
        idx = np.nonzero(coder == gid)[0]
        if idx.size == 0:
            continue
        rows, bl = ref[gname][0][idx], ref[gname][1][idx]
        group_words[gid] = ref_api.compact_enc_payload_device(
            jnp.asarray(rows), bl, L, gname)
        wc[idx] = (sync_words(L) + bl.astype(np.int64) // 32
                   if gname == "vertical" else ref_word_counts(bl, L))
    off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(wc, out=off[1:])
    out = np.zeros(int(off[-1]), dtype=np.uint32)
    for gid, words in group_words.items():
        idx = np.nonzero(coder == gid)[0]
        wcg = wc[idx]
        src_off = np.zeros(idx.size + 1, dtype=np.int64)
        np.cumsum(wcg, out=src_off[1:])
        blk = np.repeat(np.arange(idx.size, dtype=np.int64), wcg)
        pos = np.arange(int(src_off[-1]), dtype=np.int64) - src_off[blk]
        out[off[idx[blk]] + pos] = words
    return out, wc


def port_groups(port, coder):
    """(rows_a, rows_b, bit_len) of a range whose blocks take their coder's
    rows: each group's rows in block order, the RICE group first where the
    range has one (the layout the encode stacks them in)."""
    bit_len = torch.zeros(B, dtype=torch.int64)
    groups = []
    for gname in CODERS:
        idx = torch.from_numpy(np.nonzero(coder == CODERS.index(gname))[0])
        if idx.numel() == 0:
            continue
        groups.append(port[gname][0][idx])
        bit_len[idx] = port[gname][1][idx]
    groups += [None] * (2 - len(groups))
    return groups[0], groups[1], bit_len


@pytest.mark.parametrize("layout", ["interleaved", "rice_only", "vertical_only",
                                    "mixed", "vertical_first"])
def test_compact_range_matches_reference(emitted, layout):
    L, port, ref = emitted
    coder = _coders(layout)
    want, want_wc = reference_range(ref, coder, L)
    rows_a, rows_b, bit_len = port_groups(port, coder)
    words, wc = compact.compact_range(rows_a, rows_b, torch.from_numpy(coder),
                                      bit_len, L)
    assert words.dtype == torch.int32 and wc.dtype == torch.int64
    assert np.array_equal(words.numpy().view(np.uint32), want)
    assert np.array_equal(wc.numpy(), want_wc)


def emit_range_counts(coder_h, bit_len, L):
    """What the encode computed around CP before the count pass: each
    block's source row by a host loop over the coder groups (the RICE group
    first), word_counts, their exclusive cumsum and their total."""
    src_h = np.empty(coder_h.size, np.int32)
    seen = False
    for gid in range(len(CODERS)):
        idx = np.nonzero(coder_h == gid)[0]
        if idx.size == 0:
            continue
        within = np.arange(idx.size, dtype=np.int32)
        src_h[idx] = -1 - within if seen else within
        seen = True
    wc = compact.word_counts(torch.from_numpy(coder_h), bit_len, L)
    return src_h, wc, torch.cumsum(wc, 0) - wc, int(wc.sum())


# (blocks taken, the layout of their coders)
COUNT_LAYOUTS = {
    "empty": ([], "rice_only"),
    "rice_only": (list(range(B)), "rice_only"),
    "vertical_only": (list(range(B)), "vertical_only"),
    "interleaved": (list(range(B)), "interleaved"),
    "mixed": (list(range(B)), "mixed"),
    "one_block": ([3], "vertical_only"),
}


@pytest.mark.parametrize("layout", list(COUNT_LAYOUTS))
def test_count_range_matches_emit_range_counts(emitted, layout):
    """The count pass's twin gives what the encode computed before it (the
    host's source rows, word_counts, the cumsum and the total) and the
    reference's word counts."""
    L, port, ref = emitted
    blocks, coders = COUNT_LAYOUTS[layout]
    coder_full = _coders(coders)
    _, ref_wc = reference_range(ref, coder_full, L)
    coder = coder_full[blocks].astype(np.int32)
    sel = torch.tensor(blocks, dtype=torch.int64)
    bit_len = torch.where(torch.from_numpy(coder) == 1,
                          port["vertical"][1][sel], port["rice"][1][sel])
    wc, off, src, got_total = compact.count_range(torch.from_numpy(coder),
                                                  bit_len, L)
    src_h, want_wc, want_off, total = emit_range_counts(coder, bit_len, L)
    assert (wc.dtype, off.dtype, src.dtype) == (torch.int64, torch.int64,
                                                torch.int32)
    assert np.array_equal(src.numpy(), src_h)
    assert torch.equal(wc, want_wc) and torch.equal(off, want_off)
    assert np.array_equal(wc.numpy(), ref_wc[blocks])
    assert got_total.tolist() == [total]


def test_compact_range_of_an_empty_range():
    empty = torch.zeros(0, dtype=torch.int32)
    words, wc = compact.compact_range(None, None, empty,
                                      torch.zeros(0, dtype=torch.int64), 4096)
    assert words.shape == (0,) and wc.shape == (0,)
    buf, _ = compact.compact_range_flagged(None, None, empty,
                                           torch.zeros(0, dtype=torch.int64), 4096)
    assert compact.host_words(buf).shape == (0,)


def _bad(emitted, fault):
    """A vertical-only range with one fault in block 5 (or, for
    rice_overflow, a RICE range whose bit length passes its rows; for
    src_outside, the last block's source row missing from its group)."""
    L, port, _ = emitted
    coder = _coders("rice_only" if fault == "rice_overflow" else "vertical_only")
    rows_a, rows_b, bit_len = port_groups(port, coder)
    i, SW = 5, sync_words(L)
    sub1 = rows_a[i, 0] & -(1 << 16)  # keep sub 1's half, rewrite sub 0's
    if fault == "width":
        rows_a[i, 0] = sub1 | 40
    elif fault == "exceptions":
        rows_a[i, 0] = sub1 | (17 << 6) | 2
    elif fault == "count":
        bit_len[i] += 32
    elif fault == "rice_overflow":
        bit_len[i] = 32 * (rows_a.shape[1] - SW) + 1
    else:  # src_outside
        rows_a = rows_a[:-1]
    return rows_a, rows_b, torch.from_numpy(coder), bit_len, L


@pytest.mark.parametrize("fault, message", [
    ("width", "sync table does not match"),
    ("exceptions", "sync table does not match"),
    ("count", "sync table does not match"),
    ("rice_overflow", "does not fit its payload rows"),
    ("src_outside", "does not fit its payload rows"),
])
def test_compact_range_rejects_bad_blocks(emitted, fault, message):
    args = _bad(emitted, fault)
    with pytest.raises(ValueError, match=message):
        compact.compact_range(*args)
    with pytest.raises(ValueError, match=message):
        compact.compact_range_flagged(*args)


@pytest.mark.parametrize("flag, message", [
    (0, None), (1, "sync table does not match"),
    (2, "does not fit its payload rows"), (3, "does not fit its payload rows"),
])
def test_host_words_reads_the_flag_word(flag, message):
    buf = torch.tensor([7, -1, flag], dtype=torch.int32)
    if message is None:
        assert compact.host_words(buf).tolist() == [7, 2**32 - 1]
    else:
        with pytest.raises(ValueError, match=message):
            compact.host_words(buf)


def test_vertical_twin_takes_the_reference_count(emitted):
    """ragged.compact_vertical counts SW + bit_len // 32 and raises where
    the sync table's counts disagree."""
    L, port, _ = emitted
    rows, bl = port["vertical"]
    words, wc = ragged.compact_vertical(rows, bl, L)
    assert torch.equal(wc, sync_words(L) + bl // 32)
    assert words.numel() == int(wc.sum())
    with pytest.raises(ValueError, match="sync table does not match"):
        ragged.compact_vertical(rows, bl - 32 * (bl > 0), L)


@pytest.mark.parametrize("chunk_blocks", [None, 3])
def test_cpu_compress_compacts_once_per_range(monkeypatch, chunk_blocks):
    """Each encode range goes through one compact_range_flagged call, and
    the frame holds the range's words as the twin writes them."""
    calls = []
    real = api.compact_range_flagged

    def counting(*args):
        calls.append(args[2].numel())
        return real(*args)

    monkeypatch.setattr(api, "compact_range_flagged", counting)
    streams, ids, cads = synth_corpus(3, 1500, seed=2)
    cfg = CodecConfig(block_len=256, coder="adaptive")
    frame = api.compress(streams, cfg, ids, cads, device="cpu",
                         chunk_blocks=chunk_blocks)
    B = frame.blocks.num_blocks
    assert calls == ([B] if chunk_blocks is None
                     else [min(3, B - a) for a in range(0, B, 3)])
    assert frame.payload_words.size == frame.blocks.word_offsets(256)[-1]
