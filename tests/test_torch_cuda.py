"""The CUDA kernels K1-K9, R, VC and CP (and R's flat form, the x forms of
K2, K3, K5a and K6, the words forms of K4 and K5b, K5a's codes form, K4's
slot form, and K9's disk-order planes) against their plain twins, on the
card, the launches of the round trips and of the block-batch codec, and
the sharded path over two shards of the card with the device guard of
every launch, the bench (``dctpu_torch.bench``) at 256 blocks, and the
program's spans (``dctpu_torch/trace.py``), which add no event on the
device.

Marked ``cuda``: these tests need an NVIDIA GPU (sm_90a, with nvcc) and
skip without one; ``python3 chip_smoke.py`` runs the same comparisons at
the bench geometry. They import no jax, so they also run where jax is
missing, without tests/conftest.py (which imports it):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import json
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import scatter_blocks
from dctpu_torch import bench, kernels, trace
from dctpu_torch._bits import MASK32, to_i32
from dctpu_torch.codec import api, decode, encode, predict, rice
from dctpu_torch.config import DEFAULT_LPC_TABLES, CodecConfig, LpcTable
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.dist import (
    compress_sharded,
    decode_blocks_sharded,
    decompress_sharded,
    encode_blocks_sharded,
)
from dctpu_torch.format import read_frame, write_frame
from dctpu_torch.kernels import (
    _build,
    compact,
    exc_extract,
    ragged,
    reconstruct,
    rice_pack,
    rice_totals,
    rice_unpack,
    select_bp,
    select_reduce,
    transpose,
    vdec,
    vemit,
    vertical_cost,
)
from dctpu_torch.kernels.vertical import parse_sync, sub_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(L, seed, B=40):
    rng = np.random.default_rng(seed)
    z = (rng.geometric(0.03, size=(B, L)) - 1).astype(np.uint32)
    z[0, :29] = 0xFFFFFFFF
    z[1] = 0
    z[4, :16] = (1 << rng.integers(20, 31, size=16)).astype(np.uint32)
    x = rng.integers(-(2**28), 2**28, size=(B, L)).astype(np.int32)
    x[0, :9] = np.int32(-(2**31))
    h = rng.integers(-(2**28), 2**28, size=(B, 4)).astype(np.int32)
    n = np.full(B, L, np.int32)
    n[-1] = max(1, L - 57)
    n[-2] = 0
    n[3] = min(L, 128)
    k = (np.arange(B) % 28).astype(np.int32)
    return (torch.from_numpy(a) for a in (z.view(np.int32), x, h, n, k))


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


# every product is 2**62 on the -2**31 samples of row 0: the int64 sum wraps
WRAP = (-(2**31),) * 4


@pytest.mark.parametrize("L", [4096, 300, 100, 129])
def test_kernels_match_twins_on_card(cuda, L):
    z, x, h, n, _ = (t.to(cuda) for t in _inputs(L, 7))
    _same(select_bp.adaptive_totals_xbp(x, h, n, L, 24),
          select_bp.adaptive_totals_xbp_plain(x, h, n, L, 24))
    _same(select_bp.adaptive_totals_bp(z, n, L, 24),
          select_bp.adaptive_totals_bp_plain(z, n, L, 24))
    for coeffs in [t.coeffs for t in DEFAULT_LPC_TABLES] + [WRAP]:
        _same(select_bp.adaptive_totals_lpc(x, h, n, coeffs, L, 24),
              select_bp.adaptive_totals_lpc_plain(x, h, n, coeffs, L, 24))
    emitted = vemit.vertical_emit_rows_z(z, n, L)
    _same(emitted, vemit.vertical_emit_rows_z_plain(z, n, L))
    flat, wc = ragged.compact_vertical(emitted[0], emitted[1], L)
    start = torch.cumsum(wc, 0) - wc
    _same((vdec.decode_vertical_words(flat, start, wc, n, L),),
          (vdec.decode_vertical_words_plain(flat, start, wc, n, L),))


# every default table and the wrap table
TABLES = [t.coeffs for t in DEFAULT_LPC_TABLES] + [WRAP]


def _refuse(*args, **kwargs):
    raise AssertionError("a plain stage ran on the card")


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_emit_rows_and_reconstruct_match_twins_on_card(cuda, L):
    """K3 in both forms, every candidate chosen (the wrap table too), and R
    on every predictor and table, with histories at the int32 extremes."""
    z, x, h, n, _ = (t.to(cuda) for t in _inputs(L, 17))
    B = x.shape[0]
    h[::5] = torch.tensor([-(2**31), 2**31 - 1, -(2**31), 2**31 - 1],
                          dtype=torch.int32)
    cfg = CodecConfig(block_len=L, coder="vertical", lpc_tables=tuple(
        LpcTable(4, c) for c in TABLES))
    C = len(cfg.candidates())
    choice = (torch.arange(B, device=cuda) % C).to(torch.int32)
    _same(vemit.vertical_emit_rows(x, h, n, choice, cfg),
          vemit.vertical_emit_rows_plain(x, h, n, choice, cfg))
    _same(vemit.vertical_emit_rows_z(z, n, L),
          vemit.vertical_emit_rows_z_plain(z, n, L))
    pred = (torch.arange(B, device=cuda) % 3).to(torch.int32)
    table_idx = (torch.arange(B, device=cuda) % len(TABLES)).to(torch.int32)
    coeffs = torch.tensor(TABLES, dtype=torch.int32, device=cuda)
    got = reconstruct.reconstruct(z, n, pred, table_idx, h, coeffs)
    want = reconstruct.reconstruct_plain(z, n, pred, table_idx, h, coeffs)
    _same((got,), (want,))


@pytest.mark.parametrize("L", [4096, 300, 129, 12000])
def test_reconstruct_range_matches_twin_on_card(cuda, L):
    """R's range form: each block's z row read through its source row from
    one of two coder groups' tensors, in shuffled orders, on every
    predictor and table, against its twin; a single group in reverse order;
    and a group tensor that starts off 16-byte alignment."""
    z, _, h, n, _ = (t.to(cuda) for t in _inputs(L, 27))
    B = z.shape[0]
    h[::5] = torch.tensor([-(2**31), 2**31 - 1, -(2**31), 2**31 - 1],
                          dtype=torch.int32)
    pred = (torch.arange(B, device=cuda) % 3).to(torch.int32)
    table_idx = (torch.arange(B, device=cuda) // 3 % len(TABLES)).to(torch.int32)
    coeffs = torch.tensor(TABLES, dtype=torch.int32, device=cuda)
    first, second, src = chip_smoke.split_groups(z, seed=L)
    args = (n, pred, table_idx, h, coeffs)
    got = reconstruct.reconstruct(first, *args, src=src, z1=second)
    want = reconstruct.reconstruct_range_plain(first, *args, src, second)
    _same((got,), (want,))
    _same((got,), (reconstruct.reconstruct_plain(z, *args),))
    rev = torch.arange(B - 1, -1, -1, dtype=torch.int32, device=cuda)
    _same((reconstruct.reconstruct(z.flip(0).contiguous(), *args, src=rev),),
          (want,))
    shifted = torch.empty(first.numel() + 1, dtype=torch.int32, device=cuda)
    shifted[1:] = first.reshape(-1)
    unaligned = shifted[1:].view(first.shape)  # 4 bytes past the allocation
    _same((reconstruct.reconstruct(unaligned, *args, src=src, z1=second),),
          (want,))


@pytest.mark.parametrize("L", [4096, 300, 129, 128])
def test_reconstruct_flat_matches_twin_on_card(cuda, L):
    """R's flat form: each block's valid samples at its offset, against the
    twin's, through both coder groups; the offsets the prefix sums of n
    with tails of every length mod 4, and the same 1 and 3 samples on, so
    that rows start off 16-byte alignment and end in part of a 16-byte
    group."""
    z, _, h, n, _ = (t.to(cuda) for t in _inputs(L, 37))
    B = z.shape[0]
    n[5::3] = (torch.arange(5, B, 3, device=cuda) * 7 % L).to(torch.int32)
    pred = (torch.arange(B, device=cuda) % 3).to(torch.int32)
    table_idx = (torch.arange(B, device=cuda) // 3 % len(TABLES)).to(torch.int32)
    coeffs = torch.tensor(TABLES, dtype=torch.int32, device=cuda)
    first, second, src = chip_smoke.split_groups(z, seed=L + 1)
    args = (first, n, pred, table_idx, h, coeffs)
    off = torch.cumsum(n.long(), 0) - n.long()
    total = int(n.sum())
    assert bool((off % 4 != 0).any()) and bool((n % 4 != 0).any())
    padded = reconstruct.reconstruct_range_plain(*args, src, second)
    reconstruct.reconstruct.flat_launches = 0
    for shift in (0, 1, 3):
        got = reconstruct.reconstruct(*args, src=src, z1=second,
                                      out_off=off + shift, out_len=total + shift)
        want = reconstruct.flat_plain(padded, n, off + shift, total + shift)
        assert got.shape == (total + shift,)
        _same((got[shift:],), (want[shift:],))  # the first `shift` are no block's
    assert reconstruct.reconstruct.flat_launches == 3


def test_decompress_flat_downloads_the_valid_samples_on_card(cuda, monkeypatch):
    """A headend-shaped decompress_flat (meter-days of 96 reads at L=128)
    in three ranges: each range's R writes only its valid samples, flat,
    on the card, the host downloads exactly those (Σn samples in all,
    none of the blocks' padding), with one sync.download a range."""
    streams, ids, cads = synth_corpus(3000, 96, seed=29, cumulative_frac=0.25)
    data = write_frame(api.compress(streams, CodecConfig(block_len=128,
                                                          coder="adaptive"),
                                    ids, cads, device=cuda))
    frame = read_frame(data)
    seen = []
    inner = api.decode_flat

    def watched(*args, **kwargs):
        soff, ranges = inner(*args, **kwargs)

        def each():
            for x, s0, s1, stage in ranges:
                seen.append((x.device.type, x.numel(), s1 - s0))
                yield x, s0, s1, stage
        return soff, each()

    monkeypatch.setattr(api, "decode_flat", watched)

    def decode_():
        return api.decompress_flat(frame, device=cuda, chunk_blocks=1000,
                                   stage_ms={})

    decode_()  # warm-up
    seen.clear()
    reconstruct.reconstruct.flat_launches = 0
    (flat, lens), _, syncs = _profiled(decode_)
    np.testing.assert_array_equal(flat, np.concatenate(streams))
    assert lens.tolist() == [96] * 3000
    assert [(d, m) for d, m, _ in seen] == [("cuda", m) for _, _, m in seen]
    assert sum(m for _, m, _ in seen) == flat.size == 3000 * 96
    assert len(seen) == 3 == reconstruct.reconstruct.flat_launches
    assert syncs.count(trace.PREFIX + "sync.download") == 3


def test_recon_kernel_is_classified_on_card(cuda):
    """The profiler's name of R, in either form, is one that the
    benchmark's kernel table classifies as R over all blocks."""
    from portbench import work

    z, _, h, n, _ = (t.to(cuda) for t in _inputs(300, 41))
    B = z.shape[0]
    pred = (torch.arange(B, device=cuda) % 3).to(torch.int32)
    table_idx = torch.zeros(B, dtype=torch.int32, device=cuda)
    coeffs = torch.tensor(TABLES, dtype=torch.int32, device=cuda)
    off = torch.cumsum(n.long(), 0) - n.long()

    def both():
        reconstruct.reconstruct(z, n, pred, table_idx, h, coeffs)
        reconstruct.reconstruct(z, n, pred, table_idx, h, coeffs,
                                out_off=off, out_len=int(n.sum()))

    both()
    _, device, _ = _profiled(both)
    names = [name for name in device if "recon_kernel" in name]
    assert names and sum(device[name] for name in names) == 2
    assert all(work.classify(name) == ("R", "all") for name in names)


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_rice_kernels_match_twins_on_card(cuda, L):
    """K6 (its three forms), K5a (both forms: the x form with every
    candidate chosen, the wrap table too, at every k in 0..30) and K5b;
    12000 takes K5a's device-memory row path."""
    z, x, h, n, k = (t.to(cuda) for t in _inputs(L, 9))
    B = x.shape[0]
    h[::5] = torch.tensor([-(2**31), 2**31 - 1, -(2**31), 2**31 - 1],
                          dtype=torch.int32)
    cfg = CodecConfig(block_len=L, lpc_tables=tuple(LpcTable(4, c) for c in TABLES))
    blocks = torch.arange(B, device=cuda)
    choice = (blocks % len(cfg.candidates())).to(torch.int32)
    k31 = (blocks % 31).to(torch.int32)
    _same(rice_pack.rice_pack_rows(x, h, n, choice, k31, cfg),
          rice_pack.rice_pack_rows_plain(x, h, n, choice, k31, cfg))
    _same((rice_totals.rice_totals(z, n, L, 24),),
          (rice_totals.rice_totals_plain(z, n, L, 24),))
    _same((rice_totals.rice_totals_xbp(x, h, n, L, 24),),
          (rice_totals.rice_totals_xbp_plain(x, h, n, L, 24),))
    for coeffs in [t.coeffs for t in DEFAULT_LPC_TABLES] + [WRAP]:
        _same((rice_totals.rice_totals_lpc(x, h, n, coeffs, L, 24),),
              (rice_totals.rice_totals_lpc_plain(x, h, n, coeffs, L, 24),))
    packed = rice_pack.rice_pack(z, k, n, L)
    _same(packed, rice_pack.rice_pack_plain(z, k, n, L))
    flat = ragged.compact_payload(*packed, L)
    wc = ragged.payload_word_counts(packed[1], L)
    start = torch.cumsum(wc, 0) - wc
    _same((rice_unpack.rice_unpack_words(flat, start, wc, k, n, L),),
          (rice_unpack.rice_unpack_words_plain(flat, start, wc, k, n, L),))


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_vertical_cost_matches_twins_on_card(cuda, L):
    """VC's two forms, with histories at the int32 extremes, every default
    table and the wrap table."""
    _, x, h, n, _ = (t.to(cuda) for t in _inputs(L, 13))
    h[::5] = torch.tensor([-(2**31), 2**31 - 1, -(2**31), 2**31 - 1],
                          dtype=torch.int32)
    _same((vertical_cost.vertical_cost_xbp(x, h, n, L),),
          (vertical_cost.vertical_cost_xbp_plain(x, h, n, L),))
    for coeffs in TABLES:
        _same((vertical_cost.vertical_cost_lpc(x, h, n, coeffs, L),),
              (vertical_cost.vertical_cost_lpc_plain(x, h, n, coeffs, L),))


def test_emit_rows_refuse_host_arguments_on_card(cuda):
    """The x-form emissions refuse a per-block argument left on the host
    rather than hand its pointer to the kernel."""
    _, x, h, n, k = (t.to(cuda) for t in _inputs(300, 5))
    cfg = CodecConfig(block_len=300)
    choice = torch.zeros(x.shape[0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        rice_pack.rice_pack_rows(x, h, n, choice, k.cpu(), cfg)
    with pytest.raises(ValueError, match="one device"):
        rice_pack.rice_pack_rows(x, h, n, choice.cpu(), k, cfg)
    with pytest.raises(ValueError, match="one device"):
        vemit.vertical_emit_rows(x, h, n, choice.cpu(), cfg)


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_decode_words_match_twins_on_card(cuda, L):
    """K5b and K4 read the blocks in place from words where they lie in a
    shuffled order between words of no block; a few RICE blocks are cut
    short (one below its sync table); a bad VERTICAL sync entry raises."""
    z, _, _, n, k = (t.to(cuda) for t in _inputs(L, 21))
    payload, bit_len = rice_pack.rice_pack(z, k, n, L)
    flat = ragged.compact_payload(payload, bit_len, L)
    words, start, count = scatter_blocks(
        flat, ragged.payload_word_counts(bit_len, L), seed=L)
    count[0] -= 5
    count[2] //= 2
    count[5] = 0
    _same((rice_unpack.rice_unpack_words(words, start, count, k, n, L),),
          (rice_unpack.rice_unpack_words_plain(words, start, count, k, n, L),))

    rows, vbits = vemit.vertical_emit_rows_z(z, n, L)
    words, start, count = scatter_blocks(*ragged.compact_vertical(rows, vbits, L),
                                         seed=L + 1)
    _same((vdec.decode_vertical_words(words, start, count, n, L),),
          (vdec.decode_vertical_words_plain(words, start, count, n, L),))
    words[start[3]] = (words[start[3]] & -(1 << 16)) | 40  # sub 0: b = 40
    with pytest.raises(ValueError, match="sync table does not match"):
        vdec.decode_vertical_words(words, start, count, n, L)


def test_rice_select_launches_x_forms_on_card(cuda):
    """The rice selection launches K6's DELTA + DOUBLE_DELTA form once, its
    LPC form once per LPC candidate and its z form never, and selects as
    the twins do on the CPU."""
    cfg = CodecConfig()
    streams, _, _ = synth_corpus(4, 9000, seed=3, cumulative_frac=0.5)
    t = [torch.from_numpy(a) for a in api.build_blocks(streams, cfg.block_len)[:3]]
    counted = (rice_totals.rice_totals, rice_totals.rice_totals_xbp,
               rice_totals.rice_totals_lpc)
    for fn in counted:
        fn.launches = 0
    got = encode.select_blocks(*(a.to(cuda) for a in t), cfg)
    assert [fn.launches for fn in counted] == [0, 1, len(cfg.candidates()) - 2]
    _same(got, encode.select_blocks(*t, cfg))


def test_vertical_select_launches_vc_on_card(cuda):
    """The vertical selection launches VC's DELTA + DOUBLE_DELTA form once
    and its LPC form once per LPC candidate, and selects as the twins do
    on the CPU."""
    cfg = CodecConfig(coder="vertical")
    streams, _, _ = synth_corpus(4, 9000, seed=3, cumulative_frac=0.5)
    t = [torch.from_numpy(a) for a in api.build_blocks(streams, cfg.block_len)[:3]]
    counted = (vertical_cost.vertical_cost_xbp, vertical_cost.vertical_cost_lpc)
    for fn in counted:
        fn.launches = 0
    got = encode.select_blocks(*(a.to(cuda) for a in t), cfg)
    assert [fn.launches for fn in counted] == [1, len(cfg.candidates()) - 2]
    _same(got, encode.select_blocks(*t, cfg))


CONFIGS = {
    "default": CodecConfig(coder="adaptive"),
    "L1000": CodecConfig(block_len=1000, coder="adaptive"),
    "L100_k27": CodecConfig(block_len=100, k_max=27, coder="adaptive"),
    "odd_tables": CodecConfig(
        block_len=384, predictors=(0, 2), coder="adaptive",
        lpc_tables=(
            LpcTable(1, (65536, 0, 0, 0)),
            LpcTable(4, (2**31 - 1, -(2**31), 2**30, -5)),
        ),
    ),
    "rice": CodecConfig(),
    "rice_L300_delta": CodecConfig(block_len=300, predictors=(0,), coder="rice"),
    "vertical": CodecConfig(coder="vertical"),
    "vertical_L1000": CodecConfig(block_len=1000, coder="vertical"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_card_frames_equal_cpu_frames(cuda, name):
    cfg = CONFIGS[name]
    rng = np.random.default_rng(11)
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)
    streams += [
        rng.integers(-(2**31), 2**31, size=700, dtype=np.int64).astype(np.int32),
        np.zeros(0, np.int32),
    ]
    ids, cads = ids + [4, 5], cads + [900, 900]
    on_card = write_frame(api.compress(streams, cfg, ids, cads, device=cuda))
    assert on_card == write_frame(api.compress(streams, cfg, ids, cads, device="cpu"))
    out = api.decompress(read_frame(on_card), device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))


@pytest.mark.parametrize("L", [4096, 300, 100, 129])
def test_backend_kernels_match_twins_on_card(cuda, L):
    """K7, K8 (at the width rule's b and at b = 0 and 32) and K9."""
    z, _, _, n, _ = (t.to(cuda) for t in _inputs(L, 13))
    _same(select_reduce.adaptive_totals_reduce(z, n, L, 24),
          select_reduce.adaptive_totals_reduce_plain(z, n, L, 24))
    B = z.shape[0]
    zs = to_i32(sub_rows(z, n, L)).reshape(B, -1, 128)
    b = vemit.vertical_emit(z, n, L)[1].clone()
    b[0], b[1] = 0, 32
    _same(exc_extract.exc_extract(zs, b), exc_extract.exc_extract_plain(zs, b))
    rows = zs.reshape(-1, 128)
    _same((transpose.bit_planes32(rows),), (transpose.bit_planes32_plain(rows),))
    flat = rows.reshape(-1)  # rows 4 bytes off a 16-byte boundary
    off = flat[1:1 + flat.numel() - 128].reshape(-1, 128)
    _same((transpose.bit_planes32(off),), (transpose.bit_planes32_plain(off),))


def test_backend_paths_on_card(cuda):
    """backend="pallas" and "xla" run K9 and K8 instead of K3, the other
    kernels as by default (never a plain twin on the card, and no flip in
    the staged emission), and give the default frame; backend="reduce"
    selects with K7 alone and raises at the RICE group, as the reference
    does."""
    cfg = CodecConfig(block_len=1000, coder="adaptive")
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)
    want = write_frame(api.compress(streams, cfg, ids, cads, device=cuda))
    assert set(read_frame(want).blocks.coder_arr().tolist()) == {0, 1}
    counted = (vemit.vertical_emit_rows, exc_extract.exc_extract,
               transpose.bit_planes32, select_bp.adaptive_totals_xbp,
               select_bp.adaptive_totals_lpc, rice_pack.rice_pack_rows, rice_pack.rice_pack)
    staged = encode._emit_staged

    def staged_without_flip(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "flip", _refuse)
            mp.setattr(torch, "flip", _refuse)
            return staged(*args)

    for backend in ("pallas", "xla"):
        for fn in counted:
            fn.launches = 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(encode, "_emit_staged", staged_without_flip)
            got = write_frame(api.compress(streams, cfg, ids, cads, device=cuda,
                                           backend=backend))
        assert got == want
        assert [fn.launches for fn in counted] == [
            0, 1, 1, 1, len(cfg.candidates()) - 2, 1, 0]
        out = api.decompress(read_frame(got), device=cuda)
        assert all(np.array_equal(a, b) for a, b in zip(streams, out))

    x, n, h, _, _ = api.build_blocks(streams, cfg.block_len)
    t = [torch.from_numpy(a).to(cuda) for a in (x, n, h)]
    auto = encode.adaptive_select(*t, cfg)
    for fn in (select_bp.adaptive_totals_xbp, select_bp.adaptive_totals_bp,
               select_bp.adaptive_totals_lpc, select_reduce.adaptive_totals_reduce):
        fn.launches = 0
    _same(encode.adaptive_select(*t, cfg, backend="reduce"), auto)
    assert select_reduce.adaptive_totals_reduce.launches == len(cfg.candidates())
    assert select_bp.adaptive_totals_xbp.launches == 0
    assert select_bp.adaptive_totals_bp.launches == 0
    assert select_bp.adaptive_totals_lpc.launches == 0
    with pytest.raises(ValueError, match="unknown kernel backend"):
        api.compress(streams, cfg, ids, cads, device=cuda, backend="reduce")


@pytest.mark.parametrize("coder", ["adaptive", "rice", "vertical"])
def test_round_trip_launches_on_card(cuda, coder, monkeypatch):
    """R and CP (its count pass and its copy) once per decode and encode
    range (here one), K3's x form
    and K4 once per VERTICAL group, K5a's x form and K5b once per RICE
    group; the plain stages they replace (the winner's residuals of either
    emission, the staging of the decode's rows and the segment copies of
    the compaction among them) never run on the card."""
    cfg = CodecConfig(block_len=1000, coder=coder)
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)

    monkeypatch.setattr(encode, "assemble_rows", _refuse)
    monkeypatch.setattr(vemit, "assemble_rows", _refuse)
    monkeypatch.setattr(predict, "reconstruct_lpc", _refuse)
    monkeypatch.setattr(predict, "chosen_residuals", _refuse)
    monkeypatch.setattr(ragged, "stage_vertical", _refuse)
    monkeypatch.setattr(ragged, "pad_payload", _refuse)
    monkeypatch.setattr(ragged, "segment_index", _refuse)
    counted = (reconstruct.reconstruct, vemit.vertical_emit_rows,
               vemit.vertical_emit_rows_z, vdec.decode_vertical_words,
               rice_unpack.rice_unpack_words, rice_pack.rice_pack_rows, rice_pack.rice_pack,
               compact.compact_range, compact.count_range)
    for fn in counted:
        fn.launches = 0
    frame = api.compress(streams, cfg, ids, cads, device=cuda)
    groups = len(set(frame.blocks.coder_arr().tolist()))
    vert = int((frame.blocks.coder_arr() == 1).any())
    out = api.decompress(read_frame(write_frame(frame)), device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
    assert [fn.launches for fn in counted] == [1, vert, 0, vert,
                                               groups - vert, groups - vert, 0, 1,
                                               1]
    assert groups == (2 if coder == "adaptive" else 1)


def _profiled(fn):
    """fn() under the profiler (CPU and CUDA): (its result, the CUDA-typed
    events by name, the program's dctpu.sync.* spans)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    device, syncs = Counter(), []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            device[e.name()] += 1
        elif e.name().startswith(trace.PREFIX + "sync."):
            syncs.append(e.name())
    return out, device, syncs


@pytest.mark.parametrize("coder", ["adaptive", "rice", "vertical"])
def test_spans_add_no_device_event_on_card(cuda, coder, monkeypatch):
    """A traced headend-shaped round trip (meter-days of 96 reads at
    L=128, decompress_flat) gives the device the same events, by name and
    count, with the program's spans on and off; the spans' reads are the
    card path's: 6 an encode range (the coders, CP's total, the words,
    choice, k, bit_len), 1 or 2 a decode range (K4's flags when a
    VERTICAL block is there, the samples), each one copy to the host."""
    streams, ids, cads = synth_corpus(2000, 96, seed=23, cumulative_frac=0.25)
    cfg = CodecConfig(block_len=128, coder=coder)

    def encode_():
        return write_frame(api.compress(streams, cfg, ids, cads, device=cuda,
                                        stage_ms={}))

    data = encode_()  # warm-up of both halves

    def decode_():
        return api.decompress_flat(read_frame(data), device=cuda, stage_ms={})

    decode_()
    vert = int((read_frame(data).blocks.coder_arr() == 1).any())
    seen = {}
    for on in (True, False):
        if not on:
            monkeypatch.setattr(trace, "recording", lambda: False)
        got, enc_dev, enc_syncs = _profiled(encode_)
        (flat, _), dec_dev, dec_syncs = _profiled(decode_)
        assert got == data
        np.testing.assert_array_equal(flat, np.concatenate(streams))
        seen[on] = (enc_dev, dec_dev, len(enc_syncs), len(dec_syncs))
    assert seen[True][:2] == seen[False][:2]
    assert seen[False][2:] == (0, 0)
    enc_dev, dec_dev, n_enc, n_dec = seen[True]
    assert not any(name.startswith(trace.PREFIX) for name in enc_dev + dec_dev)
    assert (n_enc, n_dec) == (6, 1 + vert)
    assert vert == (coder != "rice")
    to_host = [sum(v for k, v in dev.items() if k.startswith("Memcpy DtoH"))
               for dev in (enc_dev, dec_dev)]
    assert to_host == [n_enc, n_dec]


@pytest.mark.parametrize("B, L", [
    (256, 200), (32, 12000),
    (64, 128),   # one slot
    (64, 4096),  # 32 slots: one pass of the warp's lanes
    (48, 4100),  # 33 slots: a second pass, with the first's carry
    (6, 65536),  # 512 slots: 16 passes
    (0, 4096),   # no blocks
])
def test_compact_range_matches_twin_on_card(cuda, B, L):
    """CP and its count pass equal their twins, each launched once a call,
    on blocks of both coders, each group's rows in block order (RICE rows
    from K5a's z form first, VERTICAL rows from K3's z form second; block
    1, all zeros, is a VERTICAL block whose slots are all empty); CP
    raises the twin's ValueError for a bad VERTICAL sync entry."""
    if B == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=cuda)
        args = (None, None, empty,
                torch.zeros(0, dtype=torch.int64, device=cuda), L)
    else:
        z, _, _, n, k = (t.to(cuda) for t in _inputs(L, 31, B=B))
        rice, vert = rice_pack.rice_pack(z, k, n, L), vemit.vertical_emit_rows_z(z, n, L)
        args = (*chip_smoke.compact_groups(*rice, *vert, seed=L), L)
    coder, bit_len = args[2:4]
    compact.count_range.launches = compact.compact_range.launches = 0
    _same(compact.count_range(coder, bit_len, L),
          compact.count_range_plain(coder, bit_len, L))
    _same(compact.compact_range(*args), compact.compact_range_plain(*args))
    assert (compact.count_range.launches, compact.compact_range.launches) == (2, 1)
    if B == 0:
        return
    rows_b = args[1]
    rows_b[0, 0] = (rows_b[0, 0] & -(1 << 16)) | 40  # sub 0: b = 40
    with pytest.raises(ValueError, match="sync table does not match"):
        compact.compact_range(*args)
    with pytest.raises(ValueError, match="sync table does not match"):
        compact.compact_range_plain(*args)


@pytest.mark.parametrize("B, vertical_share", [
    (1, 0.5), (1000, 0.5), (70001, 0.8), (5000, 1.0), (5000, 0.0),
])
def test_count_range_matches_twin_on_card(cuda, B, vertical_share):
    """CP's count pass equals its twin over runs of many 32-block steps a
    warp, with one coder group only and with both."""
    rng = np.random.default_rng(B)
    coder = torch.from_numpy(
        (rng.random(B) < vertical_share).astype(np.int32)).to(cuda)
    bit_len = torch.from_numpy(rng.integers(0, 5000, size=B)).to(cuda)
    compact.count_range.launches = 0
    _same(compact.count_range(coder, bit_len, 4096),
          compact.count_range_plain(coder, bit_len, 4096))
    assert compact.count_range.launches == 1


@pytest.mark.parametrize("coder, backend, chunk_blocks", [
    ("adaptive", None, None), ("vertical", "pallas", None), ("rice", None, 7),
])
def test_card_compress_runs_no_segment_copies(cuda, monkeypatch, coder,
                                              backend, chunk_blocks):
    """A card compress compacts each encode range with one launch of CP's
    count pass and one of its copy, and calls no ragged.segment_index, copy_segments or repeat_interleave; its
    frame is the CPU's."""
    cfg = CodecConfig(block_len=1000, coder=coder)
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)
    want = write_frame(api.compress(streams, cfg, ids, cads, device="cpu"))
    monkeypatch.setattr(ragged, "segment_index", _refuse)
    monkeypatch.setattr(ragged, "copy_segments", _refuse)
    monkeypatch.setattr(torch, "repeat_interleave", _refuse)
    compact.count_range.launches = compact.compact_range.launches = 0
    frame = api.compress(streams, cfg, ids, cads, device=cuda, backend=backend,
                         chunk_blocks=chunk_blocks)
    B = frame.blocks.num_blocks
    assert write_frame(frame) == want
    ranges = len(api.block_ranges(B, chunk_blocks))
    assert compact.count_range.launches == compact.compact_range.launches == ranges


def test_sharded_two_shards_on_card(cuda):
    """The adaptive coder over [cuda:0, cuda:0] in two chunks of 128 blocks
    at 256 x 4096: the default frame, a bit-exact round trip, and every
    kernel of the default path once per shard, chunk and coder group."""
    cfg = CodecConfig(coder="adaptive")
    streams, ids, cads = synth_corpus(4, 256 * 4096 // 4, seed=3,
                                      mixed_cadence=True, cumulative_frac=0.5)
    want = write_frame(api.compress(streams, cfg, ids, cads, device=cuda))
    mesh = [torch.device("cuda", 0)] * 2
    chip_smoke.reset_counters()
    frame = compress_sharded(streams, cfg, mesh, ids, cads, chunk_blocks=128)
    out = decompress_sharded(read_frame(want), mesh, chunk_blocks=128)
    launches = chip_smoke.read_counters()
    assert write_frame(frame) == want
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
    coders = frame.blocks.coder_arr()
    assert set(coders.tolist()) == {0, 1}
    ranges = [(a, b) for c0, c1 in api.block_ranges(coders.size, 128)
              for _, a, b in api.shard_ranges(c0, c1, 2)]
    assert len(ranges) == 4
    assert launches == chip_smoke.range_launches(
        "adaptive", coders, ranges, len(cfg.candidates()) - 2)


def test_default_pass_splits_by_device_memory_on_card(cuda, monkeypatch):
    """With the card's memory taken as small, the default pass (chunk_blocks
    None) cuts a 1000-block input into at least 3 ranges: one R per
    decode range, and the frame and the decode equal the one-pass ones."""
    cfg = CodecConfig(block_len=128, coder="adaptive")
    streams, ids, cads = synth_corpus(5, 1000 * 128 // 5, seed=4,
                                      mixed_cadence=True, cumulative_frac=0.5)
    one = write_frame(api.compress(streams, cfg, ids, cads, device=cuda,
                                   chunk_blocks=10**6))
    assert read_frame(one).blocks.num_blocks == 1000
    per_block = api.DEVICE_SHARE * api.DEVICE_BYTES_PER_SAMPLE * 128
    monkeypatch.setattr(api, "device_memory", lambda devices: 300 * per_block)
    assert api.range_blocks(None, api.device_memory([cuda]), 128) == 300
    chip_smoke.reset_counters()
    frame = write_frame(api.compress(streams, cfg, ids, cads, device=cuda))
    out = api.decompress(read_frame(frame), device=cuda)
    launches = chip_smoke.read_counters()
    assert frame == one
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
    assert launches["R"] == 4 and launches["K1"] == 4


def test_sharded_decode_raises_for_a_bad_vertical_block_on_card(cuda):
    """The sharded decode reads K4's flags only after every shard of a
    chunk is launched, and still raises the twin's ValueError for a
    VERTICAL block whose sync table is bad, in either shard."""
    cfg = CodecConfig(block_len=1000, coder="adaptive")
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)
    data = write_frame(api.compress(streams, cfg, ids, cads, device=cuda))
    mesh = [torch.device("cuda", 0)] * 2
    coders = read_frame(data).blocks.coder_arr()
    vert = np.nonzero(coders == 1)[0]
    for b in (vert[0], vert[-1]):
        frame = read_frame(data)
        w = frame.blocks.word_offsets(cfg.block_len)[b]
        frame.payload_words[w] = (frame.payload_words[w] & 0xFFFF0000) | 40
        with pytest.raises(ValueError, match="sync table does not match"):
            decompress_sharded(frame, mesh, chunk_blocks=coders.size)
        with pytest.raises(ValueError, match="sync table does not match"):
            api.decompress(frame, device=cuda)


def test_every_launch_runs_under_its_device(cuda, monkeypatch):
    """Each kernel launch of a round trip goes through _build.launch, which
    sets the launching tensor's device: one entry made by _build.launch
    for each launch the wrappers count."""
    entered = []
    real = torch.cuda.device

    class Recording(real):
        def __init__(self, device):
            if sys._getframe(1).f_code is _build.launch.__code__:
                entered.append(torch.device(device))
            super().__init__(device)

    monkeypatch.setattr(torch.cuda, "device", Recording)
    wrappers = {fn for fns in chip_smoke.counters().values() for fn in fns}
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)
    for coder, backend in (("adaptive", None), ("rice", None),
                           ("vertical", "pallas")):
        cfg = CodecConfig(block_len=1000, coder=coder)
        chip_smoke.reset_counters()
        entered.clear()
        frame = api.compress(streams, cfg, ids, cads, device=cuda, backend=backend)
        api.decompress(read_frame(write_frame(frame)), device=cuda)
        total = sum(fn.launches for fn in wrappers)
        assert total > 0
        assert len(entered) == total
        assert all(d.type == "cuda" and d.index == torch.cuda.current_device()
                   for d in entered)


def test_bench_on_card(cuda, tmp_path):
    """The bench (dctpu_torch.bench) at 256 blocks x 4096 on the card: exit
    0, every coder bit-exact, and every device stage it reports above 0 ms,
    with the peak device bytes measured."""
    out = tmp_path / "bench.json"
    rc = bench.main(["--streams", "4", "--samples", str(64 * 4096),
                     "--block-len", "4096", "--repeats", "2", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["device"]["platform"] == "gpu" and res["blocks"] == 256
    sums = {"enc_device_ms", "dec_device_ms", "enc_host_ms", "dec_host_ms"}
    for coder in bench.CODERS:
        r = res[coder]
        assert r["bit_exact"] is True
        stages = [k for k in r if k.endswith("_ms") and k not in sums
                  and not k.startswith(("host_", "e2e_"))]
        assert {"select_ms", "compact_ms", "reconstruct_ms", "enc_upload_ms",
                "dec_download_ms"} <= set(stages)
        assert all(r[k] > 0 for k in stages), {k: r[k] for k in stages}
        assert r["enc_peak_bytes_per_byte"] > 0 and r["dec_peak_bytes_per_byte"] > 0


def _codes(z, k, valid):
    """rice.codewords of z at k as (code_lo, code_hi, length, valid), with
    samples left out inside the blocks as well as past their ends."""
    code, length = rice.codewords(z, k.to(torch.int64)[:, None])
    return (to_i32(code & MASK32), to_i32(code >> 32), length.to(torch.int32),
            valid)


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_pack_codes_matches_twin_on_card(cuda, L):
    """K5a's codes form equals its twin, with holes in the validity mask;
    kernels.pack launches it once and equals pack_xla."""
    z, _, _, n, _ = (t.to(cuda) for t in _inputs(L, 31))
    k = (torch.arange(z.shape[0], device=cuda) % 31).to(torch.int32)
    valid = torch.arange(L, device=cuda)[None, :] < n[:, None]
    valid[5, ::3] = False
    args = _codes(z, k, valid)
    _same(rice_pack.rice_pack_codes(*args, L),
          rice_pack.rice_pack_codes_plain(*args, L))
    rice_pack.rice_pack_codes.launches = 0
    got = kernels.pack(*args, L)
    assert rice_pack.rice_pack_codes.launches == 1
    _same(got, kernels.pack_xla(*args, L))


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_vdec_slots_matches_twin_on_card(cuda, L):
    """K4's slot form on payload rows (two words of junk past each row)
    equals its twin; a malformed sync entry and a width above max_planes
    raise ValueError."""
    z, _, _, n, _ = (t.to(cuda) for t in _inputs(L, 33))
    rows, _ = vemit.vertical_emit_rows_z(z, n, L)
    junk = torch.full((rows.shape[0], 2), -1, dtype=torch.int32, device=cuda)
    rows = torch.cat([rows, junk], 1)
    _same((vdec.decode_vertical_slots(rows, n, L),),
          (vdec.decode_vertical_slots_plain(rows, n, L),))
    S = -(-L // 128)
    widest = int(parse_sync(rows[:, :(S + 1) // 2], S)[0].max())
    if widest > 0:
        with pytest.raises(ValueError, match="max_planes"):
            vdec.decode_vertical_slots(rows, n, L, max_planes=widest - 1)
    rows[3, 0] = (rows[3, 0] & -(1 << 16)) | 40  # sub 0: b = 40
    with pytest.raises(ValueError, match="sync table does not match"):
        vdec.decode_vertical_slots(rows, n, L)


def test_block_api_on_card(cuda, monkeypatch):
    """encode_blocks -> decode_blocks for rice and vertical round trips on
    the card and equals the CPU; decode_blocks launches K5b or K4's slot
    form once, then R once; pack -> unpack round trips; the sharded block
    functions over two shards of the card equal one device; no plain
    stage runs on the card."""
    L = 4096
    streams, _, _ = synth_corpus(3, 5 * L + 77, seed=8, cumulative_frac=0.5)
    x, n, h = (torch.from_numpy(a) for a in api.build_blocks(streams, L)[:3])
    tables = [t.coeffs for t in DEFAULT_LPC_TABLES]
    cfgs = {c: CodecConfig(block_len=L, coder=c) for c in ("rice", "vertical")}
    cpu = {c: encode.encode_blocks(x, n, h, cfg) for c, cfg in cfgs.items()}
    for mod, name in ((vdec, "decode_vertical_plain"),
                      (vdec, "decode_vertical_slots_plain"),
                      (rice_unpack, "rice_unpack_words_plain"),
                      (rice_pack, "rice_pack_codes_plain"),
                      (reconstruct, "reconstruct_plain"),
                      (predict, "reconstruct_lpc"), (predict, "chosen_residuals"),
                      (ragged, "pad_payload"), (ragged, "stage_vertical")):
        monkeypatch.setattr(mod, name, _refuse)
    for coder, cfg in cfgs.items():
        enc = encode.encode_blocks(*(t.to(cuda) for t in (x, n, h)), cfg)
        _same(enc, cpu[coder])
        args = (enc.k, n.to(cuda), enc.predictor, enc.table_idx, h.to(cuda),
                tables, L, True)
        counted = (rice_unpack.rice_unpack_words, vdec.decode_vertical_slots,
                   reconstruct.reconstruct)
        for fn in counted:
            fn.launches = 0
        out = decode.decode_blocks(enc.payload, *args, coder=coder)
        vert = int(coder == "vertical")
        assert [fn.launches for fn in counted] == [1 - vert, vert, 1]
        valid = torch.arange(L)[None, :] < n[:, None]
        assert torch.equal(out.cpu(), torch.where(valid, x, 0))
        mesh = [cuda, cuda]
        _same(encode_blocks_sharded(*(t.to(cuda) for t in (x, n, h)), cfg, mesh),
              enc)
        assert torch.equal(
            decode_blocks_sharded(enc.payload, *args[:-2], L, True, mesh,
                                  coder=coder), out)
    z = to_i32(rice.zigzag(x.to(cuda)))
    k = (torch.arange(z.shape[0], device=cuda) % 31).to(torch.int32)
    valid = torch.arange(L, device=cuda)[None, :] < n.to(cuda)[:, None]
    payload, _ = kernels.pack(*_codes(z, k, valid), L)
    rows = torch.cat([payload, torch.zeros((payload.shape[0], 2), dtype=torch.int32,
                                           device=cuda)], 1)
    got = kernels.unpack(rows, k, n.to(cuda), L)
    assert torch.equal(got, torch.where(valid, z, 0))
