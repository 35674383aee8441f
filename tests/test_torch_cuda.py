"""The CUDA kernels K1-K9, R and VC (and the x forms of K2, K3, K5a and K6, the
words forms of K4 and K5b, and K9's disk-order planes) against their plain
twins, on the card, the launches of the round trips, and the sharded path
over two shards of the card with the device guard of every launch.

Marked ``cuda``: these tests need an NVIDIA GPU (sm_90a, with nvcc) and
skip without one; ``python3 chip_smoke.py`` runs the same comparisons at
the bench geometry. They import no jax, so they also run where jax is
missing, without tests/conftest.py (which imports it):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import scatter_blocks
from dctpu_torch._bits import to_i32
from dctpu_torch.codec import api, encode, predict
from dctpu_torch.config import DEFAULT_LPC_TABLES, CodecConfig, LpcTable
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.dist import compress_sharded, decompress_sharded
from dctpu_torch.format import read_frame, write_frame
from dctpu_torch.kernels import (
    _build,
    exc_extract,
    pack,
    ragged,
    reconstruct,
    rice_totals,
    select_bp,
    select_reduce,
    transpose,
    unpack,
    vdec,
    vemit,
    vertical_cost,
)
from dctpu_torch.kernels.vertical import sub_rows

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
    flat, wc = ragged.compact_vertical(emitted[0], L)
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
    _same(pack.rice_pack_rows(x, h, n, choice, k31, cfg),
          pack.rice_pack_rows_plain(x, h, n, choice, k31, cfg))
    _same((rice_totals.rice_totals(z, n, L, 24),),
          (rice_totals.rice_totals_plain(z, n, L, 24),))
    _same((rice_totals.rice_totals_xbp(x, h, n, L, 24),),
          (rice_totals.rice_totals_xbp_plain(x, h, n, L, 24),))
    for coeffs in [t.coeffs for t in DEFAULT_LPC_TABLES] + [WRAP]:
        _same((rice_totals.rice_totals_lpc(x, h, n, coeffs, L, 24),),
              (rice_totals.rice_totals_lpc_plain(x, h, n, coeffs, L, 24),))
    packed = pack.rice_pack(z, k, n, L)
    _same(packed, pack.rice_pack_plain(z, k, n, L))
    flat = ragged.compact_payload(*packed, L)
    wc = ragged.payload_word_counts(packed[1], L)
    start = torch.cumsum(wc, 0) - wc
    _same((unpack.rice_unpack_words(flat, start, wc, k, n, L),),
          (unpack.rice_unpack_words_plain(flat, start, wc, k, n, L),))


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
        pack.rice_pack_rows(x, h, n, choice, k.cpu(), cfg)
    with pytest.raises(ValueError, match="one device"):
        pack.rice_pack_rows(x, h, n, choice.cpu(), k, cfg)
    with pytest.raises(ValueError, match="one device"):
        vemit.vertical_emit_rows(x, h, n, choice.cpu(), cfg)


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_decode_words_match_twins_on_card(cuda, L):
    """K5b and K4 read the blocks in place from words where they lie in a
    shuffled order between words of no block; a few RICE blocks are cut
    short (one below its sync table); a bad VERTICAL sync entry raises."""
    z, _, _, n, k = (t.to(cuda) for t in _inputs(L, 21))
    payload, bit_len = pack.rice_pack(z, k, n, L)
    flat = ragged.compact_payload(payload, bit_len, L)
    words, start, count = scatter_blocks(
        flat, ragged.payload_word_counts(bit_len, L), seed=L)
    count[0] -= 5
    count[2] //= 2
    count[5] = 0
    _same((unpack.rice_unpack_words(words, start, count, k, n, L),),
          (unpack.rice_unpack_words_plain(words, start, count, k, n, L),))

    rows = vemit.vertical_emit_rows_z(z, n, L)[0]
    words, start, count = scatter_blocks(*ragged.compact_vertical(rows, L),
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
               select_bp.adaptive_totals_lpc, pack.rice_pack_rows, pack.rice_pack)
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
    """R once per decode range (here one), K3's x form and K4 once per
    VERTICAL group, K5a's x form and K5b once per RICE group; the plain
    stages they replace (the winner's residuals of either emission and the
    staging of the decode's rows among them) never run on the card."""
    cfg = CodecConfig(block_len=1000, coder=coder)
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)

    monkeypatch.setattr(encode, "assemble_rows", _refuse)
    monkeypatch.setattr(vemit, "assemble_rows", _refuse)
    monkeypatch.setattr(predict, "reconstruct_lpc", _refuse)
    monkeypatch.setattr(predict, "chosen_residuals", _refuse)
    monkeypatch.setattr(ragged, "stage_vertical", _refuse)
    monkeypatch.setattr(ragged, "pad_payload", _refuse)
    counted = (reconstruct.reconstruct, vemit.vertical_emit_rows,
               vemit.vertical_emit_rows_z, vdec.decode_vertical_words,
               unpack.rice_unpack_words, pack.rice_pack_rows, pack.rice_pack)
    for fn in counted:
        fn.launches = 0
    frame = api.compress(streams, cfg, ids, cads, device=cuda)
    groups = len(set(frame.blocks.coder_arr().tolist()))
    vert = int((frame.blocks.coder_arr() == 1).any())
    out = api.decompress(read_frame(write_frame(frame)), device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
    assert [fn.launches for fn in counted] == [1, vert, 0, vert,
                                               groups - vert, groups - vert, 0]
    assert groups == (2 if coder == "adaptive" else 1)


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
