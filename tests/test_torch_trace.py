"""The port's spans (``dctpu_torch/trace.py``) on the CPU: each step of a
round trip is a ``dctpu.*`` range of ``torch.profiler`` inside its parent,
nothing is opened while no profiler records, ``stage_ms`` keeps its keys,
and tracing changes no byte of a frame."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dctpu_torch import native, trace
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.corpus.synth import synth_corpus
from dctpu_torch.format.frame import BlockHeaders, Frame, StreamDir, read_frame, write_frame

CODERS = ("rice", "vertical", "adaptive")
GROUP = {0: "rice", 1: "vertical"}
# each span of a round trip and the span it lies in (None: none of the
# program's); emit_* and decode_* are added per coder group
ENCODE = {
    "host_build_blocks": None, "range": None, "upload": "range", "select": "range",
    "sync.coders": "range", "compact": "range", "download": "range",
    "sync.words": "download", "sync.choice": "download", "sync.k": "download",
    "sync.bit_len": "download", "host_frame_assembly": None,
    "assembly.columns": "host_frame_assembly",
    "assembly.stream_dir": "host_frame_assembly",
    "write_frame": None, "write_frame.tables": "write_frame",
    "write_frame.payload": "write_frame", "write_frame.crc": "write_frame",
    "crc.parallel": "write_frame.crc",
}
FEED = {"flat": {"feed.gather": "host_build_blocks",
                 "feed.native": "host_build_blocks"},
        "long": {"feed.gather": "host_build_blocks",
                 "feed.native": "host_build_blocks"},
        # one int64 stream, which the flat feed casts to int32
        "flat_cast": {"feed.gather": "host_build_blocks",
                      "feed.cast": "feed.gather",
                      "feed.native": "host_build_blocks"}}
DECODE = {
    "read_frame": None, "read_frame.sections": "read_frame",
    "read_frame.crc": "read_frame", "read_frame.tables": "read_frame",
    "read_frame.payload": "read_frame", "host_block_table": None, "range": None,
    "upload": "range", "reconstruct": "range", "download": "range",
    "download.flat": "download", "sync.download": "download.flat", "host_flatten": None,
    "crc.parallel": "read_frame.crc",
}
# spans that open only for sections of at least two threads' worth of bytes
# (native.frame_threads), which the corpus's frames are not
LARGE_ONLY = {"crc.parallel"}
# the reads of device results of one range on the CPU path: CP's total is
# read on a card only, and K4's flags are checked by the CPU twin itself
CPU_SYNCS = {"encode": 5, "decode": 1}


@functools.lru_cache(maxsize=None)
def _corpus():
    return synth_corpus(4, 3000, seed=11)


@functools.lru_cache(maxsize=None)
def _long_corpus():
    """The corpus's samples repeated into one stream longer than
    _FLAT_PATH_MAX_MEAN_LEN samples."""
    streams, ids, cads = _corpus()
    flat = np.concatenate(streams)
    return ([np.tile(flat, api._FLAT_PATH_MAX_MEAN_LEN // flat.size + 1)],
            ids[:1], cads[:1])


def _cfg(coder):
    return CodecConfig(block_len=256, coder=coder)


def _round_trip(coder, stage_ms=True, chunk_blocks=None, cast=False, long=False):
    """compress -> write_frame -> read_frame -> decompress_flat on the CPU:
    (frame bytes, flat samples, encode stage_ms, decode stage_ms); cast:
    the corpus's second stream given as int64; long: the corpus's streams
    as one stream longer than _FLAT_PATH_MAX_MEAN_LEN samples."""
    streams, ids, cads = _long_corpus() if long else _corpus()
    if cast:
        streams = [streams[0], streams[1].astype(np.int64), *streams[2:]]
    enc, dec = ({}, {}) if stage_ms else (None, None)
    frame = api.compress(streams, _cfg(coder), ids, cads, device="cpu",
                         stage_ms=enc, chunk_blocks=chunk_blocks)
    data = write_frame(frame)
    flat, _ = api.decompress_flat(read_frame(data), device="cpu", stage_ms=dec,
                                  chunk_blocks=chunk_blocks)
    return data, flat, enc, dec


def _traced(coder, **kw):
    """The round trip under the profiler, and its dctpu.* ranges as
    (name without the prefix, start, end), in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _round_trip(coder, **kw)
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(trace.PREFIX):])
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(trace.PREFIX))
    return out, [(n, s, e) for s, e, n in spans]


def _groups(data):
    return sorted({GROUP[int(c)] for c in read_frame(data).blocks.coder_arr()})


def _sides(spans):
    """The spans up to write_frame's end (the encode) and after it."""
    cut = max(e for n, _, e in spans if n == "write_frame")
    return ([sp for sp in spans if sp[1] < cut], [sp for sp in spans if sp[1] >= cut])


@pytest.mark.parametrize("stage_ms", [True, False], ids=["stage_ms", "no_stage_ms"])
@pytest.mark.parametrize("feed", ["flat", "long", "flat_cast"])
@pytest.mark.parametrize("coder", CODERS)
def test_each_step_is_a_span_inside_its_parent(coder, feed, stage_ms):
    (data, _, _, _), spans = _traced(coder, stage_ms=stage_ms,
                                     cast=feed == "flat_cast", long=feed == "long")
    groups = _groups(data)
    want = {"encode": {**ENCODE, **FEED[feed], **{f"emit_{g}": "range" for g in groups}},
            "decode": {**DECODE, **{f"decode_{g}": "range" for g in groups}}}
    if coder == "adaptive":
        assert groups == ["rice", "vertical"]
    for side, got in zip(("encode", "decode"), _sides(spans)):
        names = [n for n, _, _ in got]
        assert set(names) == set(want[side]) - LARGE_ONLY, side
        for name, s, e in got:
            parent = want[side][name]
            if parent is not None:
                assert any(ps <= s and e <= pe for n, ps, pe in got if n == parent), name


@pytest.mark.parametrize("coder", CODERS)
def test_no_range_is_opened_while_no_profiler_records(monkeypatch, coder):
    opened = []

    def counting_range(name):
        opened.append(name)
        return torch._C._profiler._RecordFunctionFast(name)

    monkeypatch.setattr(trace, "_range", counting_range)
    plain = _round_trip(coder, stage_ms=False)
    timed = _round_trip(coder, stage_ms=True)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        _round_trip(coder, stage_ms=False)
    assert "dctpu.write_frame" in opened and "dctpu.sync.download" in opened
    assert plain[0] == timed[0]


@pytest.mark.parametrize("coder", CODERS)
def test_stage_ms_keeps_its_keys(coder):
    streams, ids, cads = _corpus()
    enc, dec, dec_flat = {}, {}, {}
    frame = api.compress(streams, _cfg(coder), ids, cads, device="cpu", stage_ms=enc)
    back = read_frame(write_frame(frame))
    api.decompress(back, device="cpu", stage_ms=dec)
    api.decompress_flat(back, device="cpu", stage_ms=dec_flat)
    groups = _groups(write_frame(frame))
    assert set(enc) == {"host_build_blocks", "upload", "select", "compact", "download",
                        "host_frame_assembly", *(f"emit_{g}" for g in groups)}
    assert set(dec) == {"host_block_table", "upload", "reconstruct", "download",
                        "host_split_streams", *(f"decode_{g}" for g in groups)}
    assert set(dec_flat) == set(dec) - {"host_split_streams"} | {"host_flatten"}
    assert all(v >= 0 for v in [*enc.values(), *dec.values(), *dec_flat.values()])


@pytest.mark.parametrize("coder", CODERS)
def test_tracing_changes_no_byte(coder):
    data, flat, _, _ = _round_trip(coder, stage_ms=False)
    (tdata, tflat, _, _), _ = _traced(coder, stage_ms=True)
    assert tdata == data
    np.testing.assert_array_equal(tflat, flat)
    streams, _, _ = _corpus()
    np.testing.assert_array_equal(flat, np.concatenate(streams))


@pytest.mark.parametrize("chunk_blocks", [None, 16], ids=["one_range", "ranges"])
@pytest.mark.parametrize("coder", CODERS)
def test_sync_spans_count_the_reads_of_each_range(coder, chunk_blocks):
    (data, _, _, _), spans = _traced(coder, chunk_blocks=chunk_blocks)
    ranges = len(api.block_ranges(read_frame(data).blocks.num_blocks, chunk_blocks))
    assert (chunk_blocks is None) == (ranges == 1)
    for side, got in zip(("encode", "decode"), _sides(spans)):
        syncs = [n for n, _, _ in got if n.startswith("sync.")]
        assert len(syncs) == CPU_SYNCS[side] * ranges, (side, syncs)
        opened = [(s, e) for n, s, e in got if n == "range"]
        assert len(opened) == ranges, side
        for s, e in opened:  # each range's reads lie in its span
            assert sum(s <= a and b <= e for n, a, b in got
                       if n.startswith("sync.")) == CPU_SYNCS[side], side


@pytest.mark.parametrize("payload_bytes", [1 << 10, 64 << 20], ids=["1KiB", "64MiB"])
def test_crc_parallel_opens_for_large_sections_only(payload_bytes):
    """A 64 MiB payload's CRC is cut over threads on each side, inside
    write_frame.crc and read_frame.crc; a 1 KiB one's is not, nor are the
    other sections' (a few bytes each)."""
    words = np.random.default_rng(5).integers(0, 2**32, payload_bytes // 4, dtype=np.uint32)
    one = np.ones(1, np.uint64)
    frame = Frame(block_len=128, streams=StreamDir(one, one, one, one, one - 1),
                  blocks=BlockHeaders(*(np.zeros(1, np.uint8),) * 2, np.ones(1, np.uint16),
                                      np.full(1, payload_bytes * 8, np.uint32),
                                      np.zeros(1, np.uint8), np.zeros((1, 4), np.int32)),
                  tables=(), payload_words=words)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        back = read_frame(write_frame(frame))
    np.testing.assert_array_equal(back.payload_words, words)
    spans = [(e.name()[len(trace.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)]
    threaded = payload_bytes >= 64 << 20 and native.host_threads() > 1
    for parent in ("write_frame.crc", "read_frame.crc"):
        inside = [n for n, s, e in spans
                  if any(ps <= s and e <= pe for pn, ps, pe in spans if pn == parent)]
        assert inside.count("crc.parallel") == threaded, parent
    assert sum(n == "crc.parallel" for n, _, _ in spans) == 2 * threaded
