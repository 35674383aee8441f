"""The port on the shapes of the Low Carbon London archive (portbench's
``lcl-30min-bulk`` configuration, ``lcl.bulk`` cell), on the CPU:
households short enough for ``decompress``'s flat path (one download into
one array, then a copy of each household out of it), cut into two ranges
of blocks with one household across the boundary, as the whole trial is
on an 80 GB card. The frame is held byte for byte to the benchmark's
plain reference with one range and with two, and ``decompress`` gives
each household back. Then the readers of the cell's new metrics
(``ranges_per_call.*``, ``split_copies_ms``) on hand-made traces, and
the cell's entries in ``BENCHMARK.json``."""

import functools
import types

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from dctpu_torch import trace
from dctpu_torch.codec import api
from dctpu_torch.format.frame import read_frame, write_frame
from portbench import check, loop, program, registry
from portbench import trace as pb_trace

CELL, CONFIG = "lcl.bulk", "lcl-30min-bulk"
# 3 blocks of 4096 a household, the last an 808-sample tail: a mean far
# under the decode's switch, 131,072
HOUSES, SAMPLES, BLOCKS = 24, 9000, 3
CFG = dict(registry.config(CONFIG), num_streams=HOUSES, samples_per_stream=SAMPLES)
# ranges of blocks 0-39 and 40-71: household 13 (blocks 39-41) lies across
CHUNK, ACROSS = 40, 13
SEED = 2**31 + 5567


@functools.lru_cache(maxsize=None)
def _batch():
    """The cell's one input at this size: the households as views of one
    flat array, made by the benchmark's generator from the seed."""
    (inp,) = loop.make_inputs(CFG, registry.traffic(CELL), SEED, "cpu")
    return inp


def _compress(chunk_blocks):
    inp = _batch()
    return api.compress(inp.streams, program.settings(CFG), inp.ids, inp.cadences,
                        device="cpu", chunk_blocks=chunk_blocks)


@functools.lru_cache(maxsize=None)
def _frame_bytes(chunk_blocks):
    return write_frame(_compress(chunk_blocks))


@functools.lru_cache(maxsize=None)
def _reference():
    ((want, _),) = check.reference([_batch()], CFG, "cpu")
    return want


def test_two_ranges_with_one_household_across_the_boundary():
    inp = _batch()
    assert len(inp.streams) == HOUSES and all(s.size == SAMPLES for s in inp.streams)
    assert api.takes_flat_path(inp.lens)
    sdir = read_frame(_frame_bytes(CHUNK)).streams
    assert sdir.num_blocks.tolist() == [BLOCKS] * HOUSES
    first = sdir.first_block.astype(np.int64)
    assert api.block_ranges(HOUSES * BLOCKS, CHUNK) == [(0, CHUNK), (CHUNK, HOUSES * BLOCKS)]
    assert np.nonzero((first < CHUNK) & (CHUNK < first + BLOCKS))[0].tolist() == [ACROSS]
    n = read_frame(_frame_bytes(CHUNK)).blocks.n.astype(np.int64).reshape(HOUSES, BLOCKS)
    assert (n[:, :-1] == 4096).all() and (n[:, -1] == SAMPLES - 2 * 4096).all()


@pytest.mark.parametrize("chunk_blocks", [None, CHUNK], ids=["one_range", "two_ranges"])
def test_the_frame_is_the_plain_reference_frame(chunk_blocks):
    assert _frame_bytes(chunk_blocks) == _reference()


def test_decompress_gives_each_household_back_as_its_own_array():
    out = api.decompress(read_frame(_frame_bytes(None)), device="cpu", chunk_blocks=CHUNK)
    assert len(out) == HOUSES
    for got, house in zip(out, _batch().streams):
        assert got.dtype == np.int32 and got.base is None and got.flags.owndata
        np.testing.assert_array_equal(got, house)


def _spans(prof):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(trace.PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(trace.PREFIX))


def test_each_side_opens_two_ranges_and_the_decode_its_flat_path():
    with profile(activities=[ProfilerActivity.CPU]) as enc_prof:
        data = write_frame(_compress(CHUNK))
    frame = read_frame(data)
    with profile(activities=[ProfilerActivity.CPU]) as dec_prof:
        api.decompress(frame, device="cpu", chunk_blocks=CHUNK)
    enc, dec = _spans(enc_prof), _spans(dec_prof)
    assert [n for _, _, n in enc].count("range") == 2
    assert [n for _, _, n in dec].count("range") == 2
    names = {n for _, _, n in dec}
    assert {"download.flat", "split.copies", "host_split_streams"} <= names
    assert "download.streams" not in names
    (cs, ce, _), = [sp for sp in dec if sp[2] == "split.copies"]
    assert any(s <= cs and ce <= e for s, e, n in dec if n == "host_split_streams")
    flats = [(s, e) for s, e, n in dec if n == "download.flat"]
    ranges = [(s, e) for s, e, n in dec if n == "range"]
    assert len(flats) == 2
    assert all(any(rs <= s and e <= re for rs, re in ranges) for s, e in flats)


# ------------------------------------------------------- the cell's readers

# two encodes (0-1000, 2000-3000) and two decodes (1000-2000, 3000-4000):
# two ranges an encode, two and one the decodes, copies in the decodes
HOST = [
    (-50, -10, "dctpu.range"),                      # before the first call
    (10, 400, "dctpu.range"), (400, 800, "dctpu.range"),
    (1010, 1300, "dctpu.range"), (1300, 1600, "dctpu.range"),
    (1300, 1310, "dctpu.download.flat"),
    (1700, 1800, "dctpu.split.copies"),
    (2010, 2500, "dctpu.range"), (2500, 2990, "dctpu.range"),
    (3010, 3600, "dctpu.range"),
    (3700, 4000, "dctpu.split.copies"),
    (4000, 4100, "dctpu.range"),                    # starts as the call ends
]
CALLS = {"encode": [(0, 1000), (2000, 3000)], "decode": [(1000, 2000), (3000, 4000)]}
NEW = ["ranges_per_call.encode", "ranges_per_call.decode", "split_copies_ms"]


def _run(host):
    return types.SimpleNamespace(calls=[loop.Call(0), loop.Call(0)],
                                 trace=pb_trace.Trace([], sorted(host), CALLS))


def test_the_readers_count_ranges_and_time_the_copies():
    run_ = _run(HOST)
    assert registry.reader("ranges_per_call.encode")(run_) == 2
    assert registry.reader("ranges_per_call.decode")(run_) == 1.5
    assert registry.reader("split_copies_ms")(run_) == pytest.approx((100 + 300) / 2 / 1e6)


@pytest.mark.parametrize("name", NEW)
def test_a_run_without_the_spans_reads_none(name):
    """A program that opens neither span (the parent of these spans)."""
    host = [h for h in HOST if h[2] not in ("dctpu.range", "dctpu.split.copies")]
    assert registry.reader(name)(_run(host)) is None
    assert registry.reader(name)(types.SimpleNamespace(calls=[], trace=None)) is None


def test_the_config_is_the_published_trial_uncut():
    cfg = registry.config(CONFIG)
    bench = registry.benchmark()
    (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert set(cfg) == set(registry.config("dataport-1min-bulk"))
    assert (cfg["num_streams"], cfg["samples_per_stream"], cfg["cadence_s"]) == (5567, 39792, 1800)
    assert (cfg["block_len"], cfg["coder"], cfg["reduced"], entry["reduced"]) == (4096, "adaptive", {}, [])
    assert cfg["samples_per_stream"] == 829 * 86400 // cfg["cadence_s"]
    assert {"samples_per_stream", "signal"} <= set(cfg["assumed"])
    assert entry["source"] == cfg["source"] and len(entry["source"]) <= 200
    assert registry.workload(CELL, bench)["chips"] == 1


def test_the_cell_reports_its_path_metrics():
    bench = registry.benchmark()
    got = {m["name"] for m in registry.reported(bench["end_to_end"] + bench["per_layer"], CELL)}
    assert {"encode_gbps", "decode_gbps", "setup_s", "host_split_ms", *NEW} <= got
    assert not {"host_flatten_ms", "feed_loop_ms"} & got
    # the kernels' rooflines charge every launch its whole coder group, so
    # a call of two ranges would read each launch's least time twice
    assert not {"encode_kernels_roofline", "decode_kernels_roofline"} & got
    for name in ("ranges_per_call.encode", "ranges_per_call.decode"):
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == ["headend.daily", "dataport.bulk", CELL]
