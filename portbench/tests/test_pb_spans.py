"""The readers of the program's own spans (``spans.py``), on hand-built
traces, and on a traced run of the program at a small size on the CPU."""

import types

import pytest
import torch

from portbench import program, registry, run, spans, trace
from portbench.loop import Call

# two encodes, 0-1000 and 2000-3000, and one decode in between; a feed
# span nested in its stage, a gather called within a gather, reads inside
# the download, and spans outside every call
HOST = [
    (-500, -100, "dctpu.feed.gather"),              # before the first call
    (10, 400, "dctpu.host_build_blocks"),
    (20, 120, "dctpu.feed.gather"),
    (50, 100, "dctpu.feed.gather"),                 # inside the one above
    (130, 390, "dctpu.feed.native"),
    (500, 600, "dctpu.download"),
    (510, 520, "dctpu.sync.words"), (530, 540, "dctpu.sync.k"),
    (700, 701, "dctpu.sync.coders"),
    (800, 900, "dctpu.write_frame"), (850, 890, "dctpu.write_frame.crc"),
    (1100, 1900, "dctpu.sync.download"),            # between the encodes
    (1200, 1300, "pb.read_frame"), (1210, 1290, "dctpu.read_frame.crc"),
    (1300, 1310, "aten::copy_"),
    (2100, 2400, "dctpu.feed.gather"),
    (2500, 2510, "dctpu.sync.words"),
    (3000, 3100, "dctpu.feed.gather"),              # starts as the call ends
]
CALLS = {"encode": [(0, 1000), (2000, 3000)], "decode": [(1000, 2000)]}


def a_run(host=HOST, calls=CALLS, done=2):
    return types.SimpleNamespace(calls=[Call(0) for _ in range(done)],
                                 trace=trace.Trace([], sorted(host), calls))


def test_a_span_counts_once_per_call_and_only_inside_it():
    per = spans.per_call(a_run(), "encode", lambda n: n == "feed.gather")
    assert per == [[(20, 120), (50, 100)], [(2100, 2400)]]
    # 100 in the first call (the inner gather lies in the outer), 300 in the second
    assert spans.mean_ms(a_run(), "encode", "feed.gather") == pytest.approx(200 / 1e6)


def test_a_child_is_not_counted_under_its_parent():
    run_ = a_run()
    assert spans.mean_ms(run_, "encode", "host_build_blocks") == pytest.approx(390 / 2 / 1e6)
    assert spans.mean_ms(run_, "encode", "feed.native") == pytest.approx(260 / 2 / 1e6)
    assert spans.mean_ms(run_, "encode", "download") == pytest.approx(100 / 2 / 1e6)
    # the download holds two reads and is none itself
    assert spans.mean_count(run_, "encode", "sync.") == pytest.approx((3 + 1) / 2)


def test_each_side_reads_its_own_calls():
    run_ = types.SimpleNamespace(calls=[Call(0)], trace=trace.Trace(
        [], HOST, {"encode": [(0, 1000)], "decode": [(1000, 2000)]}))
    assert spans.mean_count(run_, "decode", "sync.") == 1
    assert spans.mean_ms(run_, "decode", "sync.download") == pytest.approx(800 / 1e6)
    assert spans.mean_ms(run_, "decode", "feed.gather") is None


@pytest.mark.parametrize("host", [[], [h for h in HOST if not h[2].startswith("dctpu.")]],
                         ids=["no_event", "no_span"])
def test_no_span_at_all_reads_none(host):
    run_ = a_run(host)
    for side in ("encode", "decode"):
        assert spans.mean_count(run_, side, "sync.") is None
        assert spans.mean_ms(run_, side, "feed.gather") is None


def test_calls_that_do_not_pair_up_read_none():
    assert spans.mean_ms(a_run(done=3), "encode", "feed.gather") is None
    assert spans.mean_count(types.SimpleNamespace(calls=[Call(0)], trace=None),
                            "encode", "sync.") is None


def test_covered_time_of_nested_and_touching_ranges():
    assert spans.covered_ns([]) == 0
    assert spans.covered_ns([(0, 10), (2, 5), (8, 15), (15, 20), (30, 31)]) == 21


NEW = ["host_flatten_ms", "feed_gather_ms", "feed_native_ms", "frame_crc_ms.write",
       "frame_crc_ms.read", "host_syncs.encode", "host_syncs.decode"]


def test_a_traced_run_reads_the_program_spans():
    args = run.parse(["--workload", "headend.daily", "--seed", str(2**31 + 7),
                      "--seconds", "0.3", "--trace", "1"])
    res, _ = run.execute(args, program.entry_points(), torch.device("cpu"),
                         registry.benchmark(), sizes={"num_streams": 300})
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"] and set(NEW) <= set(got)
    # the CPU path's reads: 5 an encode (CP's total is read on a card
    # only), 1 a decode (the CPU twin checks K4's blocks itself)
    assert (got["host_syncs.encode"], got["host_syncs.decode"]) == (5, 1)
    assert 0 < got["feed_gather_ms"] + got["feed_native_ms"] <= got["host_feed_ms"]
    assert all(got[m] > 0 for m in NEW)


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_reads_nothing_from_a_trace_without_spans(name):
    host = [h for h in HOST if not h[2].startswith("dctpu.")]
    run_ = types.SimpleNamespace(
        calls=[Call(0, encode_stages={"download": 1.0}, decode_stages={"download": 1.0})],
        trace=trace.Trace([], host, {"encode": [(0, 1000)], "decode": [(1000, 2000)]}))
    assert registry.reader(name)(run_) is None
    run_.trace = trace.Trace([], HOST, run_.trace.calls)
    run_.calls[0].decode_stages["host_flatten"] = 2.0
    assert registry.reader(name)(run_) is not None
