"""The reduction of the profiler's events, on made-up events."""

import types

import numpy as np
import pytest

from portbench import readers, trace, work
from portbench.loop import Call


def event(name, start, dur, device):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: "DeviceType.CUDA" if device else "DeviceType.CPU")


K1 = "void dct::select_lengths_kernel<(dct::Src)1, true>(int const*)"
R = "dct::recon_kernel(int const*, int const*)"
EVENTS = [
    event("pb.encode", 0, 1000, False), event("pb.encode", 0, 1000, True),
    event("pb.compress", 0, 800, False), event("pb.compress", 0, 800, True),
    event("aten::copy_", 100, 50, False),
    event(K1, 200, 100, True), event("Memcpy HtoD (Pageable -> Device)", 250, 100, True),
    event("void at::native::vectorized_elementwise_kernel<4>(int)", 600, 100, True),
    event("pb.decode", 2000, 1000, False),
    event(R, 2100, 300, True),
]


@pytest.fixture
def tr():
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: EVENTS)))
    return trace.collect(prof)


def test_spans_and_their_device_copies_are_not_device_work(tr):
    assert [d[2] for d in tr.device] == [K1, "Memcpy HtoD (Pageable -> Device)",
                                        "void at::native::vectorized_elementwise_kernel<4>(int)", R]
    assert tr.calls == {"encode": [(0, 1000)], "decode": [(2000, 3000)]}
    assert "pb.compress" in [h[2] for h in tr.host]


def test_busy_idle_and_launches(tr):
    assert tr.busy_ns("encode") == 150 + 100  # 200-350 and 600-700
    assert tr.busy_ns("decode") == 300
    assert tr.window_ns() == 3000 and tr.busy_window_ns() == 550
    run = types.SimpleNamespace(calls=[Call(0)], trace=tr)
    assert readers.idle_share(run, "encode") == pytest.approx(75.0)
    assert readers.launches_per_call(run, "encode") == 2  # the copy is no launch
    gaps = dict(tr.idle_gaps())
    assert set(gaps) == {"pb.compress", "aten::copy_", "none"}  # none: the encode after 800
    assert sum(gaps.values()) == pytest.approx((1000 - 250 + 1000 - 300) / 1e9)
    assert gaps["aten::copy_"] == pytest.approx(200 / 1e9)  # 0-200: its middle in the copy
    assert gaps["pb.compress"] == pytest.approx(250 / 1e9)  # 350-600


def test_kernels_roofline_counts_the_ports_kernels_only(tr):
    group = {"B": 10, "n": np.full(10, 128), "pred": np.zeros(10, np.uint8),
             "b": np.zeros((0, 1)), "rows_words": {"K3": 0, "K5a": 0, "K4": 0, "K5b": 0,
                                                   "CP": 0, "cands": 6, "tables": 4}}
    run = types.SimpleNamespace(calls=[Call(0)], trace=tr, cfg={"block_len": 128},
                                groups={0: {"all": group, "rice": group, "vertical": group}})
    want = 100 * work.launch_bound_ms("K1", group, 128) * 1e6 / 100
    assert readers.kernels_roofline(run, "encode") == pytest.approx(want)
    assert readers.kernels_roofline(run, "decode") == pytest.approx(
        100 * work.launch_bound_ms("R", group, 128) * 1e6 / 300)
