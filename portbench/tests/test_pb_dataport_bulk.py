"""The ``dataport.bulk`` cell through the harness on the CPU, at 3 homes of
140,000 samples (a mean above the loop switch, so the per-stream loop feed
runs as at the cell's size): a sound run is correct and reads its
metrics, the control and a decode with one home altered are not."""

import types

import pytest
import torch

from portbench import control, program, registry, run

CELL = "dataport.bulk"
BENCH = registry.benchmark()
SIZES = {"num_streams": 3, "samples_per_stream": 140000}
SEED = 2**31 + 2020


def execute(prog, trace=0, seconds=0.3):
    args = run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.execute(args, prog, torch.device("cpu"), BENCH, sizes=SIZES)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    res, values = execute(program.entry_points(), trace)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert values == {"frames_differing": 0, "decodes_differing": 0, "answers_missing": 0}
    got = set(res["metrics"])
    if trace:
        assert {"feed_loop_ms", "host_split_ms", "feed_gather_ms", "host_feed_ms"} <= got
        assert all(res["metrics"][m]["value"] > 0 for m in ("feed_loop_ms", "host_split_ms"))
        assert not {"feed_native_ms", "host_flatten_ms"} & got
        assert got <= {m["name"] for m in registry.reported(BENCH["per_layer"], CELL)}
    else:
        assert got == {m["name"] for m in registry.reported(BENCH["end_to_end"], CELL)}
        assert {"encode_gbps", "decode_gbps", "setup_s"} == got


def test_the_control_is_not_correct():
    res, values = execute(control.Control())
    assert not res["correct"]
    assert values["frames_differing"] == values["decodes_differing"] == res["compared"] >= 1


def altered_home(frame, **k):
    out = program.entry_points().decompress(frame, **k)
    out[1] = out[1].copy()
    out[1][len(out[1]) // 2] += 1
    return out


def test_a_decode_with_one_home_altered_is_not_correct():
    prog = types.SimpleNamespace(**{**vars(program.entry_points()),
                                    "decompress": altered_home})
    res, values = execute(prog)
    assert not res["correct"]
    assert values["decodes_differing"] >= 1 and values["frames_differing"] == 0
