"""BENCHMARK.json against the contract, and every name it holds found as a
file; a new file in each folder found without editing another."""

import json
import re
import shutil

import pytest
import torch

from portbench import program, registry, run

BENCH = registry.benchmark()
PENDING = sorted((registry.HERE / "pending").glob("*.json"))
ALL = BENCH
for _path in PENDING:
    ALL = registry.add(ALL, _path)
CELLS = [w["name"] for w in ALL["workloads"]]
METRICS = [m["name"] for m in ALL["end_to_end"] + ALL["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    w = registry.workload(cell, ALL)
    cfg = registry.config(w["config"])
    mix = registry.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert set(mix) <= run.TRAFFIC_KEYS and mix["mode"] in ("batch", "per_call")
    for m in registry.reported(ALL["end_to_end"] + ALL["per_layer"], cell):
        assert callable(registry.reader(m["name"]))
    e2e = registry.reported(ALL["end_to_end"], cell)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert registry.reported(ALL["per_layer"], cell)


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    assert callable(registry.reader(metric))


@pytest.mark.parametrize("with_pending", [False, True])
def test_benchmark_json_keeps_the_contract(with_pending):
    """BENCHMARK.json, and BENCHMARK.json with each pending cell added."""
    bench = ALL if with_pending else BENCH
    cells = [w["name"] for w in bench["workloads"]]
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    assert {w["config"] for w in bench["workloads"]} == set(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert set(c["reduced"]) <= set(registry.config(c["name"])["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)


def test_new_files_are_found_without_editing_another(tmp_path):
    """A configuration, a traffic mix and a metric added as files, with a
    cell naming them, run through the harness as they are."""
    folder = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(registry.HERE / sub, folder / sub)
    cfg = registry.config("headend-15min")
    cfg.update(name="tiny-15min", num_streams=50)
    (folder / "configs" / "tiny-15min.json").write_text(json.dumps(cfg))
    mix = dict(registry.traffic("headend.daily"), decode="decompress")
    (folder / "traffic" / "tiny.split.json").write_text(json.dumps(mix))
    (folder / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tiny.split", "config": "tiny-15min",
                               "traffic": "tiny.split", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.split"]})
    args = run.parse(["--workload", "tiny.split", "--seed", "3", "--seconds", "0.2"])
    res, _ = run.execute(args, program.entry_points(), torch.device("cpu"), bench,
                         folder=folder)
    assert res["correct"]
    assert res["metrics"]["calls_made"]["value"] == res["attempted"] >= 1
    assert set(res["metrics"]) == {"calls_made", "setup_s"}


def test_a_cell_runs_the_traffic_it_names(tmp_path):
    """A cell whose traffic mix is another cell's file: found by the
    workload's ``traffic``, not by its name."""
    bench = json.loads(json.dumps(ALL))
    bench["workloads"].append({"name": "dataport.file-again", "config": "dataport-1min",
                               "traffic": "dataport.file", "chips": 1, "why": "a test"})
    args = run.parse(["--workload", "dataport.file-again", "--seed", "3", "--seconds", "0.2"])
    res, values = run.execute(args, program.entry_points(), torch.device("cpu"), bench,
                              sizes={"samples_per_stream": 5000, "inputs": 2})
    assert res["correct"] and values["frames_differing"] == 0
    assert res["compared"] >= 2 and set(res["metrics"]) == {"setup_s"}


def test_a_pending_cell_is_out_of_benchmark_json():
    """Each file under ``pending/`` holds a cell that BENCHMARK.json does
    not have yet, with the reason in its ``why``."""
    assert PENDING
    cells = {w["name"] for w in BENCH["workloads"]}
    for path in PENDING:
        extra = json.loads(path.read_text())
        assert extra["why"] and not cells & {w["name"] for w in extra["workloads"]}
