"""The harness on the CPU at small sizes: sound runs come out correct, the
control and each fault the cells can have come out not correct."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import control, loop, program, registry, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = registry.benchmark()
# the harness's per-call mode runs in the cell left out of BENCHMARK.json
ALL = registry.add(BENCH, registry.HERE / "pending" / "dataport.file.json")
SMALL = {"headend.daily": {"num_streams": 300},
         "dataport.file": {"samples_per_stream": 9000, "inputs": 3}}
SEED = 2**31 + 99


def execute(cell, prog, trace=0, seconds=0.3, seed=SEED):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.execute(args, prog, torch.device("cpu"), ALL, sizes=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(cell, trace):
    res, values = execute(cell, program.entry_points(), trace)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert values == {"frames_differing": 0, "decodes_differing": 0, "answers_missing": 0}
    want = registry.reported(ALL["per_layer" if trace else "end_to_end"], cell)
    got = set(res["metrics"])
    assert got <= {m["name"] for m in want}
    if not trace:
        assert got == {m["name"] for m in want}
    assert list(res)[-1] == "checks"
    json.dumps(res)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    res, values = execute(cell, control.Control())
    assert not res["correct"]
    assert values["frames_differing"] == values["decodes_differing"] == res["compared"] >= 1


def broken(**fns):
    prog = program.entry_points()
    return types.SimpleNamespace(**{**vars(prog), **fns})


def altered_payload(streams, *a, **k):
    frame = program.entry_points().compress(streams, *a, **k)
    frame.payload_words[len(frame.payload_words) // 2] ^= 1 << 5
    return frame


def half_batch(streams, cfg, ids, cads, **k):
    h = max(1, len(streams) // 2)
    return program.entry_points().compress(streams[:h], cfg, ids[:h], cads[:h], **k)


def altered_sample(frame, **k):
    flat, lens = program.entry_points().decompress_flat(frame, **k)
    flat = flat.copy()
    flat[len(flat) // 3] += 1
    return flat, lens


def altered_stream(frame, **k):
    out = program.entry_points().decompress(frame, **k)
    out[0] = out[0].copy()
    out[0][-1] ^= 2
    return out


def raises(*a, **k):
    raise RuntimeError("a lost answer")


@pytest.mark.parametrize("cell, fault, number", [
    ("headend.daily", {"compress": altered_payload}, "frames_differing"),
    ("dataport.file", {"compress": altered_payload}, "frames_differing"),
    ("headend.daily", {"compress": half_batch}, "frames_differing"),
    ("headend.daily", {"decompress_flat": altered_sample}, "decodes_differing"),
    ("dataport.file", {"decompress": altered_stream}, "decodes_differing"),
    ("dataport.file", {"decompress": raises}, "answers_missing"),
], ids=["payload-bit", "payload-bit-file", "half-batch", "decoded-sample",
        "decoded-sample-file", "lost-answer"])
def test_a_fault_is_not_correct(cell, fault, number):
    res, values = execute(cell, broken(**fault))
    assert not res["correct"]
    assert values[number] >= 1


def test_without_a_card_it_fails_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "headend.daily", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_it_refuses_a_process_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        execute("dataport.file", program.entry_points())


def test_alone_in_a_folder_it_fails_and_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no program."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "dataport.file",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.pbcard
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_runs_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                        "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.pbcard
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "-m", "portbench.control", "--workload", cell,
                        "--seconds", "2", "--seeds", "11", "12", "13"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    rows = [json.loads(line) for line in p.stdout.strip().splitlines()]
    assert len(rows) == 3 and not any(r["correct"] for r in rows)


def small_loop(compare, frame_bytes=None, seconds=0.5, seed=5):
    cfg = dict(registry.config("dataport-1min"), samples_per_stream=3000)
    mix = dict(registry.traffic("dataport.file"), inputs=3)
    prog = program.entry_points()
    inputs = loop.make_inputs(cfg, mix, 5, "cpu")
    if frame_bytes is None:
        frame_bytes = [len(prog.write_frame(prog.compress(
            i.streams, prog.settings(cfg), i.ids, i.cadences, device="cpu"))) for i in inputs]
    answers = loop.Answers(inputs, frame_bytes, compare, seed)
    calls = loop.closed_loop(prog, prog.settings(cfg), inputs, "decompress", "cpu",
                             seconds, False, answers)
    return inputs, calls


def test_the_loop_compares_every_input_and_a_seeded_sample():
    inputs, calls = small_loop(compare=2)
    compared = [c for c in calls if c.frame_sha is not None]
    assert len(calls) > 5
    assert {c.input for c in compared} == {0, 1, 2}
    assert 3 <= len(compared) <= 5
    assert all(c.decoded_sha == inputs[c.input].digest() for c in compared)


def test_a_kept_answer_is_the_answer_digested_at_once():
    """An answer copied into its slot digests as the answer itself does;
    one that does not fit (room for no frame byte) is digested at once."""
    inputs, calls = small_loop(compare=1)
    tight_inputs, tight = small_loop(compare=1, frame_bytes=[0, 0, 0])
    shas = {c.input: c.frame_sha for c in calls if c.frame_sha is not None}
    for got in (calls, tight):
        compared = [c for c in got if c.frame_sha is not None]
        assert {c.input for c in compared} == {0, 1, 2}
        assert all(c.frame_sha == shas[c.input] for c in compared)
        assert all(c.decoded_sha == inputs[c.input].digest() for c in compared)


@pytest.mark.parametrize("key, val", [("clients", 4), ("loop", "open"), ("rate_per_s", 10)])
def test_a_traffic_key_no_driver_reads_is_refused(tmp_path, key, val):
    import shutil

    folder = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(registry.HERE / sub, folder / sub)
    path = folder / "traffic" / "dataport.file.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), key: val}))
    args = run.parse(["--workload", "dataport.file", "--seed", "1", "--seconds", "0.1"])
    with pytest.raises(ValueError, match=key):
        run.execute(args, program.entry_points(), torch.device("cpu"), ALL,
                    folder=folder, sizes=SMALL["dataport.file"])
