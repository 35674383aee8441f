"""Run one cell of the benchmark once.

  python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: load the program's kernels (built at first use under
``build/dctpu_torch/`` in the checkout), make the cell's inputs on the card
from the seed, warm up one round trip of every distinct input, run the
closed loop for ``--seconds``, compare every answer with the plain
reference, and print one JSON line as the last line of standard output.
``--trace 0`` calls the program with tracing off and reports the cell's
end-to-end metrics; ``--trace 1`` passes ``stage_ms`` dicts, runs the
window under ``torch.profiler`` and reports its per-layer metrics.

Exits non-zero with no result line when there is no CUDA device, or
fewer than the cell asks for, when the program is missing, and when JAX or
the JAX package has been loaded in the process.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
# every cache of a CUDA toolchain in the checkout, at a fixed path
for _var, _dir in (("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(CHECKOUT / "build" / "portbench" / _dir))


def _process_start() -> float:
    """time.time() at which this process started (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import check, loop, registry, trace, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dctpu")
# what a traffic file may hold: the loop has one closed-loop caller and no
# other driver, so a key it does not know is refused, never ignored
TRAFFIC_KEYS = {"mode", "decode", "inputs", "compare", "why"}


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cfg: dict
    inputs: list
    calls: list
    setup_s: float
    trace: trace.Trace | None = None
    groups: dict | None = None   # input index -> work.frame_groups of its frame


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_kind(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": smi}


def execute(args, program, device, bench: dict, folder: Path = registry.HERE,
            sizes: dict | None = None, t_start: float | None = None):
    """One run of a cell: returns (result dict, the compared numbers).
    ``sizes`` replaces numbers of the configuration or the traffic mix
    (the tests' small runs)."""
    t_start = T_START if t_start is None else t_start
    cell = registry.workload(args.workload, bench)
    cfg = registry.config(cell["config"], folder)
    mix = registry.traffic(cell["traffic"], folder)
    for key, val in (sizes or {}).items():
        (mix if key in mix else cfg)[key] = val
    if set(mix) - TRAFFIC_KEYS:
        raise ValueError(f"traffic {cell['traffic']!r}: no driver reads "
                         f"{sorted(set(mix) - TRAFFIC_KEYS)}")
    if mix["mode"] not in ("batch", "per_call"):
        raise ValueError(f"unknown traffic mode {mix['mode']!r}")
    if mix["decode"] not in ("decompress", "decompress_flat"):
        raise ValueError(f"unknown decode entry {mix['decode']!r}")
    settings = program.settings(cfg)
    traced = bool(args.trace)
    metrics = registry.reported(bench["per_layer" if traced else "end_to_end"],
                                args.workload)
    readers = {m["name"]: registry.reader(m["name"], folder) for m in metrics}

    inputs = loop.make_inputs(cfg, mix, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    frame_bytes = []
    for i, inp in enumerate(inputs):  # warm-up: every distinct input once
        _, answer = loop.round_trip(program, settings, inp, i, mix["decode"], device, traced)
        frame_bytes.append(0 if answer is None else len(answer[0]))
        del answer
    answers = loop.Answers(inputs, frame_bytes, mix["compare"], args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    prof = None
    span = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function
    setup_s = time.time() - t_start
    calls = loop.closed_loop(program, settings, inputs, mix["decode"], device,
                             args.seconds, traced, answers, span)
    if prof is not None:
        prof.__exit__(None, None, None)
    dev = device_kind(device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in the process: {', '.join(found)}")

    del answers
    run = Run(cfg, inputs, calls, setup_s)
    if prof is not None:
        run.trace = trace.collect(prof)
        del prof
    if device.type == "cuda":
        torch.cuda.empty_cache()
    used = sorted({c.input for c in calls if c.frame_sha is not None})
    ref = dict(zip(used, check.reference([inputs[i] for i in used], cfg, device)
                   if used else []))
    frame_shas = {i: hashlib.sha256(f).hexdigest() for i, (f, _) in ref.items()}
    input_shas = {i: inputs[i].digest() for i in used}
    if traced:
        run.groups = {i: work.frame_groups(b, cfg) for i, (_, b) in ref.items()}
    values = check.counts(calls, frame_shas, input_shas)

    result = {
        "correct": check.verdict(values, calls),
        "attempted": len(calls),
        "failed": sum(c.error is not None for c in calls),
        "compared": sum(c.frame_sha is not None for c in calls),
        "metrics": {},
        "device": dev,
    }
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if run.trace is not None and run.trace.calls["encode"]:
        result["device"]["busy_s"] = run.trace.busy_window_ns() / 1e9
        result["device"]["window_s"] = run.trace.window_ns() / 1e9
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    errors = sorted({c.error for c in calls if c.error})
    if errors:
        print("failed calls: " + "; ".join(errors[:5]), file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in values.items()}
    return result, values


def main(argv=None) -> int:
    args = parse(argv)
    bench = registry.benchmark()
    cell = registry.workload(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench import program

    prog = program.load()
    result, values = execute(args, prog, torch.device("cuda", 0), bench)
    for k, v in values.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
