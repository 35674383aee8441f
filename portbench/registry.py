"""Find a cell's configuration, traffic mix and metric readers by name.

A later cell, configuration, traffic mix or per-layer metric is a new file
under this folder and a new entry in ``BENCHMARK.json``; nothing here lists
them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def add(bench: dict, path: Path) -> dict:
    """``bench`` with the entries of the file at ``path`` (a cell's
    configurations, workloads and metrics, as ``BENCHMARK.json`` holds
    them) added, as a PR that adds the cell adds them."""
    extra = json.loads(Path(path).read_text())
    return {**bench, **{k: bench[k] + extra.get(k, [])
                        for k in ("configs", "workloads", "end_to_end", "per_layer")}}


def workload(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, folder: Path = HERE) -> dict:
    return json.loads((folder / "configs" / f"{_name(name)}.json").read_text())


def traffic(name: str, folder: Path = HERE) -> dict:
    return json.loads((folder / "traffic" / f"{_name(name)}.json").read_text())


def reader(name: str, folder: Path = HERE):
    """The ``read(run)`` function of metric ``name``, from
    ``metrics/<name>.py``."""
    path = folder / "metrics" / f"{_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reported(metrics: list, cell: str) -> list:
    """The metrics of a list that cell ``cell`` reports: those without a
    ``workloads`` key, and those that name it."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]
