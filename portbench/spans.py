"""What the readers of the program's own spans share.

``dctpu_torch`` opens a host range ``dctpu.<name>`` for each of its steps
while the profiler records (``dctpu_torch/trace.py``): the traced run's
``trace.host`` holds them beside PyTorch's operations, on the device's
clock. A reader here takes the ranges of one name, or of one prefix, that
start inside each call of a side (``trace.calls[side]``) and gives their
mean per call. A version of the program that opens no such range reads
None.
"""

from __future__ import annotations

import bisect

import numpy as np

from portbench.readers import side_calls

PREFIX = "dctpu."


def per_call(run, side: str, pick):
    """For each call of ``side``: the sorted [(start, end)] of the host
    ranges whose name, less ``dctpu.``, ``pick`` accepts and that start
    inside the call; None when the calls do not pair up with the trace's
    or no call holds such a range."""
    if side_calls(run, side) is None:
        return None
    mine = [(s, e) for s, e, name in run.trace.host
            if name.startswith(PREFIX) and pick(name[len(PREFIX):])]
    starts = [s for s, _ in mine]
    out = [mine[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]
           for a, b in run.trace.calls[side]]
    return out if any(out) else None


def covered_ns(ranges) -> int:
    """The time the sorted ranges cover: a range inside another of the
    same name (a step called within itself) is not counted twice."""
    total, end = 0, None
    for s, e in ranges:
        if end is None or s >= end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def mean_ms(run, side: str, name: str):
    """Mean over the calls of ``side`` of the time in span ``name``, ms."""
    calls = per_call(run, side, lambda n: n == name)
    return None if calls is None else float(np.mean([covered_ns(c) for c in calls])) / 1e6


def mean_count(run, side: str, prefix: str):
    """Mean number of spans per call of ``side`` whose names start with
    ``prefix``."""
    calls = per_call(run, side, lambda n: n.startswith(prefix))
    return None if calls is None else float(np.mean([len(c) for c in calls]))
