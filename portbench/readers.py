"""What the metric readers (``metrics/<name>.py``) share.

A reader is ``read(run) -> float | None``: None when the run holds
nothing for it to read (a run without a trace, a layer the program did
not pass through), and the harness then leaves the metric out.
"""

from __future__ import annotations

import numpy as np

from portbench import work
from portbench.trace import is_copy


def done(run):
    return [c for c in run.calls if c.error is None]


def rate_gbps(run, side: str):
    """Raw int32 bytes over the calls' host-clock time, GB/s."""
    calls = done(run)
    secs = sum(getattr(c, f"{side}_s") for c in calls)
    if not calls or secs <= 0:
        return None
    return sum(run.inputs[c.input].raw_bytes for c in calls) / secs / 1e9


def p95_ms(run, side: str):
    times = [getattr(c, f"{side}_s") for c in done(run)]
    return float(np.percentile(times, 95)) * 1e3 if times else None


def mean_ms(run, side: str, pick):
    """Mean over the traced calls of the sum of the ``stage_ms`` entries
    of ``side`` whose names ``pick`` accepts; None if no call has one."""
    vals = []
    for c in done(run):
        st = getattr(c, f"{side}_stages")
        if st is None:
            continue
        hit = [v for k, v in st.items() if pick(k)]
        if hit:
            vals.append(sum(hit))
    return float(np.mean(vals)) if vals else None


def mean_host_s(run, field: str):
    calls = [c for c in done(run) if c.encode_stages is not None]
    return float(np.mean([getattr(c, field) for c in calls])) * 1e3 if calls else None


def side_calls(run, side: str):
    """The calls in the order of the trace's spans of ``side``, or None
    when they do not pair up one to one."""
    calls = done(run)
    if run.trace is None or len(run.trace.calls[side]) != len(calls):
        return None
    return calls


def kernels_roofline(run, side: str):
    """100 x the least time of the port's kernel launches in the calls of
    ``side`` (``work.py``, on each launch's coder group of that call's
    input) over their device time. PyTorch's own kernels are in neither."""
    calls = side_calls(run, side)
    if calls is None:
        return None
    L = run.cfg["block_len"]
    least, spent, cache = 0.0, 0, {}
    for i, s, e, name in run.trace.call_ops(side):
        kind = work.classify(name)
        if kind is None:
            continue
        spent += e - s
        key, group = kind
        if key == "?":
            continue
        inp = calls[i].input
        if (inp, key) not in cache:
            cache[inp, key] = work.launch_bound_ms(key, run.groups[inp][group], L)
        least += cache[inp, key] * 1e6
    return 100.0 * least / spent if spent else None


def idle_share(run, side: str):
    """100 x the share of the calls' wall time in which no kernel, copy or
    fill ran on the device."""
    if side_calls(run, side) is None or not run.trace.device:
        return None
    wall = run.trace.wall_ns(side)
    return 100.0 * (1.0 - run.trace.busy_ns(side) / wall) if wall else None


def launches_per_call(run, side: str):
    calls = side_calls(run, side)
    if not calls:
        return None
    ops = run.trace.call_ops(side)
    return sum(not is_copy(name) for _, _, _, name in ops) / len(calls)
