"""The traced run's records, reduced from ``torch.profiler``'s events.

The window runs inside ``torch.profiler.profile`` (CPU and CUDA
activities), with each encode and each decode of the loop inside a
``record_function`` span of its own (``pb.encode``, ``pb.decode``). From
the profiler's events in the process (no trace file) this module keeps
every device interval (kernels, copies, fills), the spans of the calls
and the host's operations, all on the profiler's one clock, and answers
what the per-layer readers ask: which device work fell in which call,
how long the device was busy, where it waited and on what.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

SPANS = ("pb.encode", "pb.decode")
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class Trace:
    device: List[Tuple[int, int, str]]     # (start ns, end ns, name), sorted
    host: List[Tuple[int, int, str]]       # the host's operations, sorted
    calls: Dict[str, List[Tuple[int, int]]]  # side -> each call's span, in order

    def __post_init__(self):
        self.starts = [d[0] for d in self.device]
        self.spans = [h for h in self.host if h[2].startswith("pb.")]
        self.span_starts = [sp[0] for sp in self.spans]

    def call_ops(self, side: str):
        """[(call index, start, end, name)] of the device intervals that
        start inside each call of ``side`` ("encode" or "decode")."""
        out = []
        for i, (a, b) in enumerate(self.calls[side]):
            j = bisect.bisect_left(self.starts, a)
            while j < len(self.device) and self.device[j][0] < b:
                s, e, name = self.device[j]
                out.append((i, s, e, name))
                j += 1
        return out

    def busy_ns(self, side: str) -> int:
        """The union of the device intervals within the calls of ``side``."""
        return sum(_union_within(self.device, self.starts, a, b)
                   for a, b in self.calls[side])

    def wall_ns(self, side: str) -> int:
        return sum(b - a for a, b in self.calls[side])

    def window_ns(self) -> int:
        spans = self.calls["encode"] + self.calls["decode"]
        return max(b for _, b in spans) - min(a for a, _ in spans) if spans else 0

    def busy_window_ns(self) -> int:
        spans = self.calls["encode"] + self.calls["decode"]
        if not spans:
            return 0
        return _union_within(self.device, self.starts, min(a for a, _ in spans),
                             max(b for _, b in spans))

    def device_ops(self, top: int = 10):
        """The device operations that took most time in the window:
        [[name, seconds]]."""
        tot = defaultdict(int)
        for s, e, name in self._in_window():
            tot[short(name)] += e - s
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, longest: int = 2000):
        """The device's idle time in the calls, by what the host was doing
        at the middle of each gap: [[host operation, seconds]], from the
        ``longest`` gaps."""
        gaps = []
        for a, b in self.calls["encode"] + self.calls["decode"]:
            gaps += _gaps_within(self.device, self.starts, a, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        hstart = [h[0] for h in self.host]
        tot = defaultdict(int)
        for s, e in gaps[:longest]:
            tot[self._host_at((s + e) // 2, hstart)] += e - s
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def _in_window(self):
        spans = self.calls["encode"] + self.calls["decode"]
        if not spans:
            return []
        a, b = min(x for x, _ in spans), max(y for _, y in spans)
        return [d for d in self.device if a <= d[0] < b]

    def _host_at(self, t: int, hstart) -> str:
        """The innermost host operation running at t: the shortest of the
        64 that started last before it that contain it, else the
        harness's innermost span (``pb.compress``, ...) around t."""
        j = bisect.bisect_right(hstart, t)
        best = None
        for s, e, name in self.host[max(0, j - 64):j]:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        if best is None:
            k = bisect.bisect_right(self.span_starts, t)
            inside = [sp for sp in self.spans[max(0, k - 4):k] if sp[0] <= t < sp[1]]
            best = min(inside, key=lambda sp: sp[1] - sp[0], default=None)
        return short(best[2]) if best else "none"


def short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    head = name.split("(")[0] if "<" not in name.split("(")[0] else name.split(">(")[0] + ">"
    head = head.removeprefix("void ").strip()
    return head.replace("dct::", "")[:120]


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def _union_within(ivs, starts, a: int, b: int) -> int:
    """Length of the union of sorted intervals clipped to [a, b)."""
    total, cur_s, cur_e = 0, None, None
    for k in range(max(0, bisect.bisect_left(starts, a) - 256), len(ivs)):
        s, e, _ = ivs[k]
        if s >= b:
            break
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps_within(ivs, starts, a: int, b: int):
    """The idle stretches of [a, b) between sorted device intervals."""
    gaps, t = [], a
    for k in range(max(0, bisect.bisect_left(starts, a) - 256), len(ivs)):
        s, e, _ = ivs[k]
        if s >= b:
            break
        if s > t:
            gaps.append((t, min(s, b)))
        t = max(t, e)
    if t < b:
        gaps.append((t, b))
    return gaps


def collect(prof) -> Trace:
    """The records of a finished ``torch.profiler.profile``."""
    device, host = [], []
    calls = {"encode": [], "decode": []}
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        rec = (s, s + int(e.duration_ns()), e.name())
        if "CUDA" in str(e.device_type()):
            if not rec[2].startswith("pb."):  # a span's device-side copy is no work
                device.append(rec)
        elif rec[2] in SPANS:
            calls[rec[2][3:]].append(rec[:2])
        else:
            host.append(rec)
    device.sort()
    host.sort()
    for v in calls.values():
        v.sort()
    return Trace(device, host, calls)
