"""The profiler's trace of a run's traced window, reduced to what the
per-layer readers take: device operations (name, start, duration), the
host spans (`record_function` scopes, the harness's and the program's),
the device's busy time, and its idle time labelled with the span the
host was in.

A `record_function` scope that launches work also leaves a device-side
shadow in the trace, from its first kernel to its last: an event with
`is_user_annotation` set (PyTorch 2.11 on the card) or of activity
`gpu_user_annotation` (2.13). The shadow is no work of the card: it is
never counted as a device operation, whatever its name.

The arithmetic is a frozen copy of the system's `tools/trace_summary.py`
as it stood when the benchmark was written: a kernel's group is its name
without return type, template arguments, parameters, namespaces and a
numeric suffix; busy time is the union of the kernel intervals.
"""

from __future__ import annotations

import collections
import heapq
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# Kineto's activity types of a `record_function` scope, on the host and as
# its device shadow.
SCOPE_ACTIVITIES = {"user_annotation", "gpu_user_annotation"}


def group(name: str) -> str:
    """A kernel's group: `void ns::k<T>(args)` → `k`."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    s = re.sub(r"\.\d+$", "", "".join(out).strip())
    return s.split("::")[-1] or name


def union(spans) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """A traced window: kernels and host spans in microseconds on the
    profiler's clock, and the window's bounds on that clock."""
    kernels: List[Tuple[str, float, float]]            # (name, start, dur)
    spans: List[Tuple[str, float, float]]              # (name, start, end)
    window: Tuple[float, float]
    groups: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        acc: Dict[str, float] = collections.defaultdict(float)
        for name, _, dur in self.kernels:
            acc[group(name)] += dur
        self.groups = dict(acc)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def _busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals in the window."""
        lo, hi = self.window
        return union((max(s, lo), min(s + d, hi)) for _, s, d in self.kernels
                     if s + d > lo and s < hi)

    def busy_us(self) -> float:
        return sum(e - s for s, e in self._busy())

    def kernel_us(self, pattern: str, exclude: str = None) -> float:
        """Device µs of the kernels whose full name matches `pattern` (a
        regular expression) and not `exclude`."""
        rx = re.compile(pattern)
        ex = re.compile(exclude) if exclude else None
        return sum(d for n, _, d in self.kernels
                   if rx.search(n) and not (ex and ex.search(n)))

    def span_us(self, name: str) -> List[float]:
        return [e - s for n, s, e in self.spans if n == name]

    def top_ops(self, n: int = 10) -> List[List]:
        return [[k, v / 1e6] for k, v in sorted(
            self.groups.items(), key=lambda kv: -kv[1])[:n]]

    def _idle(self) -> List[Tuple[float, float]]:
        """The window's idle intervals: where no device operation runs."""
        lo, hi = self.window
        edges = [lo] + [x for b in self._busy() for x in b] + [hi]
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps inside the window, each named by the
        innermost host span open at its middle ("idle" outside every
        span), in seconds."""
        gaps = sorted(self._idle(), key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            name = (min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner
                    else "idle")
            out.append([name, (b - a) / 1e6])
        return out

    def idle_us_by_span(self) -> Dict[str, float]:
        """The window's idle µs by host span: each idle interval cut at
        every span edge, each piece given to the innermost (shortest) span
        open over it, or to "idle" outside every span."""
        lo, hi = self.window
        edges = sorted({lo, hi} | {min(max(x, lo), hi)
                                   for _, s, e in self.spans for x in (s, e)})
        starts = sorted((s, e, name) for name, s, e in self.spans)
        owners, open_, i = [], [], 0
        for a, b in zip(edges, edges[1:]):
            while i < len(starts) and starts[i][0] <= a:
                s, e, name = starts[i]
                heapq.heappush(open_, (e - s, e, name))
                i += 1
            while open_ and open_[0][1] <= a:   # ended: lazily dropped
                heapq.heappop(open_)
            owners.append((a, b, open_[0][2] if open_ else "idle"))
        out: Dict[str, float] = collections.defaultdict(float)
        j = 0
        for a, b in self._idle():
            while owners[j][1] <= a:
                j += 1
            k = j
            while k < len(owners) and owners[k][0] < b:
                p, q, name = owners[k]
                out[name] += min(b, q) - max(a, p)
                k += 1
        return dict(out)


def from_profiler(prof, window_name: str) -> Trace:
    """The Trace of a finished `torch.profiler.profile`: the device's
    kernels, memory copies and sets, less every scope's device shadow; and
    the host's `record_function` scopes; the window is the scope
    `window_name`."""
    kernels, spans = [], []
    window = None
    for e in prof.events():
        dt = str(e.device_type).rsplit(".", 1)[-1]
        start = float(e.time_range.start)
        end = float(e.time_range.end)
        scope = (getattr(e, "is_user_annotation", False)
                 or getattr(e, "activity_type", None) in SCOPE_ACTIVITIES)
        if dt == "CUDA":
            if not scope:
                kernels.append((e.name, start, end - start))
        elif e.name == window_name:
            window = (start, end)
        elif scope:
            spans.append((e.name, start, end))
    if window is None:
        raise RuntimeError(f"the trace has no scope {window_name!r}")
    return Trace(kernels, spans, window)
