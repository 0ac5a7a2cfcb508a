"""The profiler's trace of a run's traced window, reduced to what the
per-layer readers take: device kernels (name, start, duration), the host
spans the harness opened (`record_function` scopes), the device's busy
time, and the longest idle gaps labelled with the span the host was in.

The arithmetic is a frozen copy of the system's `tools/trace_summary.py`
as it stood when the benchmark was written: a kernel's group is its name
without return type, template arguments, parameters, namespaces and a
numeric suffix; busy time is the union of the kernel intervals.
"""

from __future__ import annotations

import collections
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


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

    def busy_us(self) -> float:
        lo, hi = self.window
        return sum(e - s for s, e in union(
            (max(s, lo), min(s + d, hi)) for _, s, d in self.kernels
            if s + d > lo and s < hi))

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

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps inside the window, each named by the
        innermost host span open at its middle ("idle" outside every
        span), in seconds."""
        lo, hi = self.window
        busy = union((max(s, lo), min(s + d, hi)) for _, s, d in self.kernels
                     if s + d > lo and s < hi)
        edges = [lo] + [x for b in busy for x in b] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            name = (min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner
                    else "idle")
            out.append([name, (b - a) / 1e6])
        return out


def from_profiler(prof, window_name: str) -> Trace:
    """The Trace of a finished `torch.profiler.profile`: CUDA kernels (and
    the device memory copies and sets, which occupy it too) and the
    `record_function` scopes; the window is the scope `window_name`."""
    kernels, spans = [], []
    window = None
    for e in prof.events():
        dt = str(e.device_type).rsplit(".", 1)[-1]
        start = float(e.time_range.start)
        end = float(e.time_range.end)
        if dt == "CUDA":
            if not e.name.startswith("bench/"):   # a scope's device shadow
                kernels.append((e.name, start, end - start))
        elif e.name == window_name:
            window = (start, end)
        elif getattr(e, "is_user_annotation", False) or e.name.startswith(
                "bench/"):
            spans.append((e.name, start, end))
    if window is None:
        raise RuntimeError(f"the trace has no scope {window_name!r}")
    return Trace(kernels, spans, window)
