"""Summarise a torch.profiler chrome trace: top CUDA kernel groups by time.

    python3 -m detectandtrack_tpu_torch.tools.trace_summary TRACE_DIR [N]

Port of tools/trace_summary.py. It reads the newest `*.json.gz` (or
`*.json`) chrome trace under TRACE_DIR (as `utils/profiling.trace` and
`tools/capture_trace.py` write them), keeps the CUDA kernel events
(category "kernel"), folds each kernel's name into its op group (template
arguments, the parameter list, namespaces and numeric launch suffixes
dropped, so `void (anonymous namespace)::roi_align_fwd_kernel<bf16>(...)`
is `roi_align_fwd_kernel`), and prints the top N groups by time with their
share of kernel time, then the top N (group, launching op) pairs (the
torch op whose "External id" the kernel carries: which `aten::` op the
elementwise passes are). Then the card's busy share of the traced window
(union of kernel intervals over first kernel start to last kernel end; the
rest is idle: host syncs, launch gaps), and, where the trace has
`record_function` scopes (capture_trace's stage names), kernel time by the
innermost scope that was open when the kernel was launched, and the card's
idle time by the scope the host was in meanwhile (host and card events
share one clock in the trace).
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Tuple


def newest_trace(trace_dir: str) -> str:
    paths = [p for pat in ("*.json.gz", "*.json") for p in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)
        if not p.endswith("work.json")]
    if not paths:
        raise SystemExit(f"no chrome trace (*.json.gz, *.json) under "
                         f"{trace_dir}")
    return max(paths, key=os.path.getmtime)


def load_trace(trace_dir: str) -> List[dict]:
    path = newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def kernel_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel" and "dur" in e]


def group(name: str) -> str:
    """A kernel's op group: its name without the return type, template
    arguments, parameter list, namespaces and a numeric launch suffix."""
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


def _union(spans) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_share(kernels: List[dict]) -> Tuple[float, float]:
    """(busy µs, window µs): the union of the kernels' intervals, and the
    span from the first kernel's start to the last one's end."""
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in kernels)
    if not busy:
        return 0.0, 0.0
    return sum(e - s for s, e in busy), busy[-1][1] - busy[0][0]


def _scopes(events: List[dict]):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def idle_by_stage(events: List[dict], kernels: List[dict]
                  ) -> Dict[str, float]:
    """The card's idle µs inside the traced window (gaps between kernels),
    split by the `record_function` scope the host was in during each
    piece of a gap (the innermost where scopes nest); "(none)" outside
    every scope."""
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in kernels)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    cuts = sorted({t for s, e, _, _ in _scopes(events) for t in (s, e)})
    out: Dict[str, float] = collections.defaultdict(float)
    scopes = _scopes(events)
    for g0, g1 in gaps:
        points = [g0] + [t for t in cuts if g0 < t < g1] + [g1]
        for a, b in zip(points, points[1:]):
            mid = (a + b) / 2
            inner = [sc for sc in scopes if sc[0] <= mid <= sc[1]]
            name = (min(inner, key=lambda sc: sc[1] - sc[0])[2] if inner
                    else "(none)")
            out[name] += b - a
    return dict(out)


def by_group(kernels: List[dict]) -> Dict[str, Tuple[float, int]]:
    """group → (total µs, launches)."""
    out: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        g = out[group(e["name"])]
        g[0] += float(e["dur"])
        g[1] += 1
    return {k: (v[0], int(v[1])) for k, v in out.items()}


def by_op(events: List[dict], kernels: List[dict]
          ) -> Dict[Tuple[str, str], float]:
    """Kernel µs by (group, the torch op that launched it): a kernel event's
    "External id" names its op's cpu_op event ("?" for a launch outside
    any op, as the hand kernels' ctypes calls are)."""
    ops = {e.get("args", {}).get("External id"): e["name"] for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"}
    out: Dict[Tuple[str, str], float] = collections.defaultdict(float)
    for k in kernels:
        op = ops.get(k.get("args", {}).get("External id"), "?")
        out[(group(k["name"]), op)] += float(k["dur"])
    return dict(out)


def by_stage(events: List[dict], kernels: List[dict]) -> Dict[str, float]:
    """Kernel µs by the innermost `record_function` scope open on the
    launching thread when the kernel's launch call ran (matched through the
    launch's correlation id); "(none)" outside every scope."""
    scopes = collections.defaultdict(list)
    for s, e, name, tid in _scopes(events):
        scopes[tid].append((s, e, name))
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
    out: Dict[str, float] = collections.defaultdict(float)
    for k in kernels:
        where = launches.get(k.get("args", {}).get("correlation"))
        name = "(none)"
        if where is not None:
            tid, ts = where
            inner = [s for s in scopes.get(tid, ()) if s[0] <= ts <= s[1]]
            if inner:
                name = min(inner, key=lambda s: s[1] - s[0])[2]
        out[name] += float(k["dur"])
    return dict(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    trace_dir = argv[0]
    top_n = int(argv[1]) if len(argv) > 1 else 25
    events = load_trace(trace_dir)
    kernels = kernel_events(events)
    if not kernels:
        raise SystemExit(f"{newest_trace(trace_dir)}: no CUDA kernel events "
                         "(a CPU-only trace?)")
    groups = by_group(kernels)
    total = sum(us for us, _ in groups.values())
    busy, window = busy_share(kernels)
    print(f"{newest_trace(trace_dir)}: {len(kernels)} kernels, kernel total "
          f"{total / 1e3:.3f} ms; window {window / 1e3:.3f} ms, card busy "
          f"{busy / 1e3:.3f} ms = {100 * busy / window:.1f}% (idle "
          f"{100 - 100 * busy / window:.1f}%)")
    for name, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[
            :top_n]:
        print(f"{100 * us / total:5.1f}%  {us / 1e3:9.3f} ms  {n:6d}x  "
              f"{name}")
    print("by (group, launching op):")
    for (name, op), us in sorted(by_op(events, kernels).items(),
                                 key=lambda kv: -kv[1])[:top_n]:
        print(f"{100 * us / total:5.1f}%  {us / 1e3:9.3f} ms  {op:24s} {name}")
    stages = by_stage(events, kernels)
    if set(stages) != {"(none)"}:
        print("kernel time by stage (innermost record_function scope at "
              "launch):")
        for name, us in sorted(stages.items(), key=lambda kv: -kv[1]):
            print(f"{100 * us / total:5.1f}%  {us / 1e3:9.3f} ms  {name}")
        idle = idle_by_stage(events, kernels)
        print("card idle time by the host's stage meanwhile (% of the "
              "window):")
        for name, us in sorted(idle.items(), key=lambda kv: -kv[1]):
            print(f"{100 * us / window:5.1f}%  {us / 1e3:9.3f} ms  {name}")
    return groups, busy / window


if __name__ == "__main__":
    main()
