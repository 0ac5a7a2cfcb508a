"""Per-kernel-group roofline table from a capture_trace output directory.

    python3 -m detectandtrack_tpu_torch.tools.conv_roofline TRACE_DIR
        [--min-us-per-iter 100] [--top N] [--iters N] [--csv out.csv]

Port of tools/conv_roofline.py. For each CUDA kernel group of the newest
chrome trace under TRACE_DIR (names folded as tools/trace_summary.py
folds them) at or above the time threshold it prints: µs per iteration
(one traced request), share of kernel time, GFLOP per iteration, achieved
TFLOP/s, % of the card's peak for the work's type, the bound (the larger
of bytes over the memory rate and FLOP over the peak: "bytes" or
"operations") and `eff` = bound time / measured time.

FLOP and bytes come from TRACE_DIR/work.json, which capture_trace writes:
for cuDNN's and cuBLAS's kernels from torch's op counters, for the hand
kernels (conv1, K1, the RoIAlign backward, the diagnostic kernel) from
`utils/roofline`, the formulas chip_smoke.py states. Groups without work
(elementwise passes, NMS, copies) show time only. The peaks are those of
the card work.json names (`utils/roofline.peaks_for`); the iteration count
is work.json's unless --iters overrides it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from ..utils import roofline
from .trace_summary import by_group, kernel_events, load_trace


def build_rows(groups: Dict[str, tuple], work: Dict[str, dict], iters: int,
               peaks: Optional[roofline.Peaks]) -> List[dict]:
    """One row per kernel group, slowest first; work-derived columns are
    None for groups without work or without known peaks."""
    rows = []
    for name, (us, n) in groups.items():
        us_it = us / iters
        row = {"name": name, "us_per_iter": us_it, "launches_per_iter":
               n / iters, "gflop_per_iter": None, "tflops": None,
               "pct_peak": None, "gb_per_iter": None, "bound": None,
               "eff": None, "work_source": None}
        w = work.get(name)
        if w is not None:
            row["gflop_per_iter"] = w["flops"] / 1e9
            row["gb_per_iter"] = w["bytes"] / 1e9
            row["work_source"] = w.get("source")
            sec = us_it / 1e6
            if peaks is not None and sec > 0:
                wk = roofline.Work(w["bytes"], w["flops"], w["kind"])
                bound_ms, row["bound"] = roofline.bound(wk, peaks)
                row["tflops"] = w["flops"] / sec / 1e12
                row["pct_peak"] = 100 * w["flops"] / sec / peaks.flops(
                    w["kind"])
                row["eff"] = bound_ms / 1e3 / sec
        rows.append(row)
    rows.sort(key=lambda r: -r["us_per_iter"])
    return rows


def _fmt(v, spec):
    return "—" if v is None else format(v, spec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--min-us-per-iter", type=float, default=100.0)
    ap.add_argument("--top", type=int, default=0,
                    help="cap the rows after the threshold (0: no cap)")
    ap.add_argument("--iters", type=int, default=0,
                    help="override work.json's iteration count")
    ap.add_argument("--csv", default="")
    args = ap.parse_args(argv)

    work_path = os.path.join(args.trace_dir, "work.json")
    doc = {}
    if os.path.exists(work_path):
        with open(work_path) as f:
            doc = json.load(f)
    iters = args.iters or doc.get("iters", 1)
    try:
        peaks = roofline.peaks_for(doc.get("device", ""))
    except ValueError:
        peaks = None
    kernels = kernel_events(load_trace(args.trace_dir))
    if not kernels:
        raise SystemExit("no CUDA kernel events in the trace")
    rows = build_rows(by_group(kernels), doc.get("kernels", {}), iters,
                      peaks)
    total = sum(r["us_per_iter"] for r in rows)
    with_work = [r for r in rows if r["eff"] is not None]
    bound_us = sum(r["eff"] * r["us_per_iter"] for r in with_work)
    work_us = sum(r["us_per_iter"] for r in with_work)
    print(f"iters={iters}; {doc.get('card', 'card not recorded')}; peaks "
          f"{peaks.name if peaks else 'unknown'}; kernel total "
          f"{total / 1e3:.3f} ms/iter, {work_us / 1e3:.3f} ms of it in "
          f"groups with work, whose bounds sum to {bound_us / 1e3:.3f} ms "
          f"(eff {100 * bound_us / max(work_us, 1e-9):.1f}%)")
    print(f"{'us/it':>9} {'%tot':>5} {'n/it':>6} {'GFLOP':>8} {'TF/s':>7} "
          f"{'%peak':>6} {'GB':>7} {'bound':>10} {'eff':>5}  name")
    shown = [r for r in rows if r["us_per_iter"] >= args.min_us_per_iter]
    if args.top:
        shown = shown[:args.top]
    for r in shown:
        print(f"{r['us_per_iter']:9.1f} {100 * r['us_per_iter'] / total:5.1f}"
              f" {r['launches_per_iter']:6.1f}"
              f" {_fmt(r['gflop_per_iter'], '8.2f')}"
              f" {_fmt(r['tflops'], '7.1f')} {_fmt(r['pct_peak'], '6.1f')}"
              f" {_fmt(r['gb_per_iter'], '7.3f')}"
              f" {_fmt(r['bound'], '>10')} {_fmt(r['eff'], '5.2f')}"
              f"  {r['name']}")
    below = [r for r in rows if r["us_per_iter"] < args.min_us_per_iter]
    if below:
        bus = sum(r["us_per_iter"] for r in below)
        print(f"(+{len(below)} groups below the threshold: {bus / 1e3:.3f} "
              f"ms/iter = {100 * bus / total:.1f}%)")
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print("csv ->", args.csv)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
