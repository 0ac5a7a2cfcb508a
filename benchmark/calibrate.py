"""Readings for the limits of a cell's comparison, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 3] [--out FILE]

For each of `--seeds`: the cell's set-up and a window of `--seconds` at the
cell's own load, then its check: the system's gaps (the lower readings).
For each of `--control-seeds`: the control, the plain reference put in the
system's place and computed in the precision below the configuration's
(float8 for bfloat16), judged the same way (the upper readings). One JSON
line per seed on standard output and in `--out`. `limits/<cell>.json` is
set from these readings; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: torch finds no CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest.load()
    cell = manifest.cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def run_for(seed):
        return harness.Run(
            cell=cell, config=manifest.config(cell["config"]),
            traffic=manifest.traffic(cell["traffic"]),
            limits=manifest.limits(cell["name"]), seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0))

    def emit(kind, seed, checks, extra=None):
        line = json.dumps(dict({"workload": cell["name"], "kind": kind,
                                "seed": seed,
                                "checks": checks},
                               **(extra or {})))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def clear():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for s in [int(x) for x in args.seeds.split(",") if x]:
        run = run_for(s)
        driver = manifest.driver(run.traffic).Driver(run)
        t0 = time.perf_counter()
        driver.setup()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        w = driver.window(args.seconds)
        peak = torch.cuda.max_memory_allocated()
        driver.release()
        clear()
        t1 = time.perf_counter()
        emit("system", s, driver.readings(), {
            "values": w.values, "units": w.units, "setup_s": setup,
            "check_s": time.perf_counter() - t1, "peak": peak})
        del driver
        clear()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        run = run_for(s)
        driver = manifest.driver(run.traffic).Driver(run)
        emit("control", s, driver.control_readings("fp8"))
        del driver
        clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
