"""The harness: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

It finds the cell's configuration, traffic and limits by name
(`manifest.py`), refuses to run without as many CUDA cards as the cell asks
for, and hands the rest to the traffic's driver (`drivers/<driver>.py`):

1. set-up: the driver builds the system from the seed, makes its inputs and
   warms up every shape the window uses; `setup_s` runs from the start of
   the process to here;
2. the window: the driver's loop for `--seconds`; with `--trace 1` it is
   followed by a second window of the traffic's `trace_seconds` under
   `torch.profiler`, inside the scope `bench/window`, from which the
   per-layer readers take device times;
3. the device's peak memory is read, the modules the process holds are
   checked for JAX and the JAX package, the system's state is freed;
4. the check: the driver compares what the window produced with the plain
   reference (`reference/`) and returns its numbers; each that
   `limits/<cell>.json` names is printed with its limit, and `correct` is
   that every one is within its limit and no unit of work failed.

A driver module defines `Driver(run)` with `setup()`, `window(seconds)` →
`Window`, `facts()` → what its per-layer readers need, `release()`,
`readings()` → every number of its check, and `control_readings(precision)`
→ the same of the reference in the system's place (`calibrate.py`).

The last line on standard output is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics, each from its reader `metrics/<metric>.py`), `device`,
with `--trace 1` a `breakdown`, then `card` and, last, `checks`. The
numbers compared are also the last lines on standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .manifest import HERE, Manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "detectandtrack_tpu", "bench"}
HOST_THREADS = 4         # few threads: steadier runs on a shared host
ROOT = HERE.parent


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, flax's,
    the JAX package's or the root bench's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of card 0, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


@dataclass
class Window:
    """What a driver's window did: units of work completed (clips, steps,
    frames) in `seconds`, requests attempted and failed, and the
    end-to-end values it measured by metric name."""
    units: int
    seconds: float
    attempted: int
    failed: int = 0
    values: Dict[str, float] = field(default_factory=dict)


@dataclass
class Run:
    """The harness's side of a run, handed to the driver."""
    cell: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: object = None
    spans: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def cfg(self) -> Dict:
        return self.config["cfg"]

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span: its seconds go to `spans[name]`; in a traced run it
        is also the profiler scope `bench/<name>`."""
        scope = contextlib.nullcontext()
        if self.trace:
            import torch
            scope = torch.profiler.record_function(f"bench/{name}")
        t0 = time.perf_counter()
        with scope:
            yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class LayerView:
    """What a per-layer reader reads: the traced window's Trace and the
    units of work completed in it; the units, seconds and host spans (in
    seconds, by name) of the untraced window that ran before it, since the
    profiler slows an eager host; and what the driver computed for the
    cell (FLOPs per unit, each kernel's least time per call, ...)."""
    trace: object
    units: int
    window_s: float
    rate_units: int
    rate_s: float
    spans: Dict[str, List[float]]
    facts: Dict[str, float]
    peak_flops: float


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def read_layers(manifest: Manifest, run: Run, driver, window: Window,
                rate: Window, rate_spans: Dict[str, List[float]], prof
                ) -> Tuple[Dict, Dict, Dict]:
    """(per-layer metrics, device's busy/window, breakdown) of a traced
    window; `rate` and `rate_spans` are the untraced window before it."""
    from . import trace as trace_mod
    from .roofline import peaks_for
    import torch

    tr = trace_mod.from_profiler(prof, "bench/window")
    name = (torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "H100 SXM")
    view = LayerView(trace=tr, units=window.units, window_s=window.seconds,
                     rate_units=rate.units, rate_s=rate.seconds,
                     spans=rate_spans, facts=driver.facts(),
                     peak_flops=peaks_for(name).bf16_flops)
    metrics = {}
    for m in manifest.per_layer(run.cell["name"]):
        value = manifest.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"busy_s": tr.busy_us() / 1e6, "window_s": tr.window_us / 1e6}
    breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    return metrics, device, breakdown


def main(argv, start: float) -> int:
    """Parse, refuse without the cards the cell needs, run, print."""
    args = parse(argv)
    manifest = Manifest.load()
    cell = manifest.cell(args.workload)
    run = Run(cell=cell, config=manifest.config(cell["config"]),
              traffic=manifest.traffic(cell["traffic"]),
              limits=manifest.limits(cell["name"]), seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace))
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        return fail("torch finds no CUDA device", 2)
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['name']} needs {cell['chips']} cards, torch "
                    f"finds {torch.cuda.device_count()}", 2)
    run.device = torch.device("cuda", 0)
    torch.cuda.set_device(run.device)
    try:
        result = execute(manifest, run, start)
    except ForbiddenModules as e:
        return fail(str(e), 4)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


class ForbiddenModules(RuntimeError):
    pass


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(manifest: Manifest, run: Run, start: float) -> Dict:
    """Set-up, window, check of `run` on `run.device` → the result line's
    object. On a CPU device (the tests) the device fields read the CPU."""
    import torch
    traffic = run.traffic
    torch.set_num_threads(HOST_THREADS)
    driver = manifest.driver(traffic).Driver(run)
    driver.setup()
    _sync(run.device)
    setup_s = time.perf_counter() - start

    window = driver.window(run.seconds)
    prof = None
    rate_spans = {k: list(v) for k, v in run.spans.items()}
    if run.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
        rate = window
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("bench/window"):
                window = driver.window(float(traffic["trace_seconds"]))
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules("the process holds modules of JAX or the JAX "
                               "package: " + ", ".join(bad))

    cell = run.cell
    if run.trace:
        metrics, dev_extra, breakdown = read_layers(
            manifest, run, driver, window, rate, rate_spans, prof)
        del prof
    else:
        metrics, dev_extra, breakdown = {}, {}, None
        values = dict(window.values, setup_s=setup_s)
        for m in manifest.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.readings()
    checks = [(k, float(readings[k]), float(lim))
              for k, lim in sorted(run.limits.items())]
    correct = window.failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": int(window.attempted),
              "failed": int(window.failed), "metrics": metrics,
              "device": dict({"platform": "gpu" if cuda else "cpu",
                              "kind": (torch.cuda.get_device_name(run.device)
                                       if cuda else "cpu"),
                              "count": 1, "memory_peak_bytes": int(peak)},
                             **dev_extra)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = card_line() if cuda else "cpu"
    result["checks"] = {name: {"value": float(v), "limit": float(lim)}
                        for name, v, lim in checks}
    return result
