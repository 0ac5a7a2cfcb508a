"""Profiling and timing helpers (port of detectandtrack_tpu/utils/
profiling.py).

`trace(logdir)` wraps a region in a torch.profiler capture and exports a
chrome trace (`.json.gz`) into `logdir`, which `tools/trace_summary.py`
and `tools/conv_roofline.py` read. `device_time(fn, *args)` is the mean
seconds per call of `fn(*args)` with its outputs forced: on the card from
CUDA events on the current stream, on the CPU from the host clock, and only
because the caller's tensors are on the CPU. `time_call` returns the event
time and the host-clock time of the same calls side by side: they differ
where `fn` waits on the host (the NMS loops read a count back each round)
or where the host cannot enqueue work as fast as the card runs it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator, List

import torch


def _tensors(tree) -> Iterator[torch.Tensor]:
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _device_of(*trees) -> torch.device:
    """The device of the first tensor in `trees`; raises if there is none
    or it is neither the CPU nor a CUDA device."""
    for tree in trees:
        for t in _tensors(tree):
            if t.device.type not in ("cpu", "cuda"):
                raise ValueError(f"timing: tensors on {t.device} (CPU or "
                                 "CUDA only)")
            return t.device
    raise ValueError("timing: no tensor among the arguments or outputs, so "
                     "no device to time on")


@contextlib.contextmanager
def trace(logdir: str, device: str = "cuda", **kwargs):
    """Profile the enclosed region: CPU activity, plus CUDA activity when
    `device` is "cuda" (the default; raises without a card). Writes
    `logdir/trace_<pid>_<time>.json.gz` on exit; yields the profiler
    (`key_averages()`, `events()`). Extra keyword arguments go to
    `torch.profiler.profile` (`record_shapes`, `with_flops`, ...)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device; pass device='cpu' "
                               "to trace the CPU alone")
        activities.append(ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"trace: device {device!r} (cuda or cpu)")
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, **kwargs) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json.gz"))


def force_outputs(out) -> None:
    """Synchronise the device of `out`'s tensors (nested tuples, lists and
    dicts), then read one element of each."""
    leaves: List[torch.Tensor] = list(_tensors(out))
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    for t in leaves:
        if t.numel():
            t.reshape(-1)[:1].cpu()


@dataclass(frozen=True)
class Timing:
    seconds: float            # per call: CUDA events on the card, else host
    host_seconds: float       # per call, host clock, ending in the forcing
    device: str


def time_call(fn: Callable, *args, iters: int = 5,
              warmup: int = 1) -> Timing:
    """`fn(*args)` `warmup` times, then `iters` calls timed back to back.
    On the card, CUDA events on the current stream bracket the calls and
    the outputs are forced once after them (the stream runs every launch
    in order); the host clock spans the same calls and the forcing."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        force_outputs(out)
    if out is None and not any(True for _ in _tensors(args)):
        out = fn(*args)
    dev = _device_of(args, out)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
            force_outputs(out)
            host = (time.perf_counter() - t0) / iters
            return Timing(start.elapsed_time(end) / 1e3 / iters, host,
                          torch.cuda.get_device_name(dev))
    t0 = time.perf_counter()
    for _ in range(iters):
        force_outputs(fn(*args))
    host = (time.perf_counter() - t0) / iters
    return Timing(host, host, "cpu")


def device_time(fn: Callable, *args, iters: int = 5,
                warmup: int = 1) -> float:
    """Mean seconds per call of `fn(*args)` with forced outputs (CUDA
    events on the card, the host clock on the CPU)."""
    return time_call(fn, *args, iters=iters, warmup=warmup).seconds
