"""The FLOPs of one call: the numerator of the bench's MFU.

`count_flops(fn, *args)` runs `fn(*args)` once under
`torch.utils.flop_counter.FlopCounterMode`, which counts convolutions,
transposed convolutions and matrix products (2 FLOP per multiply-add,
forward and backward), and adds the FLOPs of every hand-kernel call made
in it, from `utils/roofline.py`. The kernels are bound through ctypes, so
the counter never sees them; their plain versions are torch ops, some of
which it does see (the plain conv1 is an F.conv3d). Each kernel's entry
point is wrapped by `counted`: inside a count it adds its roofline FLOPs
and takes back out whatever the counter saw during the call, so a call
counts the same whether its kernel or its plain version ran, once.

Elementwise work (activations, the frozen-BN affines, the optimizer's
update), NMS and sorting count nothing: the count is of model FLOPs, not
of every operation the card executes (XLA's cost analysis, which the JAX
bench divides by, also counts elementwise operations).
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, List

from torch.utils.flop_counter import FlopCounterMode

FLOPS_SOURCE = ("torch.utils.flop_counter.FlopCounterMode (convolutions, "
                "transposed convolutions, matrix products; forward and "
                "backward) + utils/roofline.py for each call of conv1, "
                "RoIAlign K1/K3, the RoIAlign backward and D; elementwise "
                "ops, NMS and sorts count 0")


class _Count:
    def __init__(self, counter: FlopCounterMode):
        self.counter = counter
        self.kernel_flops = 0.0


# The count in progress, if any. Module-level, not thread-local: autograd
# runs a CUDA backward on its own device thread, and the kernels' backward
# entry points must find the count there too.
_ACTIVE: List[_Count] = []


def count_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call `fn(*args, **kwargs)` (its result is dropped);
    see the module docstring for what counts. One count at a time. A
    captured function (`engine/graphs.py`) is counted through its `.eager`
    function: a graph replay runs no op the counter sees."""
    fn = getattr(fn, "eager", fn)
    if _ACTIVE:
        raise RuntimeError("count_flops: a count is already in progress")
    count = _Count(FlopCounterMode(display=False))
    _ACTIVE.append(count)
    try:
        with count.counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.clear()
    return float(count.counter.get_total_flops()) + count.kernel_flops


def counted(work: Callable[..., float]):
    """Decorator of a hand kernel's entry point: inside `count_flops`, a
    call adds `work(**arguments)` (the entry's arguments by name, defaults
    applied) and removes what FlopCounterMode saw during it. Outside a
    count it calls the entry as it is. The wrapper keeps `work` as
    `.work`, so a plain version can be counted by the same rule."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            count = _ACTIVE[0]
            seen = count.counter.get_total_flops()
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            count.kernel_flops += float(work(**bound.arguments)) - (
                count.counter.get_total_flops() - seen)
            return out

        entry.work = work
        return entry
    return wrap
