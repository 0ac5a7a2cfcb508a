"""The model FLOPs of one unit of a cell's work, the numerator of its MFU.

The rule is the system's (`utils/flops.py` as it stood when the benchmark
was written), applied to the plain reference rather than to the system, so
the count is the same whatever implements the work: convolutions,
transposed convolutions and matrix products as
`torch.utils.flop_counter.FlopCounterMode` counts them (2 per
multiply-add, forward and backward), plus RoIAlign's corner products
(`reference/ops.roi_align`), which that counter does not see. Elementwise
work, NMS, sorts and the optimizer's update count 0.

The reference runs on the meta device: shapes only, no memory, no time.
"""

from __future__ import annotations

from typing import Callable

from torch.utils.flop_counter import FlopCounterMode

from .reference import ops

FLOPS_SOURCE = ("FlopCounterMode over the plain reference at the cell's "
                "shapes on the meta device + RoIAlign's 2 FLOP a corner tap; "
                "elementwise, NMS, sorts and the update count 0")


def count(fn: Callable[[], object]) -> float:
    """FLOPs of `fn()` by the rule above."""
    ops.take_roi_flops()
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops()) + ops.take_roi_flops()
