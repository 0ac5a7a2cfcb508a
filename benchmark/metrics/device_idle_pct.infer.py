"""The share of the traced window in which no kernel, copy or set ran on
the card: one minus the union of their intervals over the window. Read
under the profiler, whose host overhead a graphed call barely feels and an
eager step's every launch does."""


def read(view):
    w = view.trace.window_us
    if not w or not view.trace.kernels:
        return None
    return 100.0 * (1.0 - view.trace.busy_us() / w)
