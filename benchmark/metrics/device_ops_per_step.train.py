"""Device operations a training step: the kernels, memory copies and sets
that start in the traced window (no scope's device shadow), over the steps
completed in it. An eager step pays the host's launch time for each."""


def read(view):
    lo, hi = view.trace.window
    n = sum(1 for _, s, _ in view.trace.kernels if lo <= s < hi)
    return n / view.units if n and view.units else None
