"""Device milliseconds a clip of elementwise and reduction kernels
(PyTorch's elementwise, vectorised and reduce kernels: the frozen-BN
affines, ReLUs, adds, casts, pads, softmax) in the traced window."""

PATTERN = r"elementwise|reduce_kernel|Reduce|softmax|CatArrayBatchedCopy"


def read(view):
    us = view.trace.kernel_us(PATTERN)
    return us / 1e3 / view.units if us and view.units else None
