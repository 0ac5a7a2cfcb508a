"""Device milliseconds a frame of the `grouped_conv3x3_kernel` launches (the
body's grouped 3x3 convs with their frozen-BN epilogues) in the traced
window. None where no such kernel ran."""


def read(view):
    us = view.trace.kernel_us(r"grouped_conv3x3_kernel")
    return us / 1e3 / view.units if us and view.units else None
