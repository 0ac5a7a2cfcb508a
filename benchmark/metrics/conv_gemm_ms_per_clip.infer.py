"""Device milliseconds a clip of cuDNN's and cuBLAS's convolution and
matrix-product kernels in the traced window (the hand-written conv1,
RoIAlign and NMS kernels excluded)."""

PATTERN = (r"cudnn|cutlass|gemm|xmma|sm\d\d_|implicit_convolve|convolve|"
           r"wgrad|dgrad|fprop|conv2d|conv3d|Conv")
EXCLUDE = r"conv1_tc_kernel|conv1_tf32_kernel|roi_align|nms_"


def read(view):
    us = view.trace.kernel_us(PATTERN, EXCLUDE)
    return us / 1e3 / view.units if us and view.units else None
