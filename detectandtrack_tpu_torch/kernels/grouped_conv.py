"""A ResNeXt bottleneck's grouped 3x3 conv at inference, with its frozen-BN
affine, an optional residual add and its ReLU written by the conv itself.

`grouped_conv3x3(x, weight, scale, bias, stride, shortcut, relu)` computes
act(conv(x, w) · s + b [+ r]) over x (..., H, W, C) in the port's
channels-last layout, for a conv of `groups` = C / CG groups, a (C, CG, 1,
3, 3) weight, stride 1 or 2 in H and W and same-padding (1 on each side):
→ (..., Ho, Wo, C) with Ho = (H - 1) // stride + 1.

- The rounding is the op chain's (ROADMAP §2, `kernels/affine.py`): the
  conv's sums (f32) rounded to x's dtype first, as a conv's output is
  stored, then y · s, + b, + r, ReLU, each rounded to it, with s and b cast
  to it first. So the kernel equals its plain version within a conv's
  rounding (its f32 sums run in another order than cuDNN's), and its
  epilogue equals the chain bit for bit.
- A CPU tensor runs the plain version, `grouped_conv3x3_reference`
  (F.conv2d with `groups` + `affine_epilogue_reference`). A CUDA tensor
  launches `csrc/grouped_conv.cu`'s `grouped_conv3x3_kernel` on the current
  stream, or raises: x bf16, contiguous and 16-byte aligned, C a multiple of
  64, CG in WIDTHS, the shortcut bf16 at the output's shape.
  `grouped_conv3x3.launches` counts the kernel's launches.

It replaces no Pallas kernel: the JAX package's grouped conv is XLA's, with
the affine and ReLU fused into its consumers. Its bound is bytes (x read,
y written, the weights read once) over 3.35 TB/s, or at large CG its
FLOPs over the bf16 tensor-core peak (`utils/roofline.grouped_conv_work`).

`takes(conv, x, shortcut)` is the one place that decides this kernel
against cuDNN's grouped conv and the epilogue pass: `ConvAffine` asks it
where no gradient is needed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .affine import affine_epilogue_reference
from ..utils import roofline
from ..utils.flops import counted

KERNEL_NAME = "grouped_conv3x3_kernel"
# Channels a group the kernel computes.
WIDTHS = (4, 8, 16, 32)
_RANGE = 64                     # channels a block of the kernel owns


def takes(conv, x: torch.Tensor,
          shortcut: Optional[torch.Tensor] = None) -> bool:
    """Whether `conv` (a `Conv3d`) on x runs as `grouped_conv3x3`: x a bf16
    CUDA tensor, a grouped (1, 3, 3) conv without bias or dilation, stride
    1 or 2 in H and W only, channels a group in WIDTHS, C a multiple of
    64, no shortcut or one at the output's shape. The caller checks that
    no gradient is needed."""
    c = x.shape[-1]
    return (x.is_cuda and x.dtype == torch.bfloat16 and conv.groups > 1
            and conv.bias is None and conv.kernel == (1, 3, 3)
            and conv.dilation == (1, 1, 1)
            and conv.strides in ((1, 1, 1), (1, 2, 2))
            and c % _RANGE == 0
            and c // conv.groups in WIDTHS
            and conv.weight.shape[0] == c
            and (shortcut is None or shortcut.shape == _out_shape(
                x.shape, conv.strides[1])))


def _out_shape(shape, stride: int):
    h, w = shape[-3], shape[-2]
    return tuple(shape[:-3]) + ((h - 1) // stride + 1, (w - 1) // stride + 1,
                                shape[-1])


def grouped_conv3x3_reference(x: torch.Tensor, weight: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              stride: int,
                              shortcut: Optional[torch.Tensor] = None,
                              relu: bool = False) -> torch.Tensor:
    """The plain version: F.conv2d with groups in x's dtype, then the op
    chain (`affine_epilogue_reference`) → (..., Ho, Wo, C)."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    xc = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    wk = weight.to(x.dtype)[:, :, 0]
    y = F.conv2d(xc, wk, None, stride, 1, 1, c // weight.shape[1])
    y = y.movedim(1, -1).contiguous()
    y = y.reshape(tuple(lead) + tuple(y.shape[1:]))
    return affine_epilogue_reference(y, scale, bias, shortcut, relu=relu)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on its first launch (a model without
    grouped convs never builds it)."""
    lib = _build.load_library("grouped_conv")
    lib.dat_grouped_conv3x3.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.dat_grouped_conv3x3.restype = ctypes.c_int
    return lib


def _check_args(x, weight, scale, bias, stride, shortcut):
    if x.dtype != torch.bfloat16 or x.dim() < 3 or not x.is_contiguous():
        raise ValueError(f"grouped conv kernel: x must be a contiguous bf16 "
                         f"(..., H, W, C) tensor, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    if weight.dim() != 5 or weight.shape[0] != c or weight.shape[2:] != (
            1, 3, 3) or c % weight.shape[1]:
        raise ValueError(f"grouped conv kernel: weight {tuple(weight.shape)}"
                         f" is not ({c}, C / groups, 1, 3, 3)")
    if c % _RANGE or weight.shape[1] not in WIDTHS:
        raise ValueError(f"grouped conv kernel: {c} channels in groups of "
                         f"{weight.shape[1]} (C a multiple of {_RANGE}, "
                         f"groups of {WIDTHS})")
    if stride not in (1, 2):
        raise ValueError(f"grouped conv kernel: stride {stride} (1 or 2)")
    for name, p in (("weight", weight), ("scale", scale), ("bias", bias)):
        if (p.dtype != torch.float32 or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"grouped conv kernel: {name} must be a "
                             f"contiguous f32 tensor on {x.device}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"grouped conv kernel: scale and bias must be "
                         f"({c},)")
    if x.data_ptr() % 16:
        raise ValueError("grouped conv kernel: x must be 16-byte aligned")
    if shortcut is not None and (
            shortcut.dtype != x.dtype or not shortcut.is_contiguous()
            or shortcut.device != x.device or shortcut.data_ptr() % 16
            or tuple(shortcut.shape) != _out_shape(x.shape, stride)):
        raise ValueError(f"grouped conv kernel: the shortcut must be a "
                         f"contiguous, 16-byte aligned bf16 tensor of the "
                         f"output's shape {_out_shape(x.shape, stride)}")


def _flops(x, weight, stride, **_) -> float:
    h, w, c = x.shape[-3:]
    return roofline.grouped_conv_flops((x.numel() // (h * w * c), h, w, c),
                                       c // weight.shape[1], stride)


@counted(_flops)
def grouped_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, stride: int,
                    shortcut: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """act(conv(x, weight) · scale + bias [+ shortcut]) → (..., Ho, Wo, C)
    (see the module docstring). A CPU tensor runs the plain version; a
    CUDA tensor the kernel, or raises."""
    if not x.is_cuda:
        return grouped_conv3x3_reference(x, weight, scale, bias, stride,
                                         shortcut, relu)
    _check_args(x, weight, scale, bias, stride, shortcut)
    h, w, c = x.shape[-3:]
    n = x.numel() // (h * w * c)
    y = torch.empty(_out_shape(x.shape, stride), dtype=x.dtype,
                    device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dat_grouped_conv3x3(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), None if shortcut is None else shortcut.data_ptr(),
            y.data_ptr(), n, h, w, c, weight.shape[1], stride, int(relu),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "grouped conv kernel launch")
    grouped_conv3x3.launches += 1
    return y


grouped_conv3x3.launches = 0
