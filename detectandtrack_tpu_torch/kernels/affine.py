"""The epilogue of a conv at inference in one pass: each frozen-BN affine or
conv bias, its residual or top-down add and its ReLU.

`affine_epilogue(y, scale, bias, shortcut, shortcut_scale, shortcut_bias,
relu)` computes act(y · s + b [+ r · s_r + b_r | + r]) over a conv output y
in the port's channels-last (..., C) layout:

- `scale` (may be None: a bias-only pass) and `bias` are the module's f32
  (C,) parameters, read as they are (no cast pass: the kernel rounds them
  to y's dtype in registers).
- `shortcut` (may be None) is at y's shape, or at half its H and W (y and
  r of at least 3 dims, (..., H, W, C)): then it is read nearest-upsampled
  ×2, the FPN's top-down add. With `shortcut_scale` and `shortcut_bias` it
  is a raw projection-conv output and gets its own affine.
- The arithmetic is the op chain the sites ran before, in its order: y ·
  s, + b, + (r · s_r + b_r) or + r, ReLU, each operation computed in f32
  and rounded to y's dtype (bf16 or f32), with the parameters cast to it
  first. A bf16 op of PyTorch rounds so, and so does the JAX package's
  flax `AffineChannel` under XLA on the CPU: a pass that rounds once at the
  end moves the bf16 port off JAX's outputs by more than its tests allow
  (the keypoint heatmaps by 5.4 bf16 ulps against 4).

A CPU tensor runs the plain version, `affine_epilogue_reference`. A CUDA
tensor launches `csrc/affine.cu`'s kernel on the current stream, or raises
(on a dtype other than bf16 and f32, a non-contiguous operand, a shape that
does not match, more than 512 channel groups: C / 8 in bf16, C / 4 in f32,
C where C is not a multiple of those or an operand is not 16-byte
aligned). Both write the result over y and return it: y must be a
conv's fresh output that nothing else holds. `affine_epilogue.launches`
counts the kernel's launches.

It replaces no Pallas kernel: in the JAX package XLA fuses the flax
`AffineChannel`, the add and the ReLU into the conv's consumers, where
PyTorch runs each as its own pass. Its bound is bytes (y read and written,
r read) over 3.35 TB/s (`utils/roofline.affine_work`).

The sites take it only where no gradient is needed (`wants_grad`): with a
gradient they run the op chain as autograd sees it.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Iterable, Optional

import torch

from . import _build

_DTYPES = (torch.bfloat16, torch.float32)
_PACK_BYTES = 16
_MAX_GROUPS = 512     # csrc/affine.cu kMaxThreads: a block spans the channels


def wants_grad(*tensors: Optional[torch.Tensor],
               params: Iterable[torch.Tensor] = ()) -> bool:
    """Whether autograd has to see ops on these operands: grad mode is on
    and one of them (or of `params`) requires a gradient. None counts as
    no operand."""
    if not torch.is_grad_enabled():
        return False
    return any(t is not None and t.requires_grad
               for t in itertools.chain(tensors, params))


def _upsampled(y: torch.Tensor, r: torch.Tensor) -> bool:
    """Whether r is y's shortcut read nearest-upsampled ×2 (r at half y's
    H and W); raises if r is at neither y's shape nor that."""
    if r.shape == y.shape:
        return False
    if (y.dim() >= 3 and r.dim() == y.dim()
            and r.shape[:-3] == y.shape[:-3] and r.shape[-1] == y.shape[-1]
            and 2 * r.shape[-3] == y.shape[-3]
            and 2 * r.shape[-2] == y.shape[-2]):
        return True
    raise ValueError(f"affine epilogue: shortcut {tuple(r.shape)} is neither "
                     f"y's {tuple(y.shape)} nor half its H and W")


def affine_epilogue_reference(y: torch.Tensor, scale: Optional[torch.Tensor],
                              bias: torch.Tensor,
                              shortcut: Optional[torch.Tensor] = None,
                              shortcut_scale: Optional[torch.Tensor] = None,
                              shortcut_bias: Optional[torch.Tensor] = None,
                              relu: bool = False) -> torch.Tensor:
    """The plain version: the op chain in y's dtype, written over y, which
    is returned."""
    dt = y.dtype
    v = y
    if scale is not None:
        v = v * scale.to(dt)
    v = v + bias.to(dt)
    if shortcut is not None:
        r = shortcut
        if _upsampled(y, shortcut):
            r = r.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        if shortcut_scale is not None:
            r = r * shortcut_scale.to(dt) + shortcut_bias.to(dt)
        v = v + r
    if relu:
        v = torch.relu(v)
    return y.copy_(v)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("affine")
    lib.dat_affine_epilogue.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7
        + [ctypes.c_void_p])
    lib.dat_affine_epilogue.restype = ctypes.c_int
    return lib


def _check_args(y, scale, bias, shortcut, shortcut_scale, shortcut_bias):
    if y.dtype not in _DTYPES:
        raise TypeError(f"affine epilogue kernel: dtype {y.dtype} (bf16 or "
                        "f32 only)")
    if y.dim() == 0 or not y.is_contiguous():
        raise ValueError("affine epilogue kernel: y must be a contiguous "
                         f"(..., C) tensor, got {tuple(y.shape)} strides "
                         f"{y.stride()}")
    c = y.shape[-1]
    for name, p in (("scale", scale), ("bias", bias),
                    ("shortcut_scale", shortcut_scale),
                    ("shortcut_bias", shortcut_bias)):
        if p is None:
            continue
        if (p.dtype != torch.float32 or tuple(p.shape) != (c,)
                or not p.is_contiguous() or p.device != y.device):
            raise ValueError(f"affine epilogue kernel: {name} must be a "
                             f"contiguous f32 ({c},) on {y.device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if (shortcut_scale is None) != (shortcut_bias is None):
        raise ValueError("affine epilogue kernel: shortcut_scale and "
                         "shortcut_bias go together")
    if shortcut is None:
        if shortcut_scale is not None:
            raise ValueError("affine epilogue kernel: a shortcut affine "
                             "without a shortcut")
        return
    if (shortcut.dtype != y.dtype or not shortcut.is_contiguous()
            or shortcut.device != y.device):
        raise ValueError(f"affine epilogue kernel: the shortcut must be a "
                         f"contiguous {y.dtype} tensor on {y.device}, got "
                         f"{shortcut.dtype} on {shortcut.device}")


def affine_epilogue(y: torch.Tensor, scale: Optional[torch.Tensor],
                    bias: torch.Tensor,
                    shortcut: Optional[torch.Tensor] = None,
                    shortcut_scale: Optional[torch.Tensor] = None,
                    shortcut_bias: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """act(y · s + b [+ r · s_r + b_r | + r]) written over y, returned (see
    the module docstring). A CPU tensor runs the plain version; a CUDA
    tensor the kernel, or raises."""
    if not y.is_cuda:
        return affine_epilogue_reference(y, scale, bias, shortcut,
                                         shortcut_scale, shortcut_bias, relu)
    _check_args(y, scale, bias, shortcut, shortcut_scale, shortcut_bias)
    c = y.shape[-1]
    up = shortcut is not None and _upsampled(y, shortcut)
    h, w = (y.shape[-3], y.shape[-2]) if up else (0, 0)
    if up and y.numel() // c >= 2 ** 32:
        raise ValueError("affine epilogue kernel: an upsampled shortcut "
                         "needs fewer than 2^32 positions")
    per_pack = _PACK_BYTES // y.element_size()
    vec = c % per_pack == 0 and all(
        t.data_ptr() % _PACK_BYTES == 0
        for t in (y, shortcut) if t is not None)
    group = per_pack if vec else 1
    if c // group > _MAX_GROUPS:
        raise ValueError(f"affine epilogue kernel: {c} channels make more "
                         f"than {_MAX_GROUPS} groups of {group}")
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = _lib()
    with torch.cuda.device(y.device):
        err = lib.dat_affine_epilogue(
            y.data_ptr(), ptr(shortcut), ptr(scale), bias.data_ptr(),
            ptr(shortcut_scale), ptr(shortcut_bias), y.numel() // c, c, h, w,
            int(up), int(relu), int(y.dtype == torch.bfloat16), int(vec),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "affine epilogue kernel launch")
    affine_epilogue.launches += 1
    return y


affine_epilogue.launches = 0
