"""conv1 (7x7, stride 2, pad 3, t temporal taps) on 3-channel clips.

Port of detectandtrack_tpu/kernels/conv1.py: `conv1` runs the plain
PyTorch version, `conv1_reference`, for a CPU tensor; for a CUDA tensor it
dispatches by dtype to one of the two tensor-core implicit GEMMs in
`csrc/conv1.cu`, or raises: bf16 to `conv1_tc` (weights laid out by
`conv1_tc_weights`), f32 to `conv1_tf32` (weights laid out by
`conv1_tf32_weights`), which splits every f32 operand into two TF32 parts,
big = tf32(v) and small = tf32(v - big), and sums small*big + big*small +
big*big in f32: about 2^-22 of a product off, where one TF32 pass is off
by 2^-11 and would miss the 1e-4 f32 parity bound. `conv1_autograd` adds
the gradient to x and the weights, taken from the plain conv's autograd
(cuDNN on the card), as the JAX package's `_conv1_bwd` takes the vjp of
`_conv1_reference`.

Launch counts: `conv1.launches` (either kernel), `conv1.launches_tc` and
`conv1.launches_f32` (each kernel's own). Inside `utils.flops.count_flops`
a `conv1` call counts `roofline.conv1_flops`, whichever version ran.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..utils import roofline
from ..utils.flops import counted

_SMEM_LIMIT = 232448          # dynamic shared memory a block may use (H100)


def conv1_reference(x: torch.Tensor, k7: torch.Tensor, t: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """The plain conv: x (B, T, H, W, 3), k7 (t, 7, 7, 3, 64) →
    (B, T, ceil(H/2), ceil(W/2), 64) in `dtype`; temporal zero padding
    ((t-1)//2, t//2), spatial padding 3."""
    xc = x.to(dtype).permute(0, 4, 1, 2, 3)                 # (B, 3, T, H, W)
    xc = F.pad(xc, (3, 3, 3, 3, (t - 1) // 2, t // 2))
    w = k7.to(dtype).permute(4, 3, 0, 1, 2)                 # (64, 3, t, 7, 7)
    y = F.conv3d(xc, w, stride=(1, 2, 2))
    return y.permute(0, 2, 3, 4, 1)


TC_SLOTS = 24     # K slots per (kt, ky) group of the tensor-core kernel


def conv1_tc_weights(k7: torch.Tensor) -> torch.Tensor:
    """k7 (t, 7, 7, 3, 64) → the tensor-core kernel's (64, 24·7·t) weight
    matrix, K contiguous, in k7's dtype. K runs over (kt, ky, slot): slot s
    of a (kt, ky) group holds (kx, ci) = divmod(s - 1, 3) for s in 1..21;
    slots 0, 22 and 23 are zero (the kernel reads the value before a
    pixel's run in slot 0, so every bf16 pair it loads is aligned)."""
    t = k7.shape[0]
    w = F.pad(k7.reshape(t, 7, 21, 64), (0, 0, 1, TC_SLOTS - 22))
    return w.reshape(t * 7 * TC_SLOTS, 64).t().contiguous()


TF32_SLOTS = 24   # K slots per (kt, ky) group of the f32 kernel


def conv1_tf32_weights(k7: torch.Tensor) -> torch.Tensor:
    """k7 (t, 7, 7, 3, 64) → the f32 kernel's (64, 24·7·t) weight matrix,
    K contiguous, in k7's dtype. K runs over (kt, ky, slot): slot s of a
    (kt, ky) group holds (kx, ci) = divmod(s, 3) for s < 21; slots 21..23
    are zero (the kernel never loads their input values)."""
    t = k7.shape[0]
    w = F.pad(k7.reshape(t, 7, 21, 64), (0, 0, 0, TF32_SLOTS - 21))
    return w.reshape(t * 7 * TF32_SLOTS, 64).t().contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("conv1")
    lib.dat_conv1_tc.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
    lib.dat_conv1_tc.restype = ctypes.c_int
    lib.dat_conv1_tc_smem_bytes.argtypes = [ctypes.c_int]
    lib.dat_conv1_tc_smem_bytes.restype = ctypes.c_longlong
    lib.dat_conv1_tf32.argtypes = ([ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dat_conv1_tf32.restype = ctypes.c_int
    lib.dat_conv1_tf32_smem_bytes.argtypes = [ctypes.c_int]
    lib.dat_conv1_tf32_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_args(x: torch.Tensor, k7: torch.Tensor, t: int) -> None:
    if x.dim() != 5 or x.shape[-1] != 3:
        raise ValueError(f"conv1 kernel: x must be (B, T, H, W, 3), got "
                         f"{tuple(x.shape)}")
    if tuple(k7.shape) != (t, 7, 7, 3, 64):
        raise ValueError(f"conv1 kernel: weights must be ({t}, 7, 7, 3, 64), "
                         f"got {tuple(k7.shape)}")
    if k7.device != x.device:
        raise ValueError("conv1 kernel: x and weights on different devices")
    if x.shape[0] * x.shape[1] > 65535:
        raise ValueError("conv1 kernel: B*T must be <= 65535")


def _out(x: torch.Tensor, w: int, dtype: torch.dtype) -> torch.Tensor:
    b, nt, h = x.shape[:3]
    return torch.empty((b, nt, (h + 1) // 2, (w + 1) // 2, 64), dtype=dtype,
                       device=x.device)


def conv1_tf32(x: torch.Tensor, k7: torch.Tensor, t: int) -> torch.Tensor:
    """The f32 3-pass TF32 kernel on CUDA tensors: `conv1`'s f32 route. A
    clip width that is not a multiple of 4 gets zero columns on the right
    (exact: the conv pads with zeros there)."""
    _check_args(x, k7, t)
    lib = _lib()
    if lib.dat_conv1_tf32_smem_bytes(t) > _SMEM_LIMIT:
        raise ValueError(f"conv1 f32 kernel: t={t} weights do not fit "
                         "shared memory")
    b, nt, h, w, _ = x.shape
    x = x.to(torch.float32)
    if w % 4:
        x = F.pad(x, (0, 0, 0, 4 - w % 4))
    x = x.contiguous()
    wk = conv1_tf32_weights(k7.to(torch.float32))
    out = _out(x, w, torch.float32)
    with torch.cuda.device(x.device):
        err = lib.dat_conv1_tf32(x.data_ptr(), wk.data_ptr(), out.data_ptr(),
                                 b, nt, h, x.shape[3], (w + 1) // 2, t,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "conv1 f32 kernel launch")
    conv1.launches += 1
    conv1.launches_f32 += 1
    return out


def conv1_tc(x: torch.Tensor, k7: torch.Tensor, t: int) -> torch.Tensor:
    """The bf16 tensor-core kernel on CUDA tensors: `conv1`'s bf16 route.
    A clip width that is not a multiple of 8 gets zero columns on the
    right (exact: the conv pads with zeros there)."""
    _check_args(x, k7, t)
    lib = _lib()
    if lib.dat_conv1_tc_smem_bytes(t) > _SMEM_LIMIT:
        raise ValueError(f"conv1 tensor-core kernel: t={t} weights do not "
                         "fit shared memory")
    b, nt, h, w, _ = x.shape
    x = x.to(torch.bfloat16)
    if w % 8:
        x = F.pad(x, (0, 0, 0, 8 - w % 8))
    x = x.contiguous()
    wk = conv1_tc_weights(k7.to(torch.bfloat16))
    out = _out(x, w, torch.bfloat16)
    with torch.cuda.device(x.device):
        err = lib.dat_conv1_tc(x.data_ptr(), wk.data_ptr(), out.data_ptr(),
                               b, nt, h, x.shape[3], (w + 1) // 2, t,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "conv1 tensor-core kernel launch")
    conv1.launches += 1
    conv1.launches_tc += 1
    return out


@counted(lambda x, t, **_: roofline.conv1_flops(x.shape, t))
def conv1(x: torch.Tensor, k7: torch.Tensor, t: int,
          dtype: torch.dtype) -> torch.Tensor:
    """conv1 of the inflated ResNet → (B, T, ceil(H/2), ceil(W/2), 64).

    A CPU tensor runs `conv1_reference`. A CUDA tensor launches a kernel by
    `dtype` (x and k7 are cast to it; f32 accumulation), both on the
    tensor cores: bf16 `conv1_tc`, f32 the 3-pass TF32 `conv1_tf32`; any
    other dtype raises.
    """
    if not x.is_cuda:
        return conv1_reference(x, k7, t, dtype)
    if dtype == torch.bfloat16:
        return conv1_tc(x, k7, t)
    if dtype == torch.float32:
        return conv1_tf32(x, k7, t)
    raise TypeError(f"conv1 kernel: dtype {dtype} (f32 or bf16 only)")


conv1.launches = 0
conv1.launches_tc = 0
conv1.launches_f32 = 0


def conv1_backward(x: torch.Tensor, k7: torch.Tensor, t: int,
                   dtype: torch.dtype, grad: torch.Tensor,
                   needs: Tuple[bool, bool] = (True, True)
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Gradients of conv1 w.r.t. (x, k7) for the output gradient `grad`,
    each in its input's dtype (None where `needs` says no): the vjp of
    `conv1_reference`. Counts its calls in `conv1_backward.calls`."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(needs[0])
        kk = k7.detach().requires_grad_(needs[1])
        y = conv1_reference(xx, kk, t, dtype)
        wrt = [v for v, need in zip((xx, kk), needs) if need]
        got = iter(torch.autograd.grad(y, wrt, grad.to(dtype)))
    conv1_backward.calls += 1
    return tuple(next(got) if need else None for need in needs)


conv1_backward.calls = 0


class _Conv1Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k7, t, dtype):
        ctx.save_for_backward(x, k7)
        ctx.t, ctx.compute_dtype = t, dtype
        return conv1(x, k7, t, dtype)

    @staticmethod
    def backward(ctx, grad):
        x, k7 = ctx.saved_tensors
        dx, dk = conv1_backward(x, k7, ctx.t, ctx.compute_dtype, grad,
                                tuple(ctx.needs_input_grad[:2]))
        return dx, dk, None, None


def conv1_autograd(x: torch.Tensor, k7: torch.Tensor, t: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """`conv1` with a gradient to x and k7."""
    if torch.is_grad_enabled() and (x.requires_grad or k7.requires_grad):
        return _Conv1Function.apply(x, k7, t, dtype)
    return conv1(x, k7, t, dtype)
