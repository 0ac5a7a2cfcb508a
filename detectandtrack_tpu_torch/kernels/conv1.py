"""conv1 (7x7, stride 2, pad 3, t temporal taps) on 3-channel clips.

Port of detectandtrack_tpu/kernels/conv1.py: `conv1` launches the CUDA
kernel in `csrc/conv1.cu` for a CUDA tensor and runs the plain PyTorch
version, `conv1_reference`, for a CPU tensor. `conv1_autograd` adds the
gradient to x and the weights, taken from the plain conv's autograd
(cuDNN on the card), as the JAX package's `_conv1_bwd` takes the vjp of
`_conv1_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_SMEM_LIMIT = 232448          # dynamic shared memory a block may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("conv1")
    lib.dat_conv1.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p])
    lib.dat_conv1.restype = ctypes.c_int
    lib.dat_conv1_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dat_conv1_smem_bytes.restype = ctypes.c_longlong
    return lib


def conv1(x: torch.Tensor, k7: torch.Tensor, t: int,
          dtype: torch.dtype) -> torch.Tensor:
    """conv1 of the inflated ResNet → (B, T, ceil(H/2), ceil(W/2), 64).

    A CPU tensor runs `conv1_reference`; a CUDA tensor launches the kernel
    (x and k7 are cast to `dtype`, f32 or bf16; f32 accumulation) or raises.
    """
    if not x.is_cuda:
        return conv1_reference(x, k7, t, dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"conv1 kernel: dtype {dtype} (f32 or bf16 only)")
    if x.dim() != 5 or x.shape[-1] != 3:
        raise ValueError(f"conv1 kernel: x must be (B, T, H, W, 3), got "
                         f"{tuple(x.shape)}")
    if tuple(k7.shape) != (t, 7, 7, 3, 64):
        raise ValueError(f"conv1 kernel: weights must be ({t}, 7, 7, 3, 64), "
                         f"got {tuple(k7.shape)}")
    if k7.device != x.device:
        raise ValueError("conv1 kernel: x and weights on different devices")
    x = x.to(dtype).contiguous()
    k7 = k7.to(dtype).contiguous()
    if k7.data_ptr() % 16:
        raise ValueError("conv1 kernel: weights must be 16-byte aligned")
    b, nt, h, w, _ = x.shape
    if b * nt > 65535:
        raise ValueError("conv1 kernel: B*T must be <= 65535")
    lib = _lib()
    if lib.dat_conv1_smem_bytes(t, _DTYPES[dtype]) > _SMEM_LIMIT:
        raise ValueError(f"conv1 kernel: t={t} weights do not fit shared "
                         f"memory in {dtype}")
    out = torch.empty((b, nt, (h + 1) // 2, (w + 1) // 2, 64), dtype=dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dat_conv1(x.data_ptr(), k7.data_ptr(), out.data_ptr(), b,
                            nt, h, w, t, _DTYPES[dtype],
                            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "conv1 kernel launch")
    conv1.launches += 1
    return out


conv1.launches = 0


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
