"""FPN RoIAlign(-3D) over slab-grouped rois.

Port of detectandtrack_tpu/kernels/roi_align.py (`assign_fpn_levels` and the
multilevel RoIAlign the detector runs): `roi_align_multilevel` launches the
CUDA gather kernel in `csrc/roi_align.cu` for CUDA tensors and runs the plain
PyTorch version, `roi_align_multilevel_reference`, for CPU tensors. Both are
exact for every roi, with the semantics of `roi_align_reference`:
roi_size = max(extent, 1), samples strictly outside [-1, size] count zero,
in-range samples clamp to [0, size-1], mean over all s² samples.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 8
_MAX_SAMPLES = 64


def assign_fpn_levels(rois: torch.Tensor, min_level: int, max_level: int,
                      canonical_scale: int = 224, canonical_level: int = 4
                      ) -> torch.Tensor:
    """FPN level of each (..., 4) roi, relative to min_level (int32).

    k = floor(k0 + log2(sqrt(area) / s0)), clamped to [min, max].
    """
    w = rois[..., 2] - rois[..., 0] + 1.0
    h = rois[..., 3] - rois[..., 1] + 1.0
    scale = torch.sqrt((w * h).clamp(min=1e-6))
    lvl = torch.floor(canonical_level
                      + torch.log2(scale / canonical_scale + 1e-8))
    lvl = lvl.clamp(min_level, max_level)
    return (lvl - min_level).to(torch.int32)


def roi_align_multilevel_reference(features: Sequence[torch.Tensor],
                                   strides: Sequence[int], rois: torch.Tensor,
                                   levels: torch.Tensor, output_size: int = 7,
                                   sampling_ratio: int = 2) -> torch.Tensor:
    """Plain exact FPN RoIAlign: per-level maps (S, H_l, W_l, C), rois
    (S, K, 4) image coords, levels (S, K) → (S, K, P, P, C) in the feature
    dtype, accumulated in f32 (4 bilinear corner gathers per sample)."""
    s_dim, _, _, c = features[0].shape
    k = rois.shape[1]
    p, s = output_size, sampling_ratio
    ps = p * s
    dev = rois.device
    hs = torch.tensor([f.shape[1] for f in features], dtype=torch.float32,
                      device=dev)
    ws = torch.tensor([f.shape[2] for f in features], dtype=torch.float32,
                      device=dev)
    sizes = [f.shape[1] * f.shape[2] for f in features]
    offs = torch.tensor([0] + list(torch.tensor(sizes).cumsum(0)[:-1]),
                        dtype=torch.long, device=dev)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32,
                          device=dev)
    flat = torch.cat([f.reshape(s_dim, -1, c) for f in features], dim=1)

    lvl = levels.long().clamp(0, len(features) - 1)
    h_l, w_l, base, sc = hs[lvl], ws[lvl], offs[lvl], scales[lvl]
    r = rois.float() * sc[..., None]
    x1, y1, x2, y2 = r.unbind(-1)
    bin_h = (y2 - y1).clamp(min=1.0) / p                      # (S, K)
    bin_w = (x2 - x1).clamp(min=1.0) / p

    iy = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
          + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5)
          / s).reshape(-1)                                    # (P·s,)
    ys = y1[..., None] + iy * bin_h[..., None]                # (S, K, P·s)
    xs = x1[..., None] + iy * bin_w[..., None]
    yv = (ys >= -1.0) & (ys <= h_l[..., None])
    xv = (xs >= -1.0) & (xs <= w_l[..., None])
    yc = torch.minimum(ys.clamp(min=0.0), h_l[..., None] - 1.0)
    xc = torch.minimum(xs.clamp(min=0.0), w_l[..., None] - 1.0)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    wy1 = yc - y0
    wx1 = xc - x0
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.minimum(y0i + 1, h_l[..., None].long() - 1)
    x1i = torch.minimum(x0i + 1, w_l[..., None].long() - 1)
    w_li = w_l.long()
    vw = (yv[..., :, None] & xv[..., None, :]).float() / (s * s)

    out = None
    for yi, wy in ((y0i, 1.0 - wy1), (y1i, wy1)):
        row = base[..., None] + yi * w_li[..., None]          # (S, K, P·s)
        for xi, wx in ((x0i, 1.0 - wx1), (x1i, wx1)):
            idx = (row[..., :, None] + xi[..., None, :]).reshape(s_dim, -1)
            g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            g = g.reshape(s_dim, k, ps, ps, c).float()
            term = g * (wy[..., :, None] * wx[..., None, :] * vw)[..., None]
            out = term if out is None else out + term
    out = out.reshape(s_dim, k, p, s, p, s, c).sum(dim=(3, 5))
    return out.to(features[0].dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("roi_align")
    lib.dat_roi_align_multilevel.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dat_roi_align_multilevel.restype = ctypes.c_int
    return lib


def roi_align_multilevel(features: Sequence[torch.Tensor],
                         strides: Sequence[int], rois: torch.Tensor,
                         levels: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """FPN RoIAlign(-3D): maps (S, H_l, W_l, C) per level, rois (S, K, 4)
    f32 image coords grouped by slab, levels (S, K) → (S, K, P, P, C).

    CPU tensors run `roi_align_multilevel_reference`; CUDA tensors launch
    the gather kernel or raise.
    """
    if not rois.is_cuda:
        return roi_align_multilevel_reference(features, strides, rois, levels,
                                              output_size, sampling_ratio)
    n_lvl = len(features)
    if not 1 <= n_lvl <= _MAX_LEVELS or len(strides) != n_lvl:
        raise ValueError(f"roi_align kernel: {n_lvl} levels, {len(strides)} "
                         f"strides (1..{_MAX_LEVELS} levels)")
    if output_size * sampling_ratio > _MAX_SAMPLES:
        raise ValueError("roi_align kernel: output_size * sampling_ratio "
                         f"must be <= {_MAX_SAMPLES}")
    s_dim, _, _, c = features[0].shape
    dtype = features[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align kernel: dtype {dtype} (f32 or bf16 only)")
    for f in features:
        if (f.dim() != 4 or f.shape[0] != s_dim or f.shape[3] != c
                or f.dtype != dtype or f.device != rois.device):
            raise ValueError("roi_align kernel: every level must be "
                             f"(S={s_dim}, H, W, C={c}) {dtype} on "
                             f"{rois.device}, got {tuple(f.shape)} "
                             f"{f.dtype} on {f.device}")
        if not f.is_contiguous():
            raise ValueError("roi_align kernel: level maps must be contiguous")
    k = rois.shape[1]
    if (tuple(rois.shape) != (s_dim, k, 4) or rois.dtype != torch.float32
            or not rois.is_contiguous()):
        raise ValueError(f"roi_align kernel: rois must be contiguous f32 "
                         f"({s_dim}, K, 4), got {tuple(rois.shape)} "
                         f"{rois.dtype}")
    if (tuple(levels.shape) != (s_dim, k) or levels.dtype != torch.int32
            or not levels.is_contiguous() or levels.device != rois.device):
        raise ValueError(f"roi_align kernel: levels must be contiguous int32 "
                         f"({s_dim}, {k}) on {rois.device}")
    if s_dim * k > 2 ** 31 - 1:
        raise ValueError("roi_align kernel: too many rois for one launch")

    p = output_size
    out = torch.empty((s_dim, k, p, p, c), dtype=dtype, device=rois.device)
    ptrs = (ctypes.c_void_p * n_lvl)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * n_lvl)(*[f.shape[1] for f in features])
    ws = (ctypes.c_int * n_lvl)(*[f.shape[2] for f in features])
    scales = (ctypes.c_float * n_lvl)(*[1.0 / st for st in strides])
    lib = _lib()
    with torch.cuda.device(rois.device):
        err = lib.dat_roi_align_multilevel(
            ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws),
            ctypes.addressof(scales), n_lvl, rois.data_ptr(),
            levels.data_ptr(), out.data_ptr(), s_dim, k, c, p, sampling_ratio,
            _DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "roi_align kernel launch")
    roi_align_multilevel.launches += 1
    return out


roi_align_multilevel.launches = 0
