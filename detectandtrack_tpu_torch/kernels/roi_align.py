"""RoIAlign(-3D) forward and backward.

Port of the RoIAlign kernels of detectandtrack_tpu/kernels/roi_align.py:

  roi_align_multilevel   K1, FPN RoIAlign over slab-grouped rois (S, K, 4)
                         (`roi_align_multilevel_pallas`);
  roi_align_pairs        K3, RoIAlign over N (roi, slab) pairs
                         (`_roi_align_pallas`), here with an optional level
                         per roi so one launch serves every entry point of
                         `roi_align_ops`;
  roi_align_backward     the gradient of both into the level maps (the JAX
                         package takes it from XLA's vjp of its dense form):
                         a prep kernel (`backward_prep`: each pair's key,
                         samples and footprint), a stable sort by key
                         (`backward_segments`), then a gather in which one
                         block owns each map tile.

Each launches its CUDA kernel in `csrc/roi_align.cu` for CUDA tensors and
runs its plain PyTorch version (`*_reference`) for CPU tensors. All are
exact for every roi, with the semantics of `roi_align_reference`:
roi_size = max(extent, 1), samples strictly outside [-1, size] count zero,
in-range samples clamp to [0, size-1], mean over all s² samples.
`roi_align_multilevel_autograd` and `roi_align_pairs_autograd` wrap the
forward and the backward in one `torch.autograd.Function` (gradient to the
level maps only; rois, levels and slabs get none), on CPU and CUDA alike.
Inside `utils.flops.count_flops` each call of the three entry points
counts its `roofline` FLOPs, whichever version ran.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from ..utils import roofline
from ..utils.flops import counted

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


def slab_of_rows(s_dim: int, k: int, device) -> torch.Tensor:
    """Slab of each row of a slab-grouped (S, K) roi table, flattened."""
    return torch.arange(s_dim, dtype=torch.int32,
                        device=device).repeat_interleave(k)


def _taps(shapes: Sequence[Sequence[int]], strides: Sequence[int],
          rois: torch.Tensor, slabs: torch.Tensor, levels: torch.Tensor,
          p: int, s: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The 4 bilinear taps of every sample of N rois: (row index (N, P·s,
    P·s) into the level maps flattened and concatenated as (Σ S·H_l·W_l, C)
    rows, weight (N, P·s, P·s) f32 with validity and the 1/s² mean)."""
    dev = rois.device
    n_slabs = shapes[0][0]
    hs = torch.tensor([sh[1] for sh in shapes], dtype=torch.float32,
                      device=dev)
    ws = torch.tensor([sh[2] for sh in shapes], dtype=torch.float32,
                      device=dev)
    sizes = [sh[0] * sh[1] * sh[2] for sh in shapes]
    offs = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                        dtype=torch.long, device=dev)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32,
                          device=dev)

    lvl = levels.long().clamp(0, len(shapes) - 1)
    slab = slabs.long().clamp(0, n_slabs - 1)
    h_l, w_l, sc = hs[lvl], ws[lvl], scales[lvl]
    base = offs[lvl] + slab * (h_l * w_l).long()
    r = rois.float() * sc[:, None]
    x1, y1, x2, y2 = r.unbind(-1)
    bin_h = (y2 - y1).clamp(min=1.0) / p                      # (N,)
    bin_w = (x2 - x1).clamp(min=1.0) / p

    iy = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
          + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5)
          / s).reshape(-1)                                    # (P·s,)
    ys = y1[:, None] + iy * bin_h[:, None]                    # (N, P·s)
    xs = x1[:, None] + iy * bin_w[:, None]
    yv = (ys >= -1.0) & (ys <= h_l[:, None])
    xv = (xs >= -1.0) & (xs <= w_l[:, None])
    # A NaN sample is invalid (weight 0) and, as in the kernel, clamps to 0.
    ys, xs = ys.nan_to_num(0.0), xs.nan_to_num(0.0)
    yc = torch.minimum(ys.clamp(min=0.0), h_l[:, None] - 1.0)
    xc = torch.minimum(xs.clamp(min=0.0), w_l[:, None] - 1.0)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    wy1 = yc - y0
    wx1 = xc - x0
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.minimum(y0i + 1, h_l[:, None].long() - 1)
    x1i = torch.minimum(x0i + 1, w_l[:, None].long() - 1)
    w_li = w_l.long()
    vw = (yv[:, :, None] & xv[:, None, :]).float() / (s * s)

    taps = []
    for yi, wy in ((y0i, 1.0 - wy1), (y1i, wy1)):
        row = base[:, None] + yi * w_li[:, None]              # (N, P·s)
        for xi, wx in ((x0i, 1.0 - wx1), (x1i, wx1)):
            taps.append((row[:, :, None] + xi[:, None, :],
                         wy[:, :, None] * wx[:, None, :] * vw))
    return taps


def backward_footprint(shapes: Sequence[Sequence[int]],
                       strides: Sequence[int], rois: torch.Tensor,
                       levels: Optional[torch.Tensor], p: int, s: int
                       ) -> torch.Tensor:
    """Each of N rois' footprint on its level, (N, 4) int32 (y0, y1, x0,
    x1), half-open: the cells that the bilinear corners of its valid
    samples touch, widened by one cell on every side and clamped to the
    map; all zero where no sample is valid on one of the axes. Every
    nonzero tap of `_taps` lies inside (the backward kernel's tiles skip a
    pair whose footprint misses them, so a footprint too narrow would drop
    gradient; the slack of one cell covers any last-ulp difference in the
    sample positions). The backward's prep kernel mirrors this rule."""
    dev = rois.device
    n = rois.shape[0]
    lvl = _level_index(levels, n, dev).long().clamp(0, len(shapes) - 1)
    hs = torch.tensor([sh[1] for sh in shapes], device=dev)[lvl]
    ws = torch.tensor([sh[2] for sh in shapes], device=dev)[lvl]
    sc = torch.tensor([1.0 / st for st in strides], dtype=torch.float32,
                      device=dev)[lvl]
    x1, y1, x2, y2 = (rois.float() * sc[:, None]).unbind(-1)
    iy = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
          + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5)
          / s).reshape(-1)
    out = []
    for start, end, size in ((y1, y2, hs), (x1, x2, ws)):
        c = start[:, None] + iy * ((end - start).clamp(min=1.0) / p)[:, None]
        valid = (c >= -1.0) & (c <= size[:, None])
        cc = torch.minimum(c.nan_to_num(0.0).clamp(min=0.0),
                           size[:, None] - 1.0)
        lo = torch.floor(cc).long()
        hi = torch.minimum(lo + 1, size[:, None] - 1)
        a = torch.where(valid, lo, torch.iinfo(torch.long).max).amin(1)
        b = torch.where(valid, hi, -1).amax(1)
        out += [(a - 1).clamp(min=0), torch.minimum(b + 2, size)]
    fp = torch.stack(out, 1)
    empty = (fp[:, 0] >= fp[:, 1]) | (fp[:, 2] >= fp[:, 3])
    return torch.where(empty[:, None], 0, fp).to(torch.int32)


def backward_keys(n_slabs: int, n_levels: int, slabs: torch.Tensor,
                  levels: Optional[torch.Tensor]) -> torch.Tensor:
    """Each pair's key slab · L + level (int32), both clamped as the
    kernels clamp them: the backward tiles of one (slab, level) visit
    exactly the pairs of one key."""
    lvl = _level_index(levels, slabs.shape[0], slabs.device)
    return (slabs.clamp(0, n_slabs - 1) * n_levels
            + lvl.clamp(0, n_levels - 1)).to(torch.int32)


def backward_segments(keys: torch.Tensor, n_keys: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pairs sorted by key, stably (int64 (N,)), and the first of each
    key's pairs in that order (int32 (n_keys + 1,), the last entry N):
    key k's pairs are order[seg[k]:seg[k + 1]], in index order. No host
    synchronisation (searchsorted, not bincount)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    seg = torch.searchsorted(
        sorted_keys, torch.arange(n_keys + 1, dtype=torch.int32,
                                  device=keys.device), out_int32=True)
    return order, seg


def _level_index(levels: Optional[torch.Tensor], n: int, device
                 ) -> torch.Tensor:
    if levels is None:
        return torch.zeros((n,), dtype=torch.int32, device=device)
    return levels


def roi_align_pairs_reference(features: Sequence[torch.Tensor],
                              strides: Sequence[int], rois: torch.Tensor,
                              slabs: torch.Tensor,
                              levels: Optional[torch.Tensor] = None,
                              output_size: int = 7, sampling_ratio: int = 2
                              ) -> torch.Tensor:
    """Plain exact RoIAlign over (roi, slab) pairs: per-level maps
    (S, H_l, W_l, C), rois (N, 4) in coordinates that 1/strides[level]
    scales to the level's map, slabs (N,), levels (N,) or None (level 0) →
    (N, P, P, C) in the feature dtype, accumulated in f32 (4 bilinear
    corner gathers per sample)."""
    n = rois.shape[0]
    c = features[0].shape[-1]
    p, s = output_size, sampling_ratio
    ps = p * s
    levels = _level_index(levels, n, rois.device)
    flat = torch.cat([f.reshape(-1, c) for f in features])
    out = None
    for idx, w in _taps([f.shape for f in features], strides, rois, slabs,
                        levels, p, s):
        g = flat.index_select(0, idx.reshape(-1)).reshape(n, ps, ps, c)
        term = g.float() * w[..., None]
        out = term if out is None else out + term
    out = out.reshape(n, p, s, p, s, c).sum(dim=(2, 4))
    return out.to(features[0].dtype)


def roi_align_multilevel_reference(features: Sequence[torch.Tensor],
                                   strides: Sequence[int], rois: torch.Tensor,
                                   levels: torch.Tensor, output_size: int = 7,
                                   sampling_ratio: int = 2) -> torch.Tensor:
    """Plain exact FPN RoIAlign: per-level maps (S, H_l, W_l, C), rois
    (S, K, 4) image coords, levels (S, K) → (S, K, P, P, C) in the feature
    dtype, accumulated in f32."""
    s_dim, k = rois.shape[:2]
    out = roi_align_pairs_reference(
        features, strides, rois.reshape(-1, 4),
        slab_of_rows(s_dim, k, rois.device), levels.reshape(-1),
        output_size, sampling_ratio)
    return out.reshape((s_dim, k) + out.shape[1:])


def roi_align_backward_reference(shapes: Sequence[Sequence[int]],
                                 dtype: torch.dtype, strides: Sequence[int],
                                 rois: torch.Tensor, slabs: torch.Tensor,
                                 levels: Optional[torch.Tensor],
                                 grad: torch.Tensor, output_size: int = 7,
                                 sampling_ratio: int = 2
                                 ) -> List[torch.Tensor]:
    """Plain gradient of `roi_align_pairs_reference` w.r.t. the level maps:
    grad (N, P, P, C) is spread over the same taps with `index_add_` into
    f32 maps of the given (S, H_l, W_l, C) shapes, returned in `dtype`."""
    n, p, _, c = grad.shape
    s = sampling_ratio
    ps = p * s
    levels = _level_index(levels, n, rois.device)
    g = grad.float().reshape(n, p, 1, p, 1, c).expand(n, p, s, p, s, c)
    g = g.reshape(n, ps, ps, c)
    sizes = [sh[0] * sh[1] * sh[2] for sh in shapes]
    acc = torch.zeros((sum(sizes), c), dtype=torch.float32,
                      device=grad.device)
    for idx, w in _taps(shapes, strides, rois, slabs, levels, p, s):
        acc.index_add_(0, idx.reshape(-1), (g * w[..., None]).reshape(-1, c))
    return [m.reshape(tuple(sh)).to(dtype)
            for m, sh in zip(acc.split(sizes), shapes)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("roi_align")
    lib.dat_roi_align_multilevel.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dat_roi_align_multilevel.restype = ctypes.c_int
    lib.dat_roi_align_pairs.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dat_roi_align_backward_prep.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.dat_roi_align_backward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    for fn in (lib.dat_roi_align_pairs, lib.dat_roi_align_backward_prep,
               lib.dat_roi_align_backward):
        fn.restype = ctypes.c_int
    return lib


def _level_table(ptrs: Sequence[int], shapes: Sequence[Sequence[int]],
                 strides: Sequence[int]):
    n_lvl = len(shapes)
    return ((ctypes.c_void_p * n_lvl)(*ptrs),
            (ctypes.c_int * n_lvl)(*[sh[1] for sh in shapes]),
            (ctypes.c_int * n_lvl)(*[sh[2] for sh in shapes]),
            (ctypes.c_float * n_lvl)(*[1.0 / st for st in strides]))


def _check_call(what: str, shapes: Sequence[Sequence[int]], dtype,
                strides: Sequence[int], output_size: int,
                sampling_ratio: int) -> None:
    """The launch limits every kernel entry shares."""
    n_lvl = len(shapes)
    if not 1 <= n_lvl <= _MAX_LEVELS or len(strides) != n_lvl:
        raise ValueError(f"{what}: {n_lvl} levels, {len(strides)} strides "
                         f"(1..{_MAX_LEVELS} levels)")
    if output_size * sampling_ratio > _MAX_SAMPLES:
        raise ValueError(f"{what}: output_size * sampling_ratio must be <= "
                         f"{_MAX_SAMPLES}")
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {dtype} (f32 or bf16 only)")
    s_dim, _, _, c = shapes[0]
    for sh in shapes:
        if len(sh) != 4 or sh[0] != s_dim or sh[3] != c:
            raise ValueError(f"{what}: every level must be (S={s_dim}, H, W, "
                             f"C={c}), got {tuple(sh)}")


def _check_maps(what: str, features: Sequence[torch.Tensor],
                device) -> None:
    dtype = features[0].dtype
    for f in features:
        if f.dtype != dtype or f.device != device:
            raise ValueError(f"{what}: level maps must all be {dtype} on "
                             f"{device}, got {f.dtype} on {f.device}")
        if not f.is_contiguous():
            raise ValueError(f"{what}: level maps must be contiguous")


def _check_index(what: str, name: str, t: Optional[torch.Tensor], n: int,
                 device) -> None:
    if t is None:
        return
    if (tuple(t.shape) != (n,) or t.dtype != torch.int32
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{what}: {name} must be contiguous int32 ({n},) "
                         f"on {device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def _forward_flops(features, rois, output_size, sampling_ratio, **_):
    return roofline.roi_align_flops(rois.numel() // 4, output_size,
                                    features[0].shape[-1], sampling_ratio)


@counted(_forward_flops)
def roi_align_multilevel(features: Sequence[torch.Tensor],
                         strides: Sequence[int], rois: torch.Tensor,
                         levels: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """FPN RoIAlign(-3D): maps (S, H_l, W_l, C) per level, rois (S, K, 4)
    f32 image coords grouped by slab, levels (S, K) → (S, K, P, P, C).

    CPU tensors run `roi_align_multilevel_reference`; CUDA tensors launch
    the gather kernel (K1) or raise. No gradient: see
    `roi_align_multilevel_autograd`.
    """
    if not rois.is_cuda:
        return roi_align_multilevel_reference(features, strides, rois, levels,
                                              output_size, sampling_ratio)
    what = "roi_align kernel"
    shapes = [tuple(f.shape) for f in features]
    _check_call(what, shapes, features[0].dtype, strides, output_size,
                sampling_ratio)
    _check_maps(what, features, rois.device)
    s_dim, _, _, c = shapes[0]
    dtype = features[0].dtype
    k = rois.shape[1]
    if (tuple(rois.shape) != (s_dim, k, 4) or rois.dtype != torch.float32
            or not rois.is_contiguous()):
        raise ValueError(f"{what}: rois must be contiguous f32 "
                         f"({s_dim}, K, 4), got {tuple(rois.shape)} "
                         f"{rois.dtype}")
    if (tuple(levels.shape) != (s_dim, k) or levels.dtype != torch.int32
            or not levels.is_contiguous() or levels.device != rois.device):
        raise ValueError(f"{what}: levels must be contiguous int32 "
                         f"({s_dim}, {k}) on {rois.device}")
    if s_dim * k > 2 ** 31 - 1:
        raise ValueError(f"{what}: too many rois for one launch")

    p = output_size
    out = torch.empty((s_dim, k, p, p, c), dtype=dtype, device=rois.device)
    ptrs, hs, ws, scales = _level_table([f.data_ptr() for f in features],
                                        shapes, strides)
    lib = _lib()
    with torch.cuda.device(rois.device):
        err = lib.dat_roi_align_multilevel(
            ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws),
            ctypes.addressof(scales), len(shapes), rois.data_ptr(),
            levels.data_ptr(), out.data_ptr(), s_dim, k, c, p, sampling_ratio,
            _DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{what} launch")
    roi_align_multilevel.launches += 1
    return out


roi_align_multilevel.launches = 0


def _check_pairs(what: str, shapes, rois: torch.Tensor, slabs: torch.Tensor,
                 levels: Optional[torch.Tensor]) -> int:
    n = rois.shape[0]
    if (tuple(rois.shape) != (n, 4) or rois.dtype != torch.float32
            or not rois.is_contiguous()):
        raise ValueError(f"{what}: rois must be contiguous f32 (N, 4), got "
                         f"{tuple(rois.shape)} {rois.dtype}")
    _check_index(what, "slabs", slabs, n, rois.device)
    _check_index(what, "levels", levels, n, rois.device)
    if n > 2 ** 31 - 1:
        raise ValueError(f"{what}: too many rois for one launch")
    return n


@counted(_forward_flops)
def roi_align_pairs(features: Sequence[torch.Tensor],
                    strides: Sequence[int], rois: torch.Tensor,
                    slabs: torch.Tensor,
                    levels: Optional[torch.Tensor] = None,
                    output_size: int = 7, sampling_ratio: int = 2
                    ) -> torch.Tensor:
    """RoIAlign over N (roi, slab) pairs: maps (S, H_l, W_l, C) per level,
    rois (N, 4) f32 that 1/strides[level] scales to the level's map, slabs
    (N,) int32, levels (N,) int32 or None (level 0) → (N, P, P, C).

    CPU tensors run `roi_align_pairs_reference`; CUDA tensors launch the
    gather kernel (K3) or raise. Out-of-range slabs and levels clamp.
    """
    if not rois.is_cuda:
        return roi_align_pairs_reference(features, strides, rois, slabs,
                                         levels, output_size, sampling_ratio)
    what = "roi_align pairs kernel"
    shapes = [tuple(f.shape) for f in features]
    _check_call(what, shapes, features[0].dtype, strides, output_size,
                sampling_ratio)
    _check_maps(what, features, rois.device)
    n = _check_pairs(what, shapes, rois, slabs, levels)
    s_dim, _, _, c = shapes[0]
    dtype = features[0].dtype
    p = output_size
    out = torch.empty((n, p, p, c), dtype=dtype, device=rois.device)
    ptrs, hs, ws, scales = _level_table([f.data_ptr() for f in features],
                                        shapes, strides)
    lib = _lib()
    with torch.cuda.device(rois.device):
        err = lib.dat_roi_align_pairs(
            ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws),
            ctypes.addressof(scales), len(shapes), rois.data_ptr(),
            slabs.data_ptr(), 0 if levels is None else levels.data_ptr(),
            out.data_ptr(), n, s_dim, c, p, sampling_ratio, _DTYPES[dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{what} launch")
    roi_align_pairs.launches += 1
    return out


roi_align_pairs.launches = 0


def backward_prep(shapes: Sequence[Sequence[int]], strides: Sequence[int],
                  rois: torch.Tensor, slabs: torch.Tensor,
                  levels: Optional[torch.Tensor], p: int, s: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (roi, slab) pair's key and footprint, as the backward kernel
    visits them: (`backward_keys` (N,), `backward_footprint` (N, 4)).

    CPU tensors run those plain functions; CUDA tensors launch the prep
    kernel, which mirrors them, or raise.
    """
    if not rois.is_cuda:
        return (backward_keys(shapes[0][0], len(shapes), slabs, levels),
                backward_footprint(shapes, strides, rois, levels, p, s))
    what = "roi_align backward prep kernel"
    shapes = [tuple(sh) for sh in shapes]
    _check_call(what, shapes, torch.float32, strides, p, s)
    _check_pairs(what, shapes, rois, slabs, levels)
    _, hs, ws, scales = _level_table([0] * len(shapes), shapes, strides)
    with torch.cuda.device(rois.device):
        return _launch_prep(_lib(), (hs, ws, scales), shapes, rois, slabs,
                            levels, p, s)[:2]


backward_prep.launches = 0


def _launch_prep(lib, tables, shapes, rois, slabs, levels, p, s):
    """The prep kernel alone, on checked inputs, on the current device →
    (keys, footprints, samples), views of one 16-byte aligned buffer:
    samples (N, 2, P·s, 4) f32 (lo and hi as int32 bits, then wlo and
    whi, zero for an invalid sample; y then x), footprints (N, 4) int32,
    keys (N,) int32."""
    n = rois.shape[0]
    n_smp = n * 2 * p * s * 4
    buf = torch.empty((n_smp + 5 * n,), dtype=torch.int32, device=rois.device)
    samples = buf[:n_smp]
    footprints = buf[n_smp:n_smp + 4 * n].view(n, 4)
    keys = buf[n_smp + 4 * n:]
    hs, ws, scales = tables
    err = lib.dat_roi_align_backward_prep(
        ctypes.addressof(hs), ctypes.addressof(ws), ctypes.addressof(scales),
        len(shapes), rois.data_ptr(), slabs.data_ptr(),
        0 if levels is None else levels.data_ptr(), keys.data_ptr(),
        footprints.data_ptr(), samples.data_ptr(), n, shapes[0][0], p, s,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "roi_align backward prep kernel launch")
    backward_prep.launches += 1
    return keys, footprints, samples


@counted(lambda grad, sampling_ratio, **_: roofline.backward_flops(
    grad.numel(), sampling_ratio))
def roi_align_backward(shapes: Sequence[Sequence[int]], dtype: torch.dtype,
                       strides: Sequence[int], rois: torch.Tensor,
                       slabs: torch.Tensor, levels: Optional[torch.Tensor],
                       grad: torch.Tensor, output_size: int = 7,
                       sampling_ratio: int = 2) -> List[torch.Tensor]:
    """Gradient of `roi_align_pairs` w.r.t. its level maps, for maps of
    the given (S, H_l, W_l, C) shapes: grad (N, P, P, C) → one map per
    level in `dtype` (summed in f32).

    CPU tensors run `roi_align_backward_reference`; CUDA tensors launch the
    prep kernel (`backward_prep`), sort the pairs (`backward_segments`)
    and launch the tile-owned gather kernel, or raise. The gather writes
    every cell of the maps once, in `dtype`, with no atomics, so two calls
    agree bit for bit.
    """
    if not grad.is_cuda:
        return roi_align_backward_reference(shapes, dtype, strides, rois,
                                            slabs, levels, grad, output_size,
                                            sampling_ratio)
    what = "roi_align backward kernel"
    shapes = [tuple(sh) for sh in shapes]
    _check_call(what, shapes, dtype, strides, output_size, sampling_ratio)
    n = _check_pairs(what, shapes, rois, slabs, levels)
    p = output_size
    c = shapes[0][3]
    if (tuple(grad.shape) != (n, p, p, c) or grad.dtype not in _DTYPES
            or not grad.is_contiguous() or grad.device != rois.device):
        raise ValueError(f"{what}: grad must be contiguous f32/bf16 "
                         f"({n}, {p}, {p}, {c}) on {rois.device}, got "
                         f"{tuple(grad.shape)} {grad.dtype} on {grad.device}")
    sizes = [sh[0] * sh[1] * sh[2] * sh[3] for sh in shapes]
    out = torch.empty((sum(sizes),), dtype=dtype, device=grad.device)
    maps = [m.view(sh) for m, sh in zip(out.split(sizes), shapes)]
    ptrs, hs, ws, scales = _level_table([m.data_ptr() for m in maps], shapes,
                                        strides)
    lib = _lib()
    with torch.cuda.device(grad.device):
        keys, footprints, samples = _launch_prep(
            lib, (hs, ws, scales), shapes, rois, slabs, levels, p,
            sampling_ratio)
        order, seg = backward_segments(keys, shapes[0][0] * len(shapes))
        _launch_gather(lib, (ptrs, hs, ws, scales), shapes, dtype, order, seg,
                       footprints.index_select(0, order), samples, grad,
                       sampling_ratio)
    roi_align_backward.launches += 1
    return maps


roi_align_backward.launches = 0


def _launch_gather(lib, tables, shapes, dtype, order, seg, footprints,
                   samples, grad, sampling_ratio) -> None:
    """The gather kernel alone, on checked inputs (`footprints` in the
    sorted order, `samples` the prep kernel's), on the current device,
    into the maps whose pointers `tables` holds."""
    n, p, _, c = grad.shape
    ptrs, hs, ws, scales = tables
    err = lib.dat_roi_align_backward(
        ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws),
        ctypes.addressof(scales), len(shapes), order.data_ptr(),
        seg.data_ptr(), footprints.data_ptr(), samples.data_ptr(),
        grad.data_ptr(), n, shapes[0][0], c, p, sampling_ratio,
        _DTYPES[grad.dtype], _DTYPES[dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "roi_align backward kernel launch")


class _RoIAlignFunction(torch.autograd.Function):
    """Forward K1 (slab-grouped rois) or K3 (pairs); backward the
    tile-owned gather kernel (or their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, grouped, strides, rois, slabs, levels, output_size,
                sampling_ratio, *features):
        ctx.meta = (strides, output_size, sampling_ratio,
                    [tuple(f.shape) for f in features], features[0].dtype)
        ctx.save_for_backward(rois.reshape(-1, 4), slabs,
                              None if levels is None else levels.reshape(-1))
        if grouped:
            return roi_align_multilevel(list(features), strides, rois,
                                        levels, output_size, sampling_ratio)
        return roi_align_pairs(list(features), strides, rois, slabs, levels,
                               output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        rois, slabs, levels = ctx.saved_tensors
        strides, p, s, shapes, dtype = ctx.meta
        grads = roi_align_backward(
            shapes, dtype, strides, rois, slabs, levels,
            grad.reshape((-1,) + grad.shape[-3:]).contiguous(), p, s)
        return (None,) * 7 + tuple(grads)


def _needs_grad(features: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(f.requires_grad for f in features)


def roi_align_multilevel_autograd(features: Sequence[torch.Tensor],
                                  strides: Sequence[int], rois: torch.Tensor,
                                  levels: torch.Tensor, output_size: int = 7,
                                  sampling_ratio: int = 2) -> torch.Tensor:
    """`roi_align_multilevel` with a gradient to the level maps."""
    if not _needs_grad(features):
        return roi_align_multilevel(features, strides, rois, levels,
                                    output_size, sampling_ratio)
    s_dim, k = rois.shape[:2]
    return _RoIAlignFunction.apply(
        True, list(strides), rois, slab_of_rows(s_dim, k, rois.device),
        levels, output_size, sampling_ratio, *features)


def roi_align_pairs_autograd(features: Sequence[torch.Tensor],
                             strides: Sequence[int], rois: torch.Tensor,
                             slabs: torch.Tensor,
                             levels: Optional[torch.Tensor] = None,
                             output_size: int = 7, sampling_ratio: int = 2
                             ) -> torch.Tensor:
    """`roi_align_pairs` with a gradient to the level maps."""
    if not _needs_grad(features):
        return roi_align_pairs(features, strides, rois, slabs, levels,
                               output_size, sampling_ratio)
    return _RoIAlignFunction.apply(False, list(strides), rois, slabs, levels,
                                   output_size, sampling_ratio, *features)
