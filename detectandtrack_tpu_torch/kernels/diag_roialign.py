"""The RoIAlign diagnostic mini-kernel: a per-pair patch gather behind a
level select, then two dense interpolation contractions.

Port of `tools/diag_roialign.py::mini_kernel` (the Pallas kernel that
`run_variant` launches). It computes nothing the model uses: it splits the
per-pair cost of a RoIAlign-shaped kernel into the gather, the level select
and the contractions, in four variants:

  full      the level's 64x64xC patch at the pair's column offset, then
            tmp = bf16(a @ patch) over the row axis and
            out[r, q, c] = bf16(sum_x a[q, x] * tmp[r, x, c]), f32 sums;
  noswitch  the same from level 0 for every pair;
  nodma     the same contractions on a zero patch, with no map read;
  nodot     the whole patch gathered, out = bf16(patch[:p, :p] + bf16(x1)).

For pair i: x1 = rois[4i], ox = clip((int(x1) // 8) * 8, 0, 64), the patch
is feats[L][0, 0:64, ox:ox+64, :] with L = clip(levels[i], 0, n_levels-1),
and a[r, j] = bf16(max(0, 1 - |j - x1|)) for r < p, j < 64 (x1 itself, not
relative to ox). `diag_pool` launches `csrc/diag_roialign.cu` (both
contractions on the bf16 tensor cores, f32 sums) for CUDA tensors, runs
the plain version `diag_pool_reference` for CPU tensors, and raises on any
other device. Launch counts: `diag_pool.launches[variant]`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import _build

PATCH = 64                    # patch rows and columns
VARIANTS = ("full", "noswitch", "nodma", "nodot")
MAX_P = 16                    # output sizes the kernel is built for
_MAX_LEVELS = 8
_REF_CHUNK = 64               # pairs the plain version gathers at once


def patch_origin(rois: torch.Tensor, levels: torch.Tensor, n_levels: int,
                 variant: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pair's level and patch column offset → (L (n,) int64, ox (n,)
    int64). int(x1) truncates toward zero, saturating (NaN gives 0), as
    XLA's and CUDA's float to int32 conversions do; // floors."""
    x1 = rois.reshape(-1, 4)[:, 0]
    xi = torch.nan_to_num(x1, nan=0.0).clamp(-2.0 ** 30, 2.0 ** 30).to(
        torch.int64)
    ox = (torch.div(xi, 8, rounding_mode="floor") * 8).clamp(0, PATCH)
    if variant == "noswitch":
        lvl = torch.zeros_like(ox)
    else:
        lvl = levels.to(torch.int64).clamp(0, n_levels - 1)
    return lvl, ox


def patch_cells(rois: torch.Tensor, levels: torch.Tensor, n_levels: int,
                variant: str) -> int:
    """The distinct (level, row, column) map cells the pairs' patches
    cover: 64 rows times the union of each level's [ox, ox + 64) column
    ranges (the bytes term of the kernel's bound)."""
    lvl, ox = patch_origin(rois.cpu(), levels.cpu(), n_levels, variant)
    cells = 0
    for level in lvl.unique().tolist():
        cols = torch.zeros(2 * PATCH, dtype=torch.bool)
        for o in ox[lvl == level].unique().tolist():
            cols[o:o + PATCH] = True
        cells += PATCH * int(cols.sum())
    return cells


def interp_matrix(x1: torch.Tensor, p: int) -> torch.Tensor:
    """a (m, p, 64) f32 holding bf16 values: max(0, 1 - |j - x1|), the
    same for every row r < p."""
    j = torch.arange(PATCH, dtype=torch.float32, device=x1.device)
    a = torch.clamp(1.0 - (j[None, :] - x1[:, None]).abs(), min=0.0)
    return a.to(torch.bfloat16).float()[:, None, :].expand(-1, p, PATCH)


def _check(feats: Sequence[torch.Tensor], rois: torch.Tensor,
           levels: torch.Tensor, p: int, variant: str) -> Tuple[int, int]:
    """The shapes both versions take → (n pairs, channels)."""
    what = "diag_pool"
    if variant not in VARIANTS:
        raise ValueError(f"{what}: variant {variant!r} not in {VARIANTS}")
    if not 1 <= len(feats) <= _MAX_LEVELS:
        raise ValueError(f"{what}: {len(feats)} levels (1..{_MAX_LEVELS})")
    shape = tuple(feats[0].shape)
    if len(shape) != 4 or shape[0] != 1 or shape[1] < PATCH or (
            shape[2] < 2 * PATCH):
        raise ValueError(f"{what}: level maps must be (1, H >= {PATCH}, "
                         f"W >= {2 * PATCH}, C), got {shape}")
    for f in feats:
        if (tuple(f.shape) != shape or f.dtype != torch.bfloat16
                or f.device != rois.device):
            raise ValueError(f"{what}: every level must be bf16 {shape} on "
                             f"{rois.device}, got {f.dtype} "
                             f"{tuple(f.shape)} on {f.device}")
    n = levels.shape[0]
    if (tuple(rois.shape) != (4 * n,) or rois.dtype != torch.float32
            or tuple(levels.shape) != (n,) or levels.dtype != torch.int32
            or levels.device != rois.device):
        raise ValueError(f"{what}: rois must be f32 (4n,) and levels int32 "
                         f"(n,) on one device, got {tuple(rois.shape)} "
                         f"{rois.dtype}, {tuple(levels.shape)} "
                         f"{levels.dtype}")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"{what}: p={p} (1..{MAX_P})")
    return n, shape[3]


def diag_pool_reference(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                        levels: torch.Tensor, p: int = 7,
                        variant: str = "full") -> torch.Tensor:
    """The plain version: maps (1, H, W, C) bf16 per level, rois (4n,)
    f32 (x1 = rois[4i]), levels (n,) int32 → (n, p, p, C) bf16. Goes
    through the pairs in chunks (all 4800 patches of the tool at once would
    be 10 GB)."""
    n, c = _check(feats, rois, levels, p, variant)
    stack = torch.cat(list(feats))                      # (L, H, W, C)
    lvl, ox = patch_origin(rois, levels, len(feats), variant)
    x1 = rois.reshape(-1, 4)[:, 0]
    span = torch.arange(PATCH, device=rois.device)
    out = torch.empty((n, p, p, c), dtype=torch.bfloat16, device=rois.device)
    for s in range(0, n, _REF_CHUNK):
        e = min(n, s + _REF_CHUNK)
        if variant == "nodma":
            patch = torch.zeros((e - s, PATCH, PATCH, c), device=rois.device)
        else:
            cols = ox[s:e, None] + span[None, :]               # (m, 64)
            patch = stack[lvl[s:e, None, None], span[None, :, None],
                          cols[:, None, :]].float()            # (m, 64, 64, C)
        if variant == "nodot":
            xb = x1[s:e].to(torch.bfloat16).float()
            out[s:e] = (patch[:, :p, :p] + xb[:, None, None, None]).to(
                torch.bfloat16)
            continue
        a = interp_matrix(x1[s:e], p)                          # (m, p, 64)
        tmp = torch.bmm(a, patch.reshape(e - s, PATCH, PATCH * c))
        tmp = tmp.to(torch.bfloat16).float().reshape(e - s, p, PATCH, c)
        out[s:e] = torch.einsum("mqx,mrxc->mrqc", a, tmp).to(torch.bfloat16)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("diag_roialign")
    lib.dat_diag_pool.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dat_diag_pool.restype = ctypes.c_int
    return lib


def diag_pool(feats: Sequence[torch.Tensor], rois: torch.Tensor,
              levels: torch.Tensor, p: int = 7,
              variant: str = "full") -> torch.Tensor:
    """The diagnostic mini-kernel → (n, p, p, C) bf16.

    CPU tensors run `diag_pool_reference`; CUDA tensors launch the kernel
    of `csrc/diag_roialign.cu`; tensors on any other device raise.
    """
    if rois.device.type == "cpu":
        return diag_pool_reference(feats, rois, levels, p, variant)
    if not rois.is_cuda:
        raise ValueError(f"diag_pool: tensors on {rois.device}: the kernel "
                         "runs on CUDA, the plain version on the CPU")
    n, c = _check(feats, rois, levels, p, variant)
    if c % 32 or any(not f.is_contiguous() for f in feats) or (
            not rois.is_contiguous() or not levels.is_contiguous()):
        raise ValueError("diag_pool kernel: C must be a multiple of 32 and "
                         "every tensor contiguous")
    if n * (c // 32) > 2 ** 31 - 1:
        raise ValueError("diag_pool kernel: too many pairs for one launch")
    _, h, w, _ = feats[0].shape
    out = torch.empty((n, p, p, c), dtype=torch.bfloat16, device=rois.device)
    if n == 0:
        return out
    ptrs = (ctypes.c_void_p * len(feats))(*[f.data_ptr() for f in feats])
    lib = _lib()
    with torch.cuda.device(rois.device):
        err = lib.dat_diag_pool(
            ctypes.addressof(ptrs), len(feats), rois.data_ptr(),
            levels.data_ptr(), out.data_ptr(), n, h, w, c, p,
            VARIANTS.index(variant), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "diag_pool kernel launch")
    diag_pool.launches[variant] += 1
    return out


diag_pool.launches = dict.fromkeys(VARIANTS, 0)
