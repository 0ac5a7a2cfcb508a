"""The RoIAlign entry points of detectandtrack_tpu/kernels/roi_align.py,
with their signatures and output layouts: `roi_align`, `roi_align_3d`,
`roi_align_batched`, `roi_align_multilevel`, `roi_align_multilevel_batched`.

In the JAX package they reach the single-level Pallas kernel
`_roi_align_pallas` (K3) on a TPU and `roi_align_reference` elsewhere. Here
each is one call of `roi_align_pairs_autograd`: K3 for CUDA tensors, its
plain version for CPU tensors, exact for every roi (no patch window), with
a gradient to the features and none to the rois. (The multilevel forms take
every roi's output from its own level, as the JAX forms select it.)
`roi_align_multilevel` here is the JAX signature, per-level (H_l, W_l, C)
maps and (R, 4) rois; the detector's slab-grouped form is
`roi_align.roi_align_multilevel`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .roi_align import roi_align_pairs_autograd


def _i32(t, n: int, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device).to(torch.int32).reshape(
        n).contiguous()


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              output_size: int = 7, sampling_ratio: int = 2,
              spatial_scale: float = 1.0) -> torch.Tensor:
    """features (H, W, C), rois (R, 4) image coords → (R, P, P, C)."""
    r = rois.shape[0]
    scaled = (rois.float() * spatial_scale).contiguous()
    slabs = torch.zeros((r,), dtype=torch.int32, device=rois.device)
    return roi_align_pairs_autograd([features[None].contiguous()], [1],
                                    scaled, slabs, None, output_size,
                                    sampling_ratio)


def roi_align_3d(features: torch.Tensor, tube_rois: torch.Tensor,
                 output_size: int = 7, sampling_ratio: int = 2,
                 spatial_scale: float = 1.0) -> torch.Tensor:
    """Tube pooling: features (T, H, W, C), tube_rois (R, 4T) per-frame
    boxes; frame f pools from slab f → (R, T, P, P, C)."""
    t, _, _, c = features.shape
    r = tube_rois.shape[0]
    flat = (tube_rois.float().reshape(r * t, 4) * spatial_scale).contiguous()
    slabs = torch.arange(t, dtype=torch.int32,
                         device=tube_rois.device).repeat(r)
    out = roi_align_pairs_autograd([features.contiguous()], [1], flat, slabs,
                                   None, output_size, sampling_ratio)
    return out.reshape(r, t, output_size, output_size, c)


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor,
                      slabs: torch.Tensor, output_size: int = 7,
                      sampling_ratio: int = 2,
                      spatial_scale: float = 1.0) -> torch.Tensor:
    """features (S, H, W, C) slabs, rois (R, 4) image coords, slabs (R,) →
    (R, P, P, C)."""
    r = rois.shape[0]
    scaled = (rois.float() * spatial_scale).contiguous()
    return roi_align_pairs_autograd(
        [features.contiguous()], [1], scaled, _i32(slabs, r, rois.device),
        None, output_size, sampling_ratio)


def roi_align_multilevel(features: Sequence[torch.Tensor],
                         strides: Sequence[int], rois: torch.Tensor,
                         levels: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """FPN RoIAlign: per-level (H_l, W_l, C) maps, rois (R, 4) image
    coords, levels (R,) index into `features` → (R, P, P, C)."""
    r = rois.shape[0]
    return roi_align_pairs_autograd(
        [f[None].contiguous() for f in features], list(strides),
        rois.float().contiguous(),
        torch.zeros((r,), dtype=torch.int32, device=rois.device),
        _i32(levels, r, rois.device), output_size, sampling_ratio)


def roi_align_multilevel_batched(features: Sequence[torch.Tensor],
                                 strides: Sequence[int], rois: torch.Tensor,
                                 levels: torch.Tensor, slabs: torch.Tensor,
                                 output_size: int = 7,
                                 sampling_ratio: int = 2) -> torch.Tensor:
    """Batched FPN RoIAlign: per-level (S, H_l, W_l, C) slab stacks, rois
    (R, 4) image coords, levels (R,), slabs (R,) → (R, P, P, C)."""
    r = rois.shape[0]
    return roi_align_pairs_autograd(
        [f.contiguous() for f in features], list(strides),
        rois.float().contiguous(), _i32(slabs, r, rois.device),
        _i32(levels, r, rois.device), output_size, sampling_ratio)
