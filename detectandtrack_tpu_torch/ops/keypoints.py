"""Keypoint heatmap decode on torch tensors and the joints' left/right flip
permutation (port of `heatmaps_to_keypoints` and `flip_permutation` in
detectandtrack_tpu/ops/keypoints.py, whose module imports JAX)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

# PoseTrack v1 (2017): 15 joints, MPII-style order.
POSETRACK_KEYPOINTS: List[str] = [
    "right_ankle", "right_knee", "right_hip",
    "left_hip", "left_knee", "left_ankle",
    "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist",
    "head_bottom", "nose", "head_top",
]

# COCO: 17 joints.
COCO_KEYPOINTS: List[str] = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

_DATASETS = {"posetrack": POSETRACK_KEYPOINTS, "coco": COCO_KEYPOINTS}


def flip_permutation(dataset: str = "posetrack") -> np.ndarray:
    """Joint index permutation that swaps every left_* with its right_*."""
    names = _DATASETS[dataset]
    swap = {"left_": "right_", "right_": "left_"}
    perm = np.arange(len(names))
    for i, name in enumerate(names):
        for side, other in swap.items():
            if name.startswith(side):
                perm[i] = names.index(other + name[len(side):])
    return perm


def _parabola_offset(lo: torch.Tensor, c: torch.Tensor, hi: torch.Tensor
                     ) -> torch.Tensor:
    denom = lo - 2.0 * c + hi
    ok = denom.abs() > 1e-6
    off = torch.where(ok, 0.5 * (lo - hi) / torch.where(ok, denom,
                                                        torch.ones_like(denom)),
                      torch.zeros_like(denom))
    return off.clamp(-0.5, 0.5)


def heatmaps_to_keypoints(heatmaps: torch.Tensor, rois: torch.Tensor
                          ) -> torch.Tensor:
    """Decode (R, K, H, W) heatmap logits + (R, 4) RoIs → (R, K, 4).

    Per keypoint: [x, y, logit, prob] — argmax of the H×W grid, refined per
    axis by a parabola through the peak and its two neighbours, mapped to
    image pixels at the bin centre; prob is the softmax at the peak.
    """
    r, k, hh, ww = heatmaps.shape
    hm = heatmaps.reshape(r, k, hh * ww)
    flat_idx = torch.argmax(hm, dim=-1)                    # first maximum
    py = flat_idx // ww
    px = flat_idx % ww
    logit = torch.gather(hm, -1, flat_idx[..., None])[..., 0]
    prob = torch.gather(torch.softmax(hm, dim=-1), -1,
                        flat_idx[..., None])[..., 0]

    def neighbor(dy, dx):
        ny = (py + dy).clamp(0, hh - 1)
        nx = (px + dx).clamp(0, ww - 1)
        return torch.gather(hm, -1, (ny * ww + nx)[..., None])[..., 0]

    dx = _parabola_offset(neighbor(0, -1), logit, neighbor(0, 1))
    dy = _parabola_offset(neighbor(-1, 0), logit, neighbor(1, 0))
    fx = px.float() + dx
    fy = py.float() + dy

    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    roi_w = (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1.0)
    roi_h = (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1.0)
    x_img = x1 + (fx + 0.5) * roi_w / ww
    y_img = y1 + (fy + 0.5) * roi_h / hh
    return torch.stack([x_img, y_img, logit, prob], dim=-1)
