"""Keypoint heatmap decode and heatmap flip on torch tensors, the joints'
left/right flip, and the host-side numpy helpers: OKS, OKS-NMS, keypoint
flip and rescale, and the decode's numpy oracle (port of
detectandtrack_tpu/ops/keypoints.py, whose module imports JAX)."""

from __future__ import annotations

from typing import Dict, List, Tuple

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

# COCO OKS per-keypoint sigmas (pycocotools); PoseTrack reuses the matching
# body-joint sigmas with head_bottom/head_top mapped to ear-scale constants.
COCO_OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89]) / 10.0
POSETRACK_OKS_SIGMAS = np.array(
    [.89, .87, 1.07, 1.07, .87, .89, .62, .72, .79, .79, .72, .62,
     .79, .26, .79]) / 10.0


def get_keypoints(dataset: str = "posetrack") -> Tuple[List[str], dict]:
    """Joint names + left/right flip pairing (parity: `get_keypoints`)."""
    names = _DATASETS[dataset]
    flip_map = {}
    for name in names:
        if name.startswith("left_"):
            right = "right_" + name[len("left_"):]
            flip_map[name] = right
            flip_map[right] = name
    return names, flip_map


def flip_keypoints(kps: np.ndarray, width: float,
                   dataset: str = "posetrack") -> np.ndarray:
    """Horizontally flip (..., K, 3) keypoints [x, y, v]."""
    perm = flip_permutation(dataset)
    out = np.array(kps[..., perm, :])
    out[..., 0] = width - out[..., 0] - 1
    return out


def compute_oks(
    pred: np.ndarray, gt: np.ndarray, gt_areas: np.ndarray,
    sigmas: np.ndarray = POSETRACK_OKS_SIGMAS,
) -> np.ndarray:
    """OKS matrix between (P, K, >=2) predictions and (G, K, 3) GT poses.

    GT visibility is gt[..., 2] > 0 (COCO convention). Used by the keypoint
    mAP evaluator (parity: pycocotools OKS in json_dataset_evaluator).
    """
    p, g = pred.shape[0], gt.shape[0]
    oks = np.zeros((p, g), dtype=np.float64)
    var = (sigmas * 2) ** 2
    for j in range(g):
        vis = gt[j, :, 2] > 0
        if not vis.any():
            continue
        for i in range(p):
            dx = pred[i, :, 0] - gt[j, :, 0]
            dy = pred[i, :, 1] - gt[j, :, 1]
            e = (dx ** 2 + dy ** 2) / var / (gt_areas[j] + np.spacing(1)) / 2
            oks[i, j] = np.mean(np.exp(-e[vis]))
    return oks


def nms_oks(kps: np.ndarray, rois: np.ndarray, thresh: float,
            sigmas: np.ndarray = POSETRACK_OKS_SIGMAS) -> List[int]:
    """Greedy pose-similarity NMS (parity: `lib/utils/keypoints.nms_oks`).

    kps: (P, K, >=3) [x, y, score]; rois: (P, 4) the poses' boxes.
    Instances are ranked by mean keypoint score; an instance whose OKS
    against any kept higher-ranked instance (area = the kept instance's
    roi) exceeds `thresh` is suppressed. Returns kept indices in rank
    order. Not on the PoseTrack inference path (the model's box NMS covers
    it), kept for lineage API parity.
    """
    kps = np.asarray(kps, np.float64)
    rois = np.asarray(rois, np.float64)
    inst_scores = kps[:, :, 2].mean(axis=1)
    order = np.argsort(-inst_scores)
    # Detectron +1 box-area convention (matches the lineage's nms_oks).
    areas = np.maximum((rois[:, 2] - rois[:, 0] + 1)
                       * (rois[:, 3] - rois[:, 1] + 1), 1.0)
    keep: List[int] = []
    for i in order:
        ok = True
        for j in keep:
            gt = np.concatenate(
                [kps[j, :, :2], np.ones((kps.shape[1], 1))], axis=1)
            oks = compute_oks(kps[i:i + 1, :, :2], gt[None],
                              areas[j:j + 1], sigmas)[0, 0]
            if oks > thresh:
                ok = False
                break
        if ok:
            keep.append(int(i))
    return keep


def scale_keypoints(kps: np.ndarray, scale: float) -> np.ndarray:
    """Rescale (..., K, >=2) keypoint coords (image-resize bookkeeping)."""
    out = np.array(kps, dtype=np.float32)
    out[..., 0] *= scale
    out[..., 1] *= scale
    return out


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


_FLIP_PERMS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def flip_permutation_tensor(dataset: str, device) -> torch.Tensor:
    """`flip_permutation(dataset)` as an int64 tensor on `device`, uploaded
    once per (dataset, device) and kept: a forward that flips makes no
    upload after its first call."""
    key = (dataset, torch.device(device))
    if key not in _FLIP_PERMS:
        with torch.inference_mode(False):
            _FLIP_PERMS[key] = torch.from_numpy(
                flip_permutation(dataset)).to(device)
    return _FLIP_PERMS[key]


def flip_heatmaps(heatmaps: torch.Tensor,
                  dataset: str = "posetrack") -> torch.Tensor:
    """Flip (..., K, H, W) heatmaps: swap the left/right joint channels by
    `flip_permutation` and mirror W."""
    perm = flip_permutation_tensor(dataset, heatmaps.device)
    return heatmaps.index_select(-3, perm).flip(-1)


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


def heatmaps_to_keypoints_numpy(heatmaps: np.ndarray,
                                rois: np.ndarray) -> np.ndarray:
    """Numpy oracle with identical semantics to the device decode."""
    r, k, hh, ww = heatmaps.shape
    out = np.zeros((r, k, 4), dtype=np.float32)
    for i in range(r):
        x1, y1, x2, y2 = rois[i]
        roi_w = max(x2 - x1, 1.0)
        roi_h = max(y2 - y1, 1.0)
        for j in range(k):
            hm = heatmaps[i, j]
            idx = int(np.argmax(hm))
            py, px = divmod(idx, ww)
            right = hm[py, min(px + 1, ww - 1)]
            left = hm[py, max(px - 1, 0)]
            down = hm[min(py + 1, hh - 1), px]
            up = hm[max(py - 1, 0), px]
            c = hm[py, px]

            def para(lo, hi):
                denom = lo - 2.0 * c + hi
                if abs(denom) <= 1e-6:
                    return 0.0
                return float(np.clip(0.5 * (lo - hi) / denom, -0.5, 0.5))

            fx = px + para(left, right)
            fy = py + para(up, down)
            e = np.exp(hm.ravel() - hm.max())
            out[i, j, 0] = x1 + (fx + 0.5) * roi_w / ww
            out[i, j, 1] = y1 + (fy + 0.5) * roi_h / hh
            out[i, j, 2] = hm[py, px]
            out[i, j, 3] = e[idx] / e.sum()
    return out
