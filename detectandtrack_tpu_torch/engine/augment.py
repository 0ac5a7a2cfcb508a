"""Test-time augmentation: host-side merge utilities (port of
detectandtrack_tpu/engine/augment.py).

Reference parity: `lib/core/test.py`'s BBOX_AUG / KPS_AUG machinery.

Horizontal-flip TTA runs in the model (`GeneralizedRCNN.detect_tta` — box
union before the final NMS, keypoint heatmaps mirrored + joint-permuted
and averaged at the heatmap level, the reference's 'hm_avg' heuristic,
decoded once). The `_unflip_*` helpers are the host-side statements of the
coordinate conventions (and test oracles for the model's flip).

Multi-scale augmentation (`TEST.BBOX_AUG_SCALES`) runs each clip once per
scale through the bucket mechanism; `merge_multiscale_detections` unions
the passes in original-image coordinates and re-NMS's to the detection
budget (the reference's `im_detect_bbox_aug` union heuristic). With
`TEST.KPS_AUG_ENABLED`, keypoints are then recomputed in a SECOND device
phase on the merged boxes — one keypoint-head pass per scale (flip pair
in-graph), heatmaps averaged device-side, one decode — the reference's
`im_detect_keypoints_aug` 'hm_avg' heuristic at full heatmap level (see
`engine.inference.make_kps_aug_fns`); without it, the kept detection's
own keypoints ride along from its winning pass.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops.keypoints import flip_permutation
from ..ops.nms import nms_numpy


def _unflip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    out = boxes.copy()
    out[..., 0::4] = width - boxes[..., 2::4] - 1
    out[..., 2::4] = width - boxes[..., 0::4] - 1
    return out


def _unflip_keypoints(kps: np.ndarray, width: float,
                      dataset: str = "posetrack") -> np.ndarray:
    perm = flip_permutation(dataset)
    out = kps[..., perm, :].copy()
    out[..., 0] = width - out[..., 0] - 1
    return out


def merge_multiscale_detections(
    singles: List[Dict[str, np.ndarray]],
    num_frames: int,
    nms_thresh: float = 0.5,
    max_out: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Union the per-scale passes of one clip and re-NMS to the budget.

    Parity: the reference's BBOX_AUG 'union' heuristic (`im_detect_bbox_aug`
    accumulates boxes over scales then one NMS). Inputs are single-clip
    dicts already in a COMMON coordinate frame (original image coords —
    each pass divides by its own scale first). Keypoints/features ride the
    kept detection (KPS_AUG across scales keeps the winning pass's decode).
    """
    t = num_frames
    max_out = max_out or singles[0]["boxes"].shape[0]
    boxes = np.concatenate([s["boxes"] for s in singles], axis=0)
    scores = np.concatenate([s["scores"] for s in singles])
    valid = np.concatenate([s["valid"] for s in singles])
    # Per-detection payloads (keypoints / appearance features / RoI-frame
    # mask probs) ride the kept detection from its winning pass.
    extras = {k: np.concatenate([s[k] for s in singles], axis=0)
              for k in ("keypoints", "features", "masks")
              if k in singles[0]}

    center = boxes.reshape(-1, t, 4)[:, t // 2]
    masked = np.where(valid, scores, -1.0)
    keep = [i for i in nms_numpy(center, masked, nms_thresh)
            if valid[i]][:max_out]

    out = {
        "boxes": np.zeros((max_out, boxes.shape[1]), boxes.dtype),
        "scores": np.zeros((max_out,), scores.dtype),
        "valid": np.zeros((max_out,), bool),
    }
    for k, v in extras.items():
        out[k] = np.zeros((max_out,) + v.shape[1:], v.dtype)
    for slot, i in enumerate(keep):
        out["boxes"][slot] = boxes[i]
        out["scores"][slot] = scores[i]
        out["valid"][slot] = True
        for k, v in extras.items():
            out[k][slot] = v[i]
    return out


def rescale_detections(det: Dict[str, np.ndarray],
                       scale: float) -> Dict[str, np.ndarray]:
    """Scaled-image coords → original-image coords (host, one clip)."""
    out = dict(det)
    out["boxes"] = det["boxes"] / scale
    if "keypoints" in det:
        k = det["keypoints"].copy()
        k[..., :2] /= scale
        out["keypoints"] = k
    return out


def flip_clip(clips: np.ndarray) -> np.ndarray:
    """Mirror (B, T, H, W, 3) clips along W."""
    return clips[:, :, :, ::-1]
