"""Clip detection entry point and host-side hand-off to the tracker.

Port of detectandtrack_tpu/engine/inference.py (`make_detect_fn` on one
device, `clip_slice`, `detections_to_frames`). The per-frame dicts feed
`detectandtrack_tpu.tracking.tracker.Tracker.update`, reused by import.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.detector import GeneralizedRCNN


def make_detect_fn(model: GeneralizedRCNN, with_proposals: bool = False,
                   run_rpn: bool = False) -> Callable[..., Dict]:
    """`detect(clips, tubes=None, tubes_valid=None) → {boxes, scores, valid,
    features, keypoints}` on the model's device, under inference mode.

    `with_proposals` runs `detect_with_proposals` on the given tubes;
    `run_rpn` keeps the RPN and its NMS running on that path (the
    benchmark's controlled RoI mix) instead of skipping them.
    """

    def detect(clips: torch.Tensor, tubes: Optional[torch.Tensor] = None,
               tubes_valid: Optional[torch.Tensor] = None) -> Dict:
        with torch.inference_mode():
            if with_proposals:
                out = model.detect_with_proposals(clips, tubes, run_rpn,
                                                  tubes_valid)
            else:
                out = model(clips)
        keep = {k: out[k] for k in ("boxes", "scores", "valid", "features")}
        if "keypoints" in out:
            keep["keypoints"] = out["keypoints"]
        return keep

    return detect


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def clip_slice(det: Dict, i: int) -> Dict[str, np.ndarray]:
    """Batched padded outputs (tensors or arrays) → clip i's numpy dict."""
    out = {"boxes": _host(det["boxes"][i]).astype(np.float64),
           "scores": _host(det["scores"][i]).astype(np.float64),
           "valid": _host(det["valid"][i]).astype(bool)}
    if det.get("keypoints") is not None:
        out["keypoints"] = _host(det["keypoints"][i]).astype(np.float64)
    if det.get("features") is not None:
        out["features"] = _host(det["features"][i]).astype(np.float32)
    return out


def detections_to_frames(det: Dict[str, np.ndarray], num_frames: int,
                         scale: float) -> List[Dict[str, np.ndarray]]:
    """One clip's padded outputs (from `clip_slice`) → per-frame dicts in
    original image coordinates; keypoints become [x, y, prob] triples."""
    boxes = np.asarray(det["boxes"], np.float64)             # (D, 4T)
    scores = np.asarray(det["scores"], np.float64)
    valid = np.asarray(det["valid"], bool)
    kps = (np.asarray(det["keypoints"], np.float64)
           if "keypoints" in det else None)                  # (D, T, K, 4)
    per_frame = boxes.reshape(boxes.shape[0], num_frames, 4) / scale
    frames = []
    for t in range(num_frames):
        fr = {"boxes": per_frame[:, t], "scores": scores, "valid": valid}
        if kps is not None:
            k = kps[:, t].copy()
            k[..., :2] /= scale
            fr["keypoints"] = np.stack([k[..., 0], k[..., 1], k[..., 3]],
                                       axis=-1)
        if "features" in det:
            fr["features"] = np.asarray(det["features"], np.float32)
        frames.append(fr)
    return frames
