"""Clip detection entry points and host-side hand-off to the tracker.

Port of detectandtrack_tpu/engine/inference.py (`make_detect_fn` and
`make_kps_aug_fns` on one device, `clip_slice`, `detections_to_frames`),
with the static shapes of the detect outputs (`detect_output_shapes`).
The per-frame dicts feed the port's host tracker,
`detectandtrack_tpu_torch.tracking.tracker.Tracker.update`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.detector import GeneralizedRCNN


def make_detect_fn(model: GeneralizedRCNN, with_proposals: bool = False,
                   run_rpn: bool = False, flip_tta: bool = False
                   ) -> Callable[..., Dict]:
    """`detect(clips, tubes=None, tubes_valid=None) → {boxes, scores, valid,
    features, keypoints, masks}` on the model's device, under inference
    mode; keypoints and masks where the model predicts them.

    `with_proposals` runs `detect_with_proposals` on the given tubes;
    `run_rpn` keeps the RPN and its NMS running on that path (the
    benchmark's controlled RoI mix) instead of skipping them. `flip_tta`
    runs the model's flip test-time augmentation (`detect_tta`). Masks come
    back as the sigmoid of the last class channel (the person), computed on
    the device: (B, D, T, 2P, 2P).
    """

    def detect(clips: torch.Tensor, tubes: Optional[torch.Tensor] = None,
               tubes_valid: Optional[torch.Tensor] = None) -> Dict:
        with torch.inference_mode():
            if with_proposals:
                out = model.detect_with_proposals(clips, tubes, run_rpn,
                                                  tubes_valid)
            elif flip_tta:
                out = model.detect_tta(clips)
            else:
                out = model(clips)
            return detect_outputs(out)

    return detect


def detect_outputs(out: Dict) -> Dict[str, torch.Tensor]:
    """The model's raw outputs → `make_detect_fn`'s: boxes, scores, valid,
    features, and keypoints and mask probabilities where present."""
    keep = {k: out[k] for k in ("boxes", "scores", "valid", "features")}
    if "keypoints" in out:
        keep["keypoints"] = out["keypoints"]
    if "masks" in out:
        keep["masks"] = torch.sigmoid(out["masks"][..., -1])
    return keep


def detect_output_shapes(model: GeneralizedRCNN, batch: int
                         ) -> Dict[str, Tuple[int, ...]]:
    """The static shape of each of `make_detect_fn`'s outputs for a batch
    of `batch` clips."""
    cfg = model.cfg
    t, d = model.num_frames, cfg.TEST.DETECTIONS_PER_IM
    if cfg.MODEL.RPN_ONLY:
        d, feat = min(d, cfg.RPN.POST_NMS_TOP_N_TEST), 1
    else:
        feat = model.box_head.cls_score.in_features
    shapes = {"boxes": (batch, d, 4 * t), "scores": (batch, d),
              "valid": (batch, d), "features": (batch, d, feat)}
    if hasattr(model, "kps_head"):
        shapes["keypoints"] = (batch, d, t, model.kps_head.num_keypoints, 4)
    if hasattr(model, "mask_head"):
        m = 2 * cfg.MRCNN.ROI_XFORM_RESOLUTION
        shapes["masks"] = (batch, d, t, m, m)
    return shapes


def make_kps_aug_fns(model: GeneralizedRCNN, flip: bool
                     ) -> Tuple[Callable, Callable]:
    """The KPS_AUG second phase: `hm_fn(clips, boxes)` is one scale's pass
    of the body and keypoint head on the final boxes (in that clip's
    coordinates; with the mirrored pass averaged in when `flip`) →
    (B, M, Tk, S, S, K); `decode_fn(hms (S, B, M, Tk, S, S, K), boxes)`
    averages the stacked scales on the device and decodes once at the boxes
    in original coordinates → (B, D, T, K, 4)."""

    def hm_fn(clips: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.keypoint_heatmaps_for_boxes(clips, boxes, flip)

    def decode_fn(hms: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.decode_keypoints_from_heatmaps(hms.mean(dim=0),
                                                        boxes)

    return hm_fn, decode_fn


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
    if det.get("masks") is not None:
        out["masks"] = _host(det["masks"][i]).astype(np.float32)
    return out


def detections_to_frames(det: Dict[str, np.ndarray], num_frames: int,
                         scale: float) -> List[Dict[str, np.ndarray]]:
    """One clip's padded outputs (from `clip_slice`) → per-frame dicts in
    original image coordinates; keypoints become [x, y, prob] triples and
    masks stay roi-relative (D, 2P, 2P) probabilities per frame."""
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
        if "masks" in det:
            fr["masks"] = np.asarray(det["masks"][:, t], np.float32)
        frames.append(fr)
    return frames
