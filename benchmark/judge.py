"""Judging the detections a window produced against the plain reference.

The reference scores every candidate tube of a clip (refined boxes,
person scores, fc7 features) in float32. Each valid detection of the
system is matched to the candidate whose refined tube lies nearest (the
largest coordinate difference over the 4T coordinates), and then:

  box_gap_px    the largest coordinate difference of a match, in pixels;
  score_gap     the largest |score − the reference's score|;
  feature_gap   the largest ‖fc7 − the reference's‖ / ‖the reference's‖;
  nms_gap       greedy NMS replayed with the reference's scores and boxes,
                following the system's picks in its order: at each pick
                the reference's best score among the candidates still free
                less the reference's score of the pick; a pick that an
                earlier pick suppresses by IoU above TEST.NMS + IOU_BAND
                (or a repeated pick) reads 1; after the last pick of a
                clip that kept fewer than DETECTIONS_PER_IM, the best free
                score less TEST.SCORE_THRESH. A candidate within IOU_BAND
                of the threshold counts as neither free nor suppressed,
                since box rounding decides it. The gap is thus bounded by
                the score error wherever the picks follow from the scores,
                however close the scores lie;
  kps_gap       for each keypoint of the first MAX_ROIS_PER_IM detections:
                the reference's heatmap (of its own box of the matched
                candidate) at the system's keypoint, as the larger of the
                gap between the map's maximum and its best cell next to
                the keypoint, and |the system's logit − the map's maximum|,
                over the map's maximum less its mean.

Top-k, NMS and argmax choices that follow near-equal scores are thus
judged by how far the choice lies from the reference's best, not by
whether it is the same choice.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

# The IoU band around TEST.NMS within which box rounding decides: bfloat16
# boxes read up to 0.05 px from the reference's, which moves the IoU of
# boxes 32 px and larger by well under 0.01.
IOU_BAND = 0.01


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    area = lambda x: (x[:, 2] - x[:, 0] + 1) * (x[:, 3] - x[:, 1] + 1)  # noqa
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def judge_clip(out: Dict[str, np.ndarray], refined: np.ndarray,
               scores: np.ndarray, fc7: np.ndarray,
               heatmaps: Callable[[torch.Tensor], torch.Tensor],
               test: Dict, m_kp: int) -> Dict[str, float]:
    """The gaps of one clip's outputs `out` (boxes (D, 4T), scores (D,),
    valid (D,), features (D, F), keypoints (D, T, K, 4)) against the
    reference's candidates refined (K, 4T), scores (K,), fc7 (K, F);
    `heatmaps(boxes (M, 4T))` → the reference's (M, T, S, S, K)."""
    valid = np.asarray(out["valid"], bool)
    boxes = np.asarray(out["boxes"], np.float64)[valid]
    t = refined.shape[1] // 4
    dist = np.abs(boxes[:, None, :] - refined[None, :, :]).max(-1)
    match = dist.argmin(1) if len(boxes) else np.zeros(0, int)
    gaps = {"box_gap_px": float(dist.min(1).max()) if len(boxes) else 0.0}
    s = np.asarray(out["scores"], np.float64)[valid]
    gaps["score_gap"] = float(np.abs(s - scores[match]).max()) if len(
        boxes) else 0.0
    f = np.asarray(out["features"], np.float64)[valid]
    fr = fc7[match].astype(np.float64)
    gaps["feature_gap"] = float((np.linalg.norm(f - fr, axis=1) / np.maximum(
        np.linalg.norm(fr, axis=1), 1e-12)).max()) if len(boxes) else 0.0

    centre = refined[:, 4 * (t // 2):4 * (t // 2) + 4].astype(np.float64)
    iou = _iou(centre, centre)
    thr, s_thr = test["NMS"], test["SCORE_THRESH"]
    free = scores >= s_thr
    near = np.zeros(len(scores))
    taken = np.zeros(len(scores), bool)
    nms = [0.0]
    for j in match:
        if taken[j] or near[j] > thr + IOU_BAND:
            nms.append(1.0)
        else:
            cand = free & ~taken & (near <= thr - IOU_BAND)
            best = scores[cand].max() if cand.any() else -np.inf
            nms.append(max(best - scores[j], s_thr - scores[j], 0.0))
        taken[j] = True
        near = np.maximum(near, iou[j])
    if len(match) < test["DETECTIONS_PER_IM"]:
        cand = free & ~taken & (near <= thr - IOU_BAND)
        if cand.any():
            nms.append(float(scores[cand].max() - s_thr))
    gaps["nms_gap"] = float(max(nms))

    m = min(m_kp, len(match))
    kps_gap = 0.0
    if m:
        kp = np.asarray(out["keypoints"], np.float64)[valid][:m]
        rb = refined[match[:m]]
        hm = heatmaps(torch.as_tensor(rb[None], dtype=torch.float32))
        hm = hm[0].double().cpu().numpy()                 # (M, T, S, S, K)
        size = hm.shape[2]
        for i in range(m):
            for f_ in range(t):
                x1, y1, x2, y2 = rb[i, 4 * f_:4 * f_ + 4]
                fx = (kp[i, f_, :, 0] - x1) * size / max(x2 - x1, 1.0) - 0.5
                fy = (kp[i, f_, :, 1] - y1) * size / max(y2 - y1, 1.0) - 0.5
                for k in range(kp.shape[2]):
                    mp = hm[i, f_, :, :, k]
                    top = mp.max()
                    scale = max(top - mp.mean(), 1e-12)
                    cols = {int(np.clip(np.floor(fx[k]), 0, size - 1)),
                            int(np.clip(np.ceil(fx[k]), 0, size - 1))}
                    rows = {int(np.clip(np.floor(fy[k]), 0, size - 1)),
                            int(np.clip(np.ceil(fy[k]), 0, size - 1))}
                    near_best = max(mp[r, c] for r in rows for c in cols)
                    kps_gap = max(kps_gap, (top - near_best) / scale,
                                  abs(kp[i, f_, k, 2] - top) / scale)
    gaps["kps_gap"] = float(kps_gap)
    return gaps
