"""Stage-2 tracking: frame-to-frame bipartite matching of detections (the
port's copy of detectandtrack_tpu/tracking/tracker.py; its native solver is
`csrc/hungarian.cpp`, built by `tracking/native.py`).

Reference parity: `lib/core/tracking_engine.py` (SURVEY.md §2.1, §3.3): per
consecutive frame pair, build a cost matrix between existing tracks and new
detections (bbox-IoU distance / pose-PCKh distance / CNN-feature cosine
distance), solve the assignment (Hungarian via scipy, or greedy as the
ablation), propagate track IDs, birth/kill tracks. Pure host code — the
paper's point is that this stage is ~free next to detection; it consumes the
device's padded detection tensors asynchronously.

The Hungarian solve runs the native C++ solver (`csrc/hungarian.cpp`,
built with g++ and loaded via ctypes); TRACKING.USE_NATIVE_SOLVER=False
selects scipy's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


_HIGH_COST = 1e6


# ---------------------------------------------------------------------------
# Cost matrices (parity: cfg.TRACKING.DISTANCE_METRIC options)
# ---------------------------------------------------------------------------

def bbox_iou_cost(prev_boxes: np.ndarray, cur_boxes: np.ndarray) -> np.ndarray:
    """1 - IoU matrix between (P, 4) and (C, 4) boxes."""
    if len(prev_boxes) == 0 or len(cur_boxes) == 0:
        return np.zeros((len(prev_boxes), len(cur_boxes)), np.float64)
    x1 = np.maximum(prev_boxes[:, None, 0], cur_boxes[None, :, 0])
    y1 = np.maximum(prev_boxes[:, None, 1], cur_boxes[None, :, 1])
    x2 = np.minimum(prev_boxes[:, None, 2], cur_boxes[None, :, 2])
    y2 = np.minimum(prev_boxes[:, None, 3], cur_boxes[None, :, 3])
    iw = np.clip(x2 - x1 + 1, 0, None)
    ih = np.clip(y2 - y1 + 1, 0, None)
    inter = iw * ih
    area_p = ((prev_boxes[:, 2] - prev_boxes[:, 0] + 1)
              * (prev_boxes[:, 3] - prev_boxes[:, 1] + 1))
    area_c = ((cur_boxes[:, 2] - cur_boxes[:, 0] + 1)
              * (cur_boxes[:, 3] - cur_boxes[:, 1] + 1))
    union = area_p[:, None] + area_c[None, :] - inter
    iou = np.where(union > 0, inter / union, 0.0)
    return 1.0 - iou


def pckh_cost(prev_kps: np.ndarray, prev_boxes: np.ndarray,
              cur_kps: np.ndarray,
              pckh_thresh: float = 0.2,
              norm: str = "box-diag") -> np.ndarray:
    """Pose distance: 1 - fraction of keypoints within a head-scaled radius.

    prev/cur_kps: (N, K, >=2). The reference normalizes by head segment
    length, which needs GT head boxes and is unavailable at inference;
    `norm` (TRACKING.PCKH_NORM) selects the GT-independent proxy:
    "box-diag" (previous box diagonal) or "kps-span" (previous pose's
    keypoint extent diagonal). `pckh_thresh` (TRACKING.PCKH_THRESH) is the
    fraction of that length.
    """
    p, c = len(prev_kps), len(cur_kps)
    if p == 0 or c == 0:
        return np.zeros((p, c), np.float64)
    if norm == "kps-span":
        diag = np.sqrt(
            np.ptp(prev_kps[:, :, 0], axis=1) ** 2
            + np.ptp(prev_kps[:, :, 1], axis=1) ** 2)
    elif norm == "box-diag":
        diag = np.sqrt(
            (prev_boxes[:, 2] - prev_boxes[:, 0]) ** 2
            + (prev_boxes[:, 3] - prev_boxes[:, 1]) ** 2)
    else:
        raise ValueError(f"Unknown PCKH_NORM {norm!r}")
    thresh = pckh_thresh * np.maximum(diag, 1.0)
    d = np.linalg.norm(prev_kps[:, None, :, :2] - cur_kps[None, :, :, :2],
                       axis=-1)                                  # (P, C, K)
    match = (d <= thresh[:, None, None]).mean(axis=-1)
    return 1.0 - match


def cosine_cost(prev_feats: np.ndarray, cur_feats: np.ndarray) -> np.ndarray:
    """1 - cosine similarity between (P, D) and (C, D) feature vectors."""
    p, c = len(prev_feats), len(cur_feats)
    if p == 0 or c == 0:
        return np.zeros((p, c), np.float64)
    a = prev_feats / np.maximum(
        np.linalg.norm(prev_feats, axis=1, keepdims=True), 1e-8)
    b = cur_feats / np.maximum(
        np.linalg.norm(cur_feats, axis=1, keepdims=True), 1e-8)
    return 1.0 - a @ b.T


# ---------------------------------------------------------------------------
# Assignment solvers
# ---------------------------------------------------------------------------

def hungarian_assign(cost: np.ndarray,
                     use_native: bool = True) -> List[Tuple[int, int]]:
    """Minimum-cost bipartite matching: the native C++ solver, or scipy's
    with use_native=False (TRACKING.USE_NATIVE_SOLVER)."""
    from .native import solve_assignment       # lazy: builds on first use
    return solve_assignment(cost, use_native=use_native)


def greedy_assign(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Greedy globally-smallest-cost-first matching (reference ablation)."""
    c = cost.copy()
    pairs = []
    while c.size and np.isfinite(c).any() and (c < _HIGH_COST / 2).any():
        i, j = np.unravel_index(np.argmin(c), c.shape)
        pairs.append((int(i), int(j)))
        c[i, :] = _HIGH_COST
        c[:, j] = _HIGH_COST
    return pairs


# ---------------------------------------------------------------------------
# Track lifecycle
# ---------------------------------------------------------------------------

@dataclass
class Track:
    track_id: int
    box: np.ndarray
    keypoints: Optional[np.ndarray]
    feature: Optional[np.ndarray]
    score: float
    age: int = 0          # frames since last match


@dataclass
class TrackerConfig:
    distance_metric: str = "bbox-iou"         # bbox-iou | pose-pckh | cnn-cosine
    algo: str = "hungarian"                   # hungarian | greedy
    score_thresh: float = 0.5                 # CONF_FILTER_INITIAL_DETS
    max_cost: float = 0.9                     # no link above this
    max_age: int = 1                          # keep-alive frames
    pckh_thresh: float = 0.2                  # TRACKING.PCKH_THRESH
    pckh_norm: str = "box-diag"               # TRACKING.PCKH_NORM
    use_native: bool = True                   # TRACKING.USE_NATIVE_SOLVER


class Tracker:
    """Online frame-by-frame linker (parity: the tracking_engine hot loop)."""

    def __init__(self, config: Optional[TrackerConfig] = None):
        self.config = config or TrackerConfig()
        self.tracks: List[Track] = []
        self._next_id = 0

    @classmethod
    def from_cfg(cls, cfg) -> "Tracker":
        return cls(TrackerConfig(
            distance_metric=cfg.TRACKING.DISTANCE_METRIC,
            algo=cfg.TRACKING.BIPARTITE_MATCHING_ALGO,
            score_thresh=cfg.TRACKING.CONF_FILTER_INITIAL_DETS,
            max_cost=cfg.TRACKING.MAX_COST,
            max_age=cfg.TRACKING.MAX_AGE,
            pckh_thresh=cfg.TRACKING.PCKH_THRESH,
            pckh_norm=cfg.TRACKING.PCKH_NORM,
            use_native=cfg.TRACKING.USE_NATIVE_SOLVER,
        ))

    def reset(self):
        self.tracks = []
        self._next_id = 0

    def _cost(self, boxes, keypoints, features) -> np.ndarray:
        metric = self.config.distance_metric
        prev_boxes = np.array([t.box for t in self.tracks]).reshape(-1, 4)
        if metric == "bbox-iou":
            return bbox_iou_cost(prev_boxes, boxes)
        if metric == "pose-pckh":
            if keypoints is None:
                raise ValueError("pose-pckh metric needs keypoints")
            prev_kps = np.array([t.keypoints for t in self.tracks])
            return pckh_cost(prev_kps, prev_boxes, keypoints,
                             self.config.pckh_thresh,
                             self.config.pckh_norm)
        if metric == "cnn-cosine":
            if features is None:
                raise ValueError("cnn-cosine metric needs features")
            prev_f = np.array([t.feature for t in self.tracks])
            return cosine_cost(prev_f, features)
        raise ValueError(f"Unknown distance metric {metric!r}")

    def update(
        self,
        boxes: np.ndarray,                   # (N, 4)
        scores: np.ndarray,                  # (N,)
        keypoints: Optional[np.ndarray] = None,   # (N, K, >=2)
        features: Optional[np.ndarray] = None,    # (N, D)
        valid: Optional[np.ndarray] = None,       # (N,) device padding mask
    ) -> np.ndarray:
        """Consume one frame's detections → per-detection track ids (−1 for
        dropped detections below the score filter)."""
        cfg = self.config
        n_in = len(boxes)
        keep = scores >= cfg.score_thresh
        if valid is not None:
            keep &= np.asarray(valid, bool)
        idx_map = np.flatnonzero(keep)
        boxes_f = np.asarray(boxes, np.float64)[keep]
        scores_f = np.asarray(scores, np.float64)[keep]
        kps_f = None if keypoints is None else np.asarray(keypoints)[keep]
        feats_f = None if features is None else np.asarray(features)[keep]

        out_ids = np.full(n_in, -1, np.int64)
        assigned = np.full(len(boxes_f), -1, np.int64)

        if self.tracks and len(boxes_f):
            cost = self._cost(boxes_f, kps_f, feats_f)
            gated = np.where(cost <= cfg.max_cost, cost, _HIGH_COST)
            pairs = (hungarian_assign(gated, cfg.use_native)
                     if cfg.algo == "hungarian" else greedy_assign(gated))
            for ti, di in pairs:
                if gated[ti, di] >= _HIGH_COST / 2:
                    continue
                tr = self.tracks[ti]
                tr.box = boxes_f[di]
                tr.keypoints = None if kps_f is None else kps_f[di]
                tr.feature = None if feats_f is None else feats_f[di]
                tr.score = scores_f[di]
                tr.age = -1                     # matched this frame
                assigned[di] = tr.track_id

        # Age & kill unmatched tracks.
        for tr in self.tracks:
            tr.age += 1
        self.tracks = [t for t in self.tracks if t.age <= cfg.max_age]

        # Birth new tracks for unmatched detections.
        for di in range(len(boxes_f)):
            if assigned[di] < 0:
                tid = self._next_id
                self._next_id += 1
                self.tracks.append(Track(
                    track_id=tid,
                    box=boxes_f[di],
                    keypoints=None if kps_f is None else kps_f[di],
                    feature=None if feats_f is None else feats_f[di],
                    score=scores_f[di],
                    age=0))
                assigned[di] = tid

        out_ids[idx_map] = assigned
        return out_ids
