"""Detection/pose visualization (port of detectandtrack_tpu/utils/vis.py;
parity: `lib/utils/vis.py`).

Host-side drawing of boxes, keypoints, skeletons and track ids onto frames
(cv2). Used by the CLI's --vis flag and for qualitative debugging.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..ops.keypoints import POSETRACK_KEYPOINTS

# Skeleton edges over the PoseTrack 15-joint vocabulary.
_EDGES = [
    ("head_top", "nose"), ("nose", "head_bottom"),
    ("head_bottom", "right_shoulder"), ("head_bottom", "left_shoulder"),
    ("right_shoulder", "right_elbow"), ("right_elbow", "right_wrist"),
    ("left_shoulder", "left_elbow"), ("left_elbow", "left_wrist"),
    ("right_shoulder", "right_hip"), ("left_shoulder", "left_hip"),
    ("right_hip", "right_knee"), ("right_knee", "right_ankle"),
    ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
    ("right_hip", "left_hip"),
]
_EDGE_IDX = [(POSETRACK_KEYPOINTS.index(a), POSETRACK_KEYPOINTS.index(b))
             for a, b in _EDGES]


def _color_for(i: int):
    rng = np.random.default_rng(i * 7919 + 13)
    return tuple(int(c) for c in rng.integers(64, 255, 3))


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: Optional[np.ndarray] = None,
    keypoints: Optional[np.ndarray] = None,
    track_ids: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
    kp_thresh: float = 0.0,
) -> np.ndarray:
    """Draw boxes (+ scores, skeletons, track ids) on a BGR uint8 image."""
    import cv2

    out = image.copy()
    n = len(boxes)
    for i in range(n):
        if valid is not None and not valid[i]:
            continue
        color = _color_for(int(track_ids[i]) if track_ids is not None
                           and track_ids[i] >= 0 else i)
        x1, y1, x2, y2 = [int(v) for v in boxes[i][:4]]
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        label = []
        if track_ids is not None and track_ids[i] >= 0:
            label.append(f"id{int(track_ids[i])}")
        if scores is not None:
            label.append(f"{scores[i]:.2f}")
        if label:
            cv2.putText(out, " ".join(label), (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
        if keypoints is not None:
            kps = keypoints[i]
            for a, b in _EDGE_IDX:
                if (kps.shape[1] < 3 or (kps[a, 2] > kp_thresh
                                         and kps[b, 2] > kp_thresh)):
                    cv2.line(out, (int(kps[a, 0]), int(kps[a, 1])),
                             (int(kps[b, 0]), int(kps[b, 1])), color, 2)
            for k in range(kps.shape[0]):
                if kps.shape[1] < 3 or kps[k, 2] > kp_thresh:
                    cv2.circle(out, (int(kps[k, 0]), int(kps[k, 1])), 2,
                               (255, 255, 255), -1)
    return out
