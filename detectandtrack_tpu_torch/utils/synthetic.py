"""Seeded synthetic batches in the train-step contract (numpy), for smoke
runs and tests. The GT tubes come from the caller, e.g.
`bench.make_realistic_tubes`."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

NUM_KEYPOINTS = 15      # PoseTrack's joints


def train_batch(rng: np.random.Generator, tubes: np.ndarray,
                n_valid: Sequence[int], clip_hw: Tuple[int, int],
                mask_size: int = 0) -> Dict[str, np.ndarray]:
    """GT tubes (B, G, 4T) → {clips (B, T, H, W, 3), gt_boxes, gt_keypoints
    (B, G, T, 15, 3), gt_valid (B, G)}: keypoints uniform inside each box
    with a random visibility in {0, 1, 2}, the first n_valid[i] GT rows of
    clip i valid, standard-normal clips. With `mask_size`, also gt_masks
    (B, G, T, M, M), one disc bitmap per GT box and frame, and
    gt_mask_valid (B, G, T), 80% of frames annotated."""
    b, g = tubes.shape[:2]
    t = tubes.shape[2] // 4
    box = tubes.reshape(b, g, t, 1, 4)
    u = rng.uniform(size=(b, g, t, NUM_KEYPOINTS, 2))
    kps = np.stack([box[..., 0] + u[..., 0] * (box[..., 2] - box[..., 0]),
                    box[..., 1] + u[..., 1] * (box[..., 3] - box[..., 1]),
                    rng.integers(0, 3, size=(b, g, t, NUM_KEYPOINTS))],
                   axis=-1)
    valid = np.arange(g)[None, :] < np.asarray(n_valid)[:, None]
    h, w = clip_hw
    batch = {"clips": rng.normal(size=(b, t, h, w, 3)).astype(np.float32),
             "gt_boxes": tubes, "gt_keypoints": kps.astype(np.float32),
             "gt_valid": valid}
    if mask_size:
        yy, xx = np.mgrid[:mask_size, :mask_size] / (mask_size - 1.0)
        c = rng.uniform(0.3, 0.7, size=(b, g, t, 2, 1, 1))
        r = rng.uniform(0.2, 0.5, size=(b, g, t, 1, 1))
        batch["gt_masks"] = ((xx - c[..., 0, :, :]) ** 2
                             + (yy - c[..., 1, :, :]) ** 2
                             < r ** 2).astype(np.float32)
        batch["gt_mask_valid"] = rng.uniform(size=(b, g, t)) < 0.8
    return batch
