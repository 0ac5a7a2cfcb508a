"""Seeded synthetic inputs (numpy) for smoke runs and tests: person-shaped
proposal tubes over the FPN levels (`make_realistic_tubes`, a copy of the
JAX package's `bench.make_realistic_tubes`), batches in the train-step
contract (`train_batch`) and soft-NMS lanes (`soft_nms_case`)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

NUM_KEYPOINTS = 15      # PoseTrack's joints

# Realistic FPN level mix for person boxes at the 800-px eval scale:
# (sqrt-area band, fraction). Bands follow assign_fpn_levels with
# canonical (224, lvl 4) over ROI levels P2..P5.
_LEVEL_BANDS = [((32.0, 112.0), 0.35), ((112.0, 224.0), 0.35),
                ((224.0, 448.0), 0.20), ((448.0, 720.0), 0.10)]


def make_realistic_tubes(batch: int, k: int, t: int, im_h: int, im_w: int,
                         seed: int = 0) -> np.ndarray:
    """Deterministic person-shaped proposal tubes (B, K, 4T) spanning the
    FPN levels with the documented fractions; small per-frame drift makes
    them genuine tubes."""
    rng = np.random.default_rng(seed)
    counts = [int(round(f * k)) for _, f in _LEVEL_BANDS]
    counts[0] += k - sum(counts)
    sa = np.concatenate([rng.uniform(lo, hi, size=(batch, c))
                         for ((lo, hi), _), c in zip(_LEVEL_BANDS, counts)
                         if c > 0], axis=1)                  # (B, K)
    aspect = rng.uniform(0.33, 0.8, size=sa.shape)           # w/h: tall
    h = sa / np.sqrt(aspect)
    w = sa * np.sqrt(aspect)
    cx = rng.uniform(0.0, im_w, size=sa.shape)
    cy = rng.uniform(0.0, im_h, size=sa.shape)
    drift = rng.normal(scale=3.0, size=(batch, k, t, 2))
    boxes = np.stack([
        cx[..., None] + drift[..., 0] - w[..., None] / 2,
        cy[..., None] + drift[..., 1] - h[..., None] / 2,
        cx[..., None] + drift[..., 0] + w[..., None] / 2,
        cy[..., None] + drift[..., 1] + h[..., None] / 2,
    ], axis=-1)                                              # (B, K, T, 4)
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, im_w - 1)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, im_h - 1)
    return boxes.reshape(batch, k, 4 * t).astype(np.float32)


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


SOFT_NMS_CASES = ("random", "ties", "invalid", "chain")


def soft_nms_case(name: str, rng: np.random.Generator, n: int = 40
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One soft-NMS lane (boxes (n, 4), scores (n,), valid (n,)): random
    boxes and scores; "ties" with many equal scores and ten copies of one
    box; "invalid" with ~40% invalid rows; "chain" where each box overlaps
    only its neighbours (one pick per fixpoint round)."""
    x1, y1 = rng.uniform(0, 80, n), rng.uniform(0, 80, n)
    w, h = rng.uniform(4, 40, n), rng.uniform(4, 40, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    if name == "ties":
        scores = np.round(scores * 4) / 4          # many equal scores
        boxes[10:20] = boxes[0]                    # identical boxes too
    elif name == "invalid":
        valid = rng.uniform(size=n) > 0.4
    elif name == "chain":                          # one link per round
        x1 = np.arange(n, dtype=np.float32) * 6.0
        boxes = np.stack([x1, np.zeros(n, np.float32), x1 + 9.0,
                          np.full(n, 9.0, np.float32)], 1)
        scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    return boxes, scores, valid
