"""Instance-mask host utilities: paste, rasterize, IoU (port of
detectandtrack_tpu/ops/masks.py; parity: `lib/utils/segms.py` and
`segm_results`).

The model returns per-detection S×S sigmoid probabilities in the RoI frame
(the person channel already selected); these helpers paste them into
full-image binary masks with cv2 and score them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# Detectron pads the S×S mask with one zero pixel on each side and scales
# the box accordingly before resizing, so the bilinear interpolation has a
# zero boundary condition instead of clamping the edge value outward.
_PAD = 1


def paste_mask(mask: np.ndarray, box: np.ndarray, im_h: int, im_w: int,
               thresh: float = 0.5) -> np.ndarray:
    """(S, S) probs + box [x1,y1,x2,y2] → (im_h, im_w) bool mask.

    Parity: `segm_results`'s cv2-resize-into-expanded-box + 0.5 threshold.
    """
    import cv2

    s = mask.shape[0]
    padded = np.zeros((s + 2 * _PAD, s + 2 * _PAD), np.float32)
    padded[_PAD:-_PAD, _PAD:-_PAD] = mask
    scale = (s + 2.0 * _PAD) / s

    w_half = max((box[2] - box[0]) * 0.5, 1e-3) * scale
    h_half = max((box[3] - box[1]) * 0.5, 1e-3) * scale
    cx = (box[0] + box[2]) * 0.5
    cy = (box[1] + box[3]) * 0.5
    # Truncation, not rounding: segm_results int-casts the expanded box
    # (astype(np.int32)), and the 1-px placement difference is visible in
    # mask-AP parity.
    x1, x2 = int(cx - w_half), int(cx + w_half)
    y1, y2 = int(cy - h_half), int(cy + h_half)
    bw, bh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)

    resized = cv2.resize(padded, (bw, bh), interpolation=cv2.INTER_LINEAR)
    binary = resized > thresh

    out = np.zeros((im_h, im_w), bool)
    ox1, ox2 = max(x1, 0), min(x2 + 1, im_w)
    oy1, oy2 = max(y1, 0), min(y2 + 1, im_h)
    if ox2 > ox1 and oy2 > oy1:
        out[oy1:oy2, ox1:ox2] = binary[oy1 - y1:oy2 - y1, ox1 - x1:ox2 - x1]
    return out


def rasterize_polygons(segm: Sequence[Sequence[float]], im_h: int,
                       im_w: int) -> np.ndarray:
    """COCO-style polygon list (flat [x0,y0,x1,y1,...] per part) →
    (im_h, im_w) bool bitmap (parity: segms.polys_to_mask)."""
    import cv2

    bitmap = np.zeros((im_h, im_w), np.uint8)
    for poly in segm:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(bitmap, [np.round(pts).astype(np.int32)], 1)
    return bitmap.astype(bool)


def mask_iou_matrix(preds: List[np.ndarray],
                    gts: List[np.ndarray]) -> np.ndarray:
    """(P, G) IoU between full-image boolean masks."""
    iou = np.zeros((len(preds), len(gts)), np.float64)
    for i, p in enumerate(preds):
        pa = p.sum()
        for j, g in enumerate(gts):
            inter = np.logical_and(p, g).sum()
            union = pa + g.sum() - inter
            iou[i, j] = inter / union if union > 0 else 0.0
    return iou
