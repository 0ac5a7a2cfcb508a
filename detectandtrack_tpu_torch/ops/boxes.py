"""Box geometry on torch tensors (port of detectandtrack_tpu/ops/boxes.py).

Boxes are (x1, y1, x2, y2) pixel coordinates with the Detectron convention
width = x2 - x1 + 1. Every function broadcasts over leading batch dims.
"""

from __future__ import annotations

from typing import Sequence

import torch

# Clamp on dw/dh before exp, as in the lineage (log(1000/16)).
BBOX_XFORM_CLIP = 4.135166556742356


def boxes_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) boxes."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w * h


def bbox_overlaps(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., K, 4) boxes → (..., N, K)."""
    boxes = boxes.float()
    query = query.float()
    x1 = torch.maximum(boxes[..., :, None, 0], query[..., None, :, 0])
    y1 = torch.maximum(boxes[..., :, None, 1], query[..., None, :, 1])
    x2 = torch.minimum(boxes[..., :, None, 2], query[..., None, :, 2])
    y2 = torch.minimum(boxes[..., :, None, 3], query[..., None, :, 3])
    iw = (x2 - x1 + 1.0).clamp(min=0.0)
    ih = (y2 - y1 + 1.0).clamp(min=0.0)
    inter = iw * ih
    union = (boxes_area(boxes)[..., :, None] + boxes_area(query)[..., None, :]
             - inter)
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def bbox_iou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of two aligned (..., 4) box arrays → (...)."""
    a = a.float()
    b = b.float()
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    iw = (x2 - x1 + 1.0).clamp(min=0.0)
    ih = (y2 - y1 + 1.0).clamp(min=0.0)
    inter = iw * ih
    union = boxes_area(a) + boxes_area(b) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def bbox_transform(boxes: torch.Tensor, deltas: torch.Tensor,
                   weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
                   ) -> torch.Tensor:
    """Apply regression deltas: boxes (..., 4), deltas (..., 4k) → (..., 4k)."""
    boxes = boxes.float()
    deltas = deltas.float()
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (d[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]
    out = torch.stack([pred_ctr_x - 0.5 * pred_w,
                       pred_ctr_y - 0.5 * pred_h,
                       pred_ctr_x + 0.5 * pred_w - 1.0,
                       pred_ctr_y + 0.5 * pred_h - 1.0], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, height: float, width: float
               ) -> torch.Tensor:
    """Clip (..., 4k) boxes to the image (parity: clip_tiled_boxes)."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    out = torch.stack([b[..., 0].clamp(0.0, width - 1.0),
                       b[..., 1].clamp(0.0, height - 1.0),
                       b[..., 2].clamp(0.0, width - 1.0),
                       b[..., 3].clamp(0.0, height - 1.0)], dim=-1)
    return out.reshape(boxes.shape)


def flip_boxes(boxes: torch.Tensor, width: float) -> torch.Tensor:
    """Horizontal flip of (..., 4) boxes in an image of the given width:
    x maps to width - 1 - x (`engine/augment._unflip_boxes`)."""
    x1 = width - boxes[..., 2] - 1.0
    x2 = width - boxes[..., 0] - 1.0
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def filter_small_boxes(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Validity mask of boxes with both sides >= min_size."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return (w >= min_size) & (h >= min_size)


def bbox_transform_inv(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                       weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
                       ) -> torch.Tensor:
    """Regression targets taking `boxes` to `gt_boxes` (aligned, (..., 4))."""
    boxes = boxes.float()
    gt_boxes = gt_boxes.float()
    wx, wy, ww, wh = weights
    ex_w = boxes[..., 2] - boxes[..., 0] + 1.0
    ex_h = boxes[..., 3] - boxes[..., 1] + 1.0
    ex_cx = boxes[..., 0] + 0.5 * ex_w
    ex_cy = boxes[..., 1] + 0.5 * ex_h
    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0
    gt_cx = gt_boxes[..., 0] + 0.5 * gt_w
    gt_cy = gt_boxes[..., 1] + 0.5 * gt_h
    # Guard degenerate boxes (padding rows): no division by zero, no log(0).
    ex_w = ex_w.clamp(min=1e-6)
    ex_h = ex_h.clamp(min=1e-6)
    gt_w = gt_w.clamp(min=1e-6)
    gt_h = gt_h.clamp(min=1e-6)
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w,
                        wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w),
                        wh * torch.log(gt_h / ex_h)], dim=-1)
