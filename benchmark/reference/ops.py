"""Plain box, anchor, RoIAlign, NMS and keypoint-decode operations of the
reference, in PyTorch and NumPy, with the semantics the detector's
published description and the Detectron lineage give them.

Frozen copies of the system's operations as they stood when the benchmark
was written (boxes with the Detectron +1 width, anchors of
`generate_anchors.py`, exact RoIAlign with 2 x 2 samples a bin, greedy NMS
with a strict `IoU > thresh`, the heatmap decode with its parabola
refinement). Nothing here imports the system under test, so a later change
to the system does not move the yardstick.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

BBOX_XFORM_CLIP = 4.135166556742356          # log(1000 / 16)


# -- boxes ------------------------------------------------------------------

def boxes_area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0] + 1.0)
            * (boxes[..., 3] - boxes[..., 1] + 1.0))


def bbox_overlaps(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) against (..., K, 4) → (..., N, K)."""
    boxes, query = boxes.float(), query.float()
    x1 = torch.maximum(boxes[..., :, None, 0], query[..., None, :, 0])
    y1 = torch.maximum(boxes[..., :, None, 1], query[..., None, :, 1])
    x2 = torch.minimum(boxes[..., :, None, 2], query[..., None, :, 2])
    y2 = torch.minimum(boxes[..., :, None, 3], query[..., None, :, 3])
    inter = (x2 - x1 + 1.0).clamp(min=0.0) * (y2 - y1 + 1.0).clamp(min=0.0)
    union = (boxes_area(boxes)[..., :, None] + boxes_area(query)[..., None, :]
             - inter)
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def bbox_transform(boxes: torch.Tensor, deltas: torch.Tensor,
                   weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
                   ) -> torch.Tensor:
    """Boxes (..., 4) moved by deltas (..., 4k) → (..., 4k)."""
    boxes, deltas = boxes.float(), deltas.float()
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx, dy = d[..., 0] / wx, d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (d[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    cx = dx * widths[..., None] + ctr_x[..., None]
    cy = dy * heights[..., None] + ctr_y[..., None]
    w = torch.exp(dw) * widths[..., None]
    h = torch.exp(dh) * heights[..., None]
    out = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w - 1.0,
                       cy + 0.5 * h - 1.0], dim=-1)
    return out.reshape(deltas.shape)


def bbox_transform_inv(boxes: torch.Tensor, gt: torch.Tensor,
                       weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
                       ) -> torch.Tensor:
    """Regression targets taking `boxes` to `gt` (aligned, (..., 4))."""
    boxes, gt = boxes.float(), gt.float()
    wx, wy, ww, wh = weights
    ex_w = (boxes[..., 2] - boxes[..., 0] + 1.0).clamp(min=1e-6)
    ex_h = (boxes[..., 3] - boxes[..., 1] + 1.0).clamp(min=1e-6)
    gt_w = (gt[..., 2] - gt[..., 0] + 1.0).clamp(min=1e-6)
    gt_h = (gt[..., 3] - gt[..., 1] + 1.0).clamp(min=1e-6)
    ex_cx = boxes[..., 0] + 0.5 * ex_w
    ex_cy = boxes[..., 1] + 0.5 * ex_h
    gt_cx = gt[..., 0] + 0.5 * gt_w
    gt_cy = gt[..., 1] + 0.5 * gt_h
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w,
                        wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w),
                        wh * torch.log(gt_h / ex_h)], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: float, width: float
               ) -> torch.Tensor:
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    out = torch.stack([b[..., 0].clamp(0.0, width - 1.0),
                       b[..., 1].clamp(0.0, height - 1.0),
                       b[..., 2].clamp(0.0, width - 1.0),
                       b[..., 3].clamp(0.0, height - 1.0)], dim=-1)
    return out.reshape(boxes.shape)


def filter_small_boxes(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    return (((boxes[..., 2] - boxes[..., 0] + 1.0) >= min_size)
            & ((boxes[..., 3] - boxes[..., 1] + 1.0) >= min_size))


# -- anchors ----------------------------------------------------------------

def generate_anchors(stride: int, sizes: Sequence[float],
                     aspect_ratios: Sequence[float]) -> np.ndarray:
    """Cell anchors (A, 4): ratio enumeration with rounding, then scales."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)

    def whctrs(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, cx, cy):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                          cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])

    w, h, cx, cy = whctrs(base)
    ws = np.round(np.sqrt(w * h / np.asarray(aspect_ratios, np.float64)))
    hs = np.round(ws * np.asarray(aspect_ratios, np.float64))
    ratio = mk(ws, hs, cx, cy)
    scales = np.asarray(sizes, np.float64) / stride
    out = []
    for a in ratio:
        w, h, cx, cy = whctrs(a)
        out.append(mk(w * scales, h * scales, cx, cy))
    return np.vstack(out).astype(np.float32)


def shifted_anchor_field(anchors: np.ndarray, stride: int, fm_h: int,
                         fm_w: int) -> np.ndarray:
    """Cell anchors tiled over an H x W map → (H·W·A, 4), row-major over
    (y, x, anchor)."""
    sx, sy = np.meshgrid(np.arange(fm_w, dtype=np.float32) * stride,
                         np.arange(fm_h, dtype=np.float32) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return (anchors[None] + shifts[:, None]).reshape(-1, 4).astype(
        np.float32)


# -- RoIAlign ---------------------------------------------------------------

def assign_fpn_levels(rois: torch.Tensor, min_level: int, max_level: int,
                      canonical_scale: int, canonical_level: int
                      ) -> torch.Tensor:
    """FPN level of each (..., 4) roi relative to min_level (int64)."""
    w = rois[..., 2] - rois[..., 0] + 1.0
    h = rois[..., 3] - rois[..., 1] + 1.0
    scale = torch.sqrt((w * h).clamp(min=1e-6))
    lvl = torch.floor(canonical_level
                      + torch.log2(scale / canonical_scale + 1e-8))
    return (lvl.clamp(min_level, max_level) - min_level).long()


def roi_taps(shapes: Sequence[Sequence[int]], strides: Sequence[int],
             rois: torch.Tensor, slabs: torch.Tensor, levels: torch.Tensor,
             p: int, s: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The 4 bilinear taps of each sample of N rois: (row into the level
    maps flattened and concatenated as (Σ S·H_l·W_l, C) rows, weight with
    validity and the 1/s² mean), each (N, P·s, P·s). A roi's extent is
    max(extent, 1); samples outside [-1, size] count zero, the others
    clamp to [0, size - 1]."""
    dev = rois.device
    hs = torch.tensor([sh[1] for sh in shapes], dtype=torch.float32,
                      device=dev)
    ws = torch.tensor([sh[2] for sh in shapes], dtype=torch.float32,
                      device=dev)
    sizes = [sh[0] * sh[1] * sh[2] for sh in shapes]
    offs = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                        dtype=torch.long, device=dev)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32,
                          device=dev)
    lvl = levels.long().clamp(0, len(shapes) - 1)
    slab = slabs.long().clamp(0, shapes[0][0] - 1)
    h_l, w_l, sc = hs[lvl], ws[lvl], scales[lvl]
    base = offs[lvl] + slab * (h_l * w_l).long()
    x1, y1, x2, y2 = (rois.float() * sc[:, None]).unbind(-1)
    bin_h = (y2 - y1).clamp(min=1.0) / p
    bin_w = (x2 - x1).clamp(min=1.0) / p
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :]
               + 0.5) / s).reshape(-1)
    ys = y1[:, None] + grid * bin_h[:, None]
    xs = x1[:, None] + grid * bin_w[:, None]
    yv = (ys >= -1.0) & (ys <= h_l[:, None])
    xv = (xs >= -1.0) & (xs <= w_l[:, None])
    ys, xs = ys.nan_to_num(0.0), xs.nan_to_num(0.0)
    yc = torch.minimum(ys.clamp(min=0.0), h_l[:, None] - 1.0)
    xc = torch.minimum(xs.clamp(min=0.0), w_l[:, None] - 1.0)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    wy1, wx1 = yc - y0, xc - x0
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.minimum(y0i + 1, h_l[:, None].long() - 1)
    x1i = torch.minimum(x0i + 1, w_l[:, None].long() - 1)
    vw = (yv[:, :, None] & xv[:, None, :]).float() / (s * s)
    taps = []
    for yi, wy in ((y0i, 1.0 - wy1), (y1i, wy1)):
        row = base[:, None] + yi * w_l[:, None].long()
        for xi, wx in ((x0i, 1.0 - wx1), (x1i, wx1)):
            taps.append((row[:, :, None] + xi[:, None, :],
                         wy[:, :, None] * wx[:, None, :] * vw))
    return taps


# FLOPs of the RoIAlign calls made since the last `take_roi_flops`: the
# benchmark's FLOP count adds them to what FlopCounterMode sees, which
# counts no gather. 2 per bilinear corner of each sample, forward; the same
# again for the backward where a gradient is taken.
_ROI_FLOPS = [0.0]


def take_roi_flops() -> float:
    out, _ROI_FLOPS[0] = _ROI_FLOPS[0], 0.0
    return out


def roi_align(features: Sequence[torch.Tensor], strides: Sequence[int],
              rois: torch.Tensor, slabs: torch.Tensor, levels: torch.Tensor,
              p: int, s: int) -> torch.Tensor:
    """Exact RoIAlign over (roi, slab) pairs: per-level maps (S, H, W, C),
    rois (N, 4) in image coordinates, slabs (N,), levels (N,) → (N, P, P,
    C) f32. Differentiable in the maps."""
    n, c = rois.shape[0], features[0].shape[-1]
    flat = torch.cat([f.float().reshape(-1, c) for f in features])
    out = None
    for idx, w in roi_taps([f.shape for f in features], strides, rois,
                           slabs, levels, p, s):
        g = flat.index_select(0, idx.reshape(-1)).reshape(n, p * s, p * s, c)
        term = g * w[..., None]
        out = term if out is None else out + term
    grad = any(f.requires_grad for f in features) and torch.is_grad_enabled()
    _ROI_FLOPS[0] += n * p * p * c * s * s * 4 * 2 * (2 if grad else 1)
    return out.reshape(n, p, s, p, s, c).sum(dim=(2, 4))


# -- NMS and top-k ----------------------------------------------------------

def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
              max_out: int, valid: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over leading lanes: boxes (..., N, 4), scores (..., N),
    valid (..., N) → (keep_idx, keep_mask), each (..., max_out), in
    descending score order (stable); a box is suppressed by a kept box of
    higher rank with IoU strictly above `thresh`."""
    scores = torch.where(valid, scores.float(),
                         torch.full_like(scores.float(), -1e10))
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes.float(), -2,
                     order[..., None].expand(order.shape + (4,)))
    vs = torch.gather(scores, -1, order) > -5e9
    n = vs.shape[-1]
    rank = torch.arange(n, device=vs.device)
    supp = (bbox_overlaps(b, b) > thresh) & (rank[:, None] < rank[None, :])
    removed = torch.zeros_like(vs)
    cols = []
    for i in range(n):
        keep = vs[..., i] & ~removed[..., i]
        cols.append(keep)
        removed = removed | (supp[..., i, :] & keep[..., None])
    kept = torch.stack(cols, dim=-1)
    pos = torch.cumsum(kept.long(), dim=-1) - 1
    tgt = torch.where(kept & (pos < max_out), pos,
                      torch.full_like(pos, max_out))
    lead = kept.shape[:-1]
    idx = torch.zeros(lead + (max_out + 1,), dtype=torch.long,
                      device=vs.device).scatter_(-1, tgt, order)
    mask = torch.zeros(lead + (max_out + 1,), dtype=torch.bool,
                       device=vs.device).scatter_(-1, tgt, kept)
    mask = mask[..., :max_out]
    return torch.where(mask, idx[..., :max_out], 0), mask


# -- keypoints --------------------------------------------------------------

def heatmaps_to_keypoints(hm: torch.Tensor, rois: torch.Tensor
                          ) -> torch.Tensor:
    """(R, K, H, W) heatmap logits + (R, 4) boxes → (R, K, 4): [x, y,
    logit, prob] at the first maximum, refined by a parabola through the
    peak and its neighbours on each axis, at the bin centre."""
    r, k, hh, ww = hm.shape
    flat = hm.reshape(r, k, hh * ww)
    top = torch.argmax(flat, dim=-1)
    py, px = top // ww, top % ww
    logit = torch.gather(flat, -1, top[..., None])[..., 0]
    prob = torch.gather(torch.softmax(flat, -1), -1, top[..., None])[..., 0]

    def at(dy, dx):
        ny, nx = (py + dy).clamp(0, hh - 1), (px + dx).clamp(0, ww - 1)
        return torch.gather(flat, -1, (ny * ww + nx)[..., None])[..., 0]

    def offset(lo, hi):
        den = lo - 2.0 * logit + hi
        ok = den.abs() > 1e-6
        off = torch.where(ok, 0.5 * (lo - hi) / torch.where(
            ok, den, torch.ones_like(den)), torch.zeros_like(den))
        return off.clamp(-0.5, 0.5)

    fx = px.float() + offset(at(0, -1), at(0, 1))
    fy = py.float() + offset(at(-1, 0), at(1, 0))
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    rw = (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1.0)
    rh = (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1.0)
    return torch.stack([x1 + (fx + 0.5) * rw / ww, y1 + (fy + 0.5) * rh / hh,
                        logit, prob], dim=-1)
