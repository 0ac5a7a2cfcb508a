"""Fixed-budget greedy NMS and soft-NMS on torch tensors (port of
`nms_fixed`, `batched_nms_fixed`, `soft_nms_fixed` and `soft_nms_scan` in
detectandtrack_tpu/ops/nms.py).

The host `nms_numpy` (the multi-scale TTA merge) is a copy of the JAX
package's. `soft_nms_scan` is the sequential pick-and-decay loop, the plain
oracle `soft_nms_fixed` is held to; no model path runs it. Greedy NMS:
stable score sort, then `kernels/nms.py::nms_keep` from the sorted boxes:
with S[j, i] = "j outranks i and IoU > thresh", the keep mask kept =
valid & ¬any_j(S[j, i] & kept[j]) (the unique solution that the JAX
package's Jacobi fixpoint converges to), swept in score order; on the
card S is never built as an (N, N) tensor. Soft-NMS: the bulk-confirmation
rounds of the JAX package (see `soft_nms_fixed`), run by
`kernels/nms.py::soft_nms_confirm`. Both loops stay on the device: no
host decision ends them. Leading dims are independent lanes (the JAX
model vmaps over them).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.nms import nms_keep, soft_nms_confirm
from .boxes import bbox_overlaps

_NEG_INF = -1e10


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int, valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a static output budget, batched over leading dims.

    Args:
      boxes: (..., N, 4) x1y1x2y2.
      scores: (..., N).
      iou_thresh: suppression threshold (strict `ovr > thresh`).
      max_out: number of survivor slots returned.
      valid: optional (..., N) bool; invalid rows are never kept.

    Returns:
      (keep_idx, keep_mask), each (..., max_out): int64 indices into the
      input in descending score order, and the mask of real survivors.
      Masked-out slots point at index 0.
    """
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes.float(), -2,
                     order[..., None].expand(order.shape + (4,)))
    valid_sorted = torch.gather(scores, -1, order) > _NEG_INF / 2
    kept = nms_keep(b, valid_sorted, iou_thresh)

    # First `max_out` survivors in score order: scatter each survivor to its
    # rank; everything else lands in a discard slot.
    pos = torch.cumsum(kept.long(), dim=-1) - 1
    tgt = torch.where(kept & (pos < max_out), pos, torch.full_like(pos, max_out))
    lead = kept.shape[:-1]
    keep_idx = torch.zeros(lead + (max_out + 1,), dtype=torch.long,
                           device=boxes.device).scatter_(-1, tgt, order)
    keep_mask = torch.zeros(lead + (max_out + 1,), dtype=torch.bool,
                            device=boxes.device).scatter_(-1, tgt, kept)
    keep_mask = keep_mask[..., :max_out]
    keep_idx = torch.where(keep_mask, keep_idx[..., :max_out],
                           torch.zeros_like(keep_idx[..., :max_out]))
    return keep_idx, keep_mask


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                      class_ids: torch.Tensor, iou_thresh: float,
                      max_out: int, valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS: boxes of different classes never suppress each
    other. Each lane's boxes are shifted by class_id · (max coordinate + 2),
    so one `nms_fixed` call handles every class."""
    boxes = boxes.float()
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.amax(dim=(-2, -1), keepdim=True) + 1.0
    offsets = class_ids.float()[..., None] * (max_coord + 1.0)
    return nms_fixed(boxes + offsets, scores, iou_thresh, max_out, valid)


def soft_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                   sigma: float = 0.5, iou_thresh: float = 0.3,
                   score_thresh: float = 0.001, method: str = "linear",
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft-NMS (linear or gaussian decay) with a static output budget,
    batched over leading dims.

    The sequential pick-and-decay scan picks boxes in descending final-score
    order, so each round confirms, at its provisional score prov(i) = s_i ·
    Π decays from confirmed overlappers, every box that no unconfirmed
    overlapper outranks on (prov, -index); the loop ends when a round
    confirms nothing (`kernels/nms.py::soft_nms_confirm`, whose product
    is taken in a fixed order on either device).

    Returns (keep_idx, keep_mask, new_scores), each (..., max_out): int64
    indices in descending decayed-score order (0 where masked), the mask of
    picks above `score_thresh`, and their decayed scores (0 where masked).
    """
    n = boxes.shape[-2]
    dev = boxes.device
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    iou = bbox_overlaps(boxes, boxes)
    if method == "linear":
        dmat = torch.where(iou > iou_thresh, 1.0 - iou, torch.ones_like(iou))
    else:                                           # gaussian
        dmat = torch.exp(-(iou * iou) / sigma)
    overlaps = (dmat < 1.0) & ~torch.eye(n, dtype=torch.bool, device=dev)
    alive = scores > _NEG_INF / 2
    final = soft_nms_confirm(scores, dmat.float(), overlaps, alive, _NEG_INF)

    k = min(n, max_out)
    order = torch.argsort(-final, dim=-1, stable=True)[..., :k]
    out_scores = torch.gather(final, -1, order)
    mask = out_scores > score_thresh
    idx = torch.where(mask, order, torch.zeros_like(order))
    out_scores = torch.where(mask, out_scores, torch.zeros_like(out_scores))
    if k < max_out:
        idx, mask, out_scores = (
            torch.cat([x, x.new_zeros(x.shape[:-1] + (max_out - k,))], -1)
            for x in (idx, mask, out_scores))
    return idx, mask, out_scores


def soft_nms_scan(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                  sigma: float = 0.5, iou_thresh: float = 0.3,
                  score_thresh: float = 0.001, method: str = "linear",
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential soft-NMS, batched over leading dims: `max_out` times, pick
    the highest alive score (first index on ties), decay every alive score
    by its overlap with the pick, retire the pick. The Cython reference's
    loop, and the oracle of `soft_nms_fixed`; same outputs."""
    n = boxes.shape[-2]
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    iou = bbox_overlaps(boxes, boxes)
    alive = scores > _NEG_INF / 2
    cur = scores
    neg = torch.full_like(scores, _NEG_INF)
    idx, mask, out = [], [], []
    for _ in range(max_out):
        masked = torch.where(alive, cur, neg)
        i = torch.argmax(masked, dim=-1, keepdim=True)
        top = torch.gather(masked, -1, i)
        ok = top > score_thresh
        row = torch.gather(iou, -2, i[..., None].expand(
            i.shape[:-1] + (1, n)))[..., 0, :]
        if method == "linear":
            decay = torch.where(row > iou_thresh, 1.0 - row,
                                torch.ones_like(row))
        else:                                       # gaussian
            decay = torch.exp(-(row * row) / sigma)
        cur = torch.where(alive, cur * decay, cur)
        alive = alive.scatter(-1, i, False)
        idx.append(torch.where(ok, i, torch.zeros_like(i)))
        mask.append(ok)
        out.append(torch.where(ok, top, torch.zeros_like(top)))
    return torch.cat(idx, -1), torch.cat(mask, -1), torch.cat(out, -1)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, thresh: float
              ) -> List[int]:
    """Host greedy NMS with the Cython reference's semantics (port of
    `nms_numpy` in detectandtrack_tpu/ops/nms.py): the +1 box-area
    convention, suppression at a strict `ovr > thresh`, and the order of
    `scores.argsort()[::-1]` (numpy's sort, reversed) → kept indices."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep
