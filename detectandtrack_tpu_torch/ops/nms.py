"""Fixed-budget greedy NMS on torch tensors (port of `nms_fixed` in
detectandtrack_tpu/ops/nms.py).

Same algorithm as the reference: stable score sort, the strictly
upper-triangular suppression matrix S[j, i] = "j outranks i and IoU > thresh",
and the Jacobi fixpoint kept ← valid & ¬any_j(S[j, i] & kept[j]), which
converges to exactly the greedy result. Leading dims are independent lanes
(the JAX model vmaps over them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
    n = boxes.shape[-2]
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes.float(), -2,
                     order[..., None].expand(order.shape + (4,)))
    valid_sorted = torch.gather(scores, -1, order) > _NEG_INF / 2

    rank = torch.arange(n, device=boxes.device)
    supp = (bbox_overlaps(b, b) > iou_thresh) & (rank[:, None] < rank[None, :])
    kept = valid_sorted
    for _ in range(n):
        new = valid_sorted & ~(supp & kept[..., :, None]).any(dim=-2)
        if torch.equal(new, kept):
            break
        kept = new

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
