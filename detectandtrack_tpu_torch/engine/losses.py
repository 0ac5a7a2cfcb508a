"""Detection losses (port of detectandtrack_tpu/engine/losses.py):
smooth-L1, softmax and sigmoid cross-entropy, the RPN and Fast R-CNN losses,
the mask loss and the keypoint heatmap loss. Every loss is computed in f32."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber) with transition point `beta`."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _normalizer(weights: torch.Tensor) -> torch.Tensor:
    return weights.sum().clamp(min=1.0)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Mean weighted softmax cross-entropy with integer labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (nll * weights).sum() / _normalizer(weights)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Mean weighted sigmoid cross-entropy (RPN objectness)."""
    logits = logits.float()
    loss = (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
    return (loss * weights).sum() / _normalizer(weights)


def rpn_losses(logits: torch.Tensor, deltas: torch.Tensor,
               labels: torch.Tensor, bbox_targets: torch.Tensor,
               beta: float = 0.1111111
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image: objectness (N,), deltas (N, 4T), labels (N,) 1/0/-1,
    targets (N, 4T) → sigmoid-CE over the sampled anchors and fg-only
    smooth-L1, both normalized by the number sampled."""
    sampled = (labels >= 0).float()
    fg = (labels == 1).float()
    cls_loss = sigmoid_ce(logits, labels.clamp(min=0).float(), sampled)
    box = smooth_l1(deltas.float(), bbox_targets, beta).sum(-1)
    box_loss = (box * fg).sum() / _normalizer(sampled)
    return cls_loss, box_loss


def fast_rcnn_losses(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                     labels: torch.Tensor, bbox_targets: torch.Tensor,
                     bbox_weights: torch.Tensor, valid: torch.Tensor,
                     beta: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cls logits (S, C), deltas (S, C, T, 4), labels (S,), targets
    (S, 4T), box weights (S,), valid (S,) → classification CE and the
    class-specific per-frame box smooth-L1."""
    s, _, t, _ = box_deltas.shape
    w = valid.float()
    cls_loss = softmax_ce(cls_logits, labels, w)
    idx = labels.long()[:, None, None, None].expand(s, 1, t, 4)
    picked = torch.gather(box_deltas.float(), 1, idx)[:, 0].reshape(s, 4 * t)
    box = smooth_l1(picked, bbox_targets, beta).sum(-1)
    box_loss = (box * bbox_weights).sum() / _normalizer(w)
    return cls_loss, box_loss


def mask_loss(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
              weights: torch.Tensor, loss_weight: float = 1.0
              ) -> torch.Tensor:
    """Per-pixel sigmoid CE of person-class logits (S, M, M) against binary
    targets (S, M, M), averaged over the pixels of the weighted rows
    (weights (S,): fg and annotated)."""
    logits = mask_logits.float()
    ce = (logits.clamp(min=0) - logits * mask_targets.float()
          + torch.log1p(torch.exp(-logits.abs())))
    w = weights.float()[:, None, None]
    denom = (w.sum() * logits.shape[1] * logits.shape[2]).clamp(min=1.0)
    return loss_weight * (ce * w).sum() / denom


def keypoint_loss(heatmap_logits: torch.Tensor, bin_targets: torch.Tensor,
                  weights: torch.Tensor, normalize_by_visible: bool = True,
                  loss_weight: float = 1.0) -> torch.Tensor:
    """Softmax-CE over the H² spatial bins per keypoint: logits
    (S, H, H, K), bin targets (S, K), weights (S, K)."""
    s, hh, ww, k = heatmap_logits.shape
    logits = heatmap_logits.float().permute(0, 3, 1, 2).reshape(s, k, hh * ww)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, bin_targets.long()[..., None])[..., 0]
    if normalize_by_visible:
        denom = _normalizer(weights)
    else:
        # Averaged over the supervised slots, as the JAX loss does.
        denom = (weights > 0).sum().clamp(min=1)
    return loss_weight * (nll * weights).sum() / denom
