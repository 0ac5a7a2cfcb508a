"""Training targets with fixed sample counts (port of
detectandtrack_tpu/engine/targets.py): anchor labels and tube regression
targets, RoI sampling with box and keypoint targets, mask targets, keypoint
heatmap labels.

The random draws enter as tensors: each sampler takes the uniforms it ranks
by (`u_fg`, `u_bg`, one per candidate). A caller passes the draws of a
`torch.Generator`, and the tests pass the very draws the JAX package makes
with `jax.random.uniform`, so both select the same rows.

GT comes in padded: boxes (G, 4·T), keypoints (G, T, K, 3), valid (G,).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import torch

from ..ops import boxes as box_ops


class AnchorTargets(NamedTuple):
    labels: torch.Tensor        # (N,) 1 fg / 0 bg / -1 ignore
    bbox_targets: torch.Tensor  # (N, 4·T)
    weights: torch.Tensor       # (N,) 1 for sampled, else 0


def _random_subsample(mask: torch.Tensor, num: Union[int, torch.Tensor],
                      u: torch.Tensor) -> torch.Tensor:
    """Keep at most `num` True entries of `mask`: those whose uniform draw
    `u` ranks lowest (stable ties, as jnp.argsort)."""
    scores = u + (~mask).float() * 10.0
    order = torch.argsort(scores, stable=True)
    rank = torch.argsort(order, stable=True)
    return mask & (rank < num)


def rpn_targets(anchors: torch.Tensor, gt_tubes: torch.Tensor,
                gt_valid: torch.Tensor, num_frames: int,
                image_hw: Tuple[float, float], u_fg: torch.Tensor,
                u_bg: torch.Tensor, positive_overlap: float = 0.7,
                negative_overlap: float = 0.3, batch_size: int = 256,
                fg_fraction: float = 0.5, straddle_thresh: float = 0.0
                ) -> AnchorTargets:
    """Anchor labels + per-frame tube regression targets for one image;
    anchors (N, 4), draws u_fg, u_bg (N,)."""
    n = anchors.shape[0]
    g = gt_tubes.shape[0]
    t = num_frames
    center_gt = gt_tubes.reshape(g, t, 4)[:, t // 2]

    # Anchors straddling the image boundary are ignored before matching,
    # so a GT's guaranteed positive is its best inside anchor.
    h, w = image_hw
    inside = ((anchors[:, 0] >= -straddle_thresh)
              & (anchors[:, 1] >= -straddle_thresh)
              & (anchors[:, 2] < w + straddle_thresh)
              & (anchors[:, 3] < h + straddle_thresh))

    iou = box_ops.bbox_overlaps(anchors, center_gt)            # (N, G)
    iou = torch.where(gt_valid[None, :] & inside[:, None], iou,
                      torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=1)

    # fg: IoU >= thresh, or an argmax anchor of some GT (ties included).
    per_gt_best = iou.max(dim=0).values                         # (G,)
    is_best_for_gt = ((iou >= per_gt_best[None, :] - 1e-5) & (iou > 0)
                      & gt_valid[None, :]).any(dim=1)
    any_gt = gt_valid.any()
    fg = ((best_iou >= positive_overlap) | is_best_for_gt) & any_gt
    bg = ((best_iou < negative_overlap) & ~fg) | ~any_gt
    fg = fg & inside
    bg = bg & inside

    fg_keep = _random_subsample(fg, int(batch_size * fg_fraction), u_fg)
    # The batch is topped up with background when fg is scarce.
    bg_keep = _random_subsample(bg, batch_size - fg_keep.sum(), u_bg)
    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1))

    matched = gt_tubes[best_gt].reshape(n, t, 4)
    anchor_rep = anchors[:, None, :].expand(n, t, 4)
    tgt = box_ops.bbox_transform_inv(anchor_rep, matched).reshape(n, 4 * t)
    return AnchorTargets(labels=labels, bbox_targets=tgt,
                         weights=(labels >= 0).float())


class ProposalTargets(NamedTuple):
    rois: torch.Tensor              # (S, 4·T) sampled proposals (incl. GT)
    labels: torch.Tensor            # (S,) class id (0 = bg)
    bbox_targets: torch.Tensor      # (S, 4·T)
    bbox_weights: torch.Tensor      # (S,) 1 for fg
    keypoint_targets: torch.Tensor  # (S, T, K, 3) matched GT keypoints
    is_fg: torch.Tensor             # (S,) bool
    valid: torch.Tensor             # (S,) sampled-row validity
    gt_inds: torch.Tensor           # (S,) matched GT row


def proposal_targets(proposals: torch.Tensor, prop_valid: torch.Tensor,
                     gt_tubes: torch.Tensor, gt_keypoints: torch.Tensor,
                     gt_valid: torch.Tensor, num_frames: int,
                     u_fg: torch.Tensor, u_bg: torch.Tensor,
                     batch_size: int = 512, fg_fraction: float = 0.25,
                     fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                     bg_thresh_lo: float = 0.0,
                     reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0)
                     ) -> ProposalTargets:
    """Sample RoIs and build box/keypoint targets for one image. GT tubes
    are appended to the proposal pool; the draws u_fg, u_bg have one entry
    per pool row (P + G)."""
    t = num_frames
    pool = torch.cat([proposals.float(), gt_tubes.float()])
    pool_valid = torch.cat([prop_valid, gt_valid])
    p = pool.shape[0]
    g = gt_tubes.shape[0]

    center = pool.reshape(p, t, 4)[:, t // 2]
    center_gt = gt_tubes.reshape(g, t, 4)[:, t // 2]
    iou = box_ops.bbox_overlaps(center, center_gt)
    iou = torch.where(gt_valid[None, :] & pool_valid[:, None], iou,
                      torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=1)

    fg = best_iou >= fg_thresh
    # A GT-free image counts as overlap 0: all background.
    bg_iou = best_iou.clamp(min=0.0)
    bg = (bg_iou < bg_thresh_hi) & (bg_iou >= bg_thresh_lo) & pool_valid

    batch_size = min(batch_size, p)
    fg_keep = _random_subsample(fg, int(batch_size * fg_fraction), u_fg)
    bg_keep = _random_subsample(bg, batch_size - fg_keep.sum(), u_bg)

    # Selected rows first (fg then bg), padded to batch_size.
    order_score = torch.where(fg_keep, 0, torch.where(bg_keep, 1, 2))
    order = torch.argsort(order_score, stable=True)[:batch_size]
    sel_valid = order_score[order] < 2

    rois = pool[order]
    m = best_gt[order]
    matched = gt_tubes[m].reshape(batch_size, t, 4)
    tgt = box_ops.bbox_transform_inv(
        rois.reshape(batch_size, t, 4), matched,
        reg_weights).reshape(batch_size, 4 * t)
    is_fg = fg_keep[order] & sel_valid
    labels = torch.where(sel_valid & fg_keep[order], 1, 0)
    return ProposalTargets(rois=rois, labels=labels, bbox_targets=tgt,
                           bbox_weights=is_fg.float(),
                           keypoint_targets=gt_keypoints[m], is_fg=is_fg,
                           valid=sel_valid, gt_inds=m)


def mask_targets(rois: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_bitmaps: torch.Tensor, out_size: int) -> torch.Tensor:
    """Per-frame roi boxes (S, 4), their matched GT boxes (S, 4) and GT
    bitmaps (S, M, M) drawn in the GT box → binary targets (S, P, P) in the
    roi's frame: each roi pixel centre is sampled bilinearly from the
    bitmap (zero outside it) and thresholded at 0.5."""
    s = rois.shape[0]
    m = gt_bitmaps.shape[-1]
    p = out_size
    rois = rois.float()
    gt_boxes = gt_boxes.float()
    # Times 1/p, as XLA compiles the JAX package's `/ p`: for a roi equal to
    # its GT box some samples fall exactly half-way between bitmap pixels,
    # where the last ulp decides the 0.5 threshold.
    f = ((torch.arange(p, dtype=torch.float32, device=rois.device) + 0.5)
         * (1.0 / p))
    rx = rois[:, 0:1] + f[None, :] * (rois[:, 2:3] - rois[:, 0:1])   # (S, P)
    ry = rois[:, 1:2] + f[None, :] * (rois[:, 3:4] - rois[:, 1:2])
    gw = (gt_boxes[:, 2:3] - gt_boxes[:, 0:1]).clamp(min=1.0)
    gh = (gt_boxes[:, 3:4] - gt_boxes[:, 1:2]).clamp(min=1.0)
    u = ((rx - gt_boxes[:, 0:1]) / gw * m - 0.5)[:, None, :].expand(s, p, p)
    v = ((ry - gt_boxes[:, 1:2]) / gh * m - 0.5)[:, :, None].expand(s, p, p)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    flat = gt_bitmaps.float().reshape(s, m * m)

    def tap(vi, ui, w):
        inb = (ui >= 0) & (ui < m) & (vi >= 0) & (vi < m)
        idx = vi.clamp(0, m - 1).long() * m + ui.clamp(0, m - 1).long()
        val = torch.gather(flat, 1, idx.reshape(s, -1)).reshape(s, p, p)
        return torch.where(inb, val, torch.zeros_like(val)) * w

    out = (tap(v0, u0, (1 - du) * (1 - dv)) + tap(v0, u0 + 1, du * (1 - dv))
           + tap(v0 + 1, u0, (1 - du) * dv) + tap(v0 + 1, u0 + 1, du * dv))
    return (out >= 0.5).float()


def keypoint_heatmap_targets(rois: torch.Tensor, keypoints: torch.Tensor,
                             heatmap_size: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame boxes (S, 4) and matched GT keypoints (S, K, 3) → (bin
    index (S, K) int32, weight (S, K) f32); a keypoint counts if visible
    and inside its box."""
    hs = heatmap_size
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    w = (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1.0)
    h = (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1.0)
    fx = (keypoints[..., 0] - x1) / w * hs
    fy = (keypoints[..., 1] - y1) / h * hs
    bx = torch.floor(fx).clamp(0, hs - 1)
    by = torch.floor(fy).clamp(0, hs - 1)
    inside = (fx >= 0) & (fx < hs) & (fy >= 0) & (fy < hs)
    vis = keypoints[..., 2] > 0
    weight = (inside & vis).float()
    idx = (by * hs + bx).to(torch.int32)
    return idx, weight
