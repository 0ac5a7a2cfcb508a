"""The plain reference of one fine-tuning step of the detector: anchor and
RoI targets with fixed sample counts, the RPN, Fast R-CNN and keypoint
losses, the gradient by autograd through plain RoIAlign, and the update
(clip by global norm → weight decay → SGD with momentum → nothing for the
frozen stages), as Detectron's recipe and the system define them.

A frozen copy of the system's step as it stood when the benchmark was
written. The random sampling takes its uniforms as inputs (`draws(stage,
b, n)` → (u_fg, u_bg)), which the benchmark makes from the seed and hands
to both sides.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import ops
from .model import Detector

Draws = Callable[[str, int, int], Tuple[torch.Tensor, torch.Tensor]]


# -- targets ----------------------------------------------------------------

def _subsample(mask, num, u):
    """The `num` True entries of `mask` whose draws rank lowest."""
    order = torch.argsort(u + (~mask).float() * 10.0, stable=True)
    return mask & (torch.argsort(order, stable=True) < num)


def rpn_targets(anchors, gt, gt_valid, t, image_hw, u_fg, u_bg, rpn):
    n, g = anchors.shape[0], gt.shape[0]
    centre = gt.reshape(g, t, 4)[:, t // 2]
    h, w = image_hw
    st = float(rpn["STRADDLE_THRESH"])
    inside = ((anchors[:, 0] >= -st) & (anchors[:, 1] >= -st)
              & (anchors[:, 2] < w + st) & (anchors[:, 3] < h + st))
    iou = ops.bbox_overlaps(anchors, centre)
    iou = torch.where(gt_valid[None] & inside[:, None], iou, -1.0)
    best, best_gt = iou.max(dim=1)
    per_gt = iou.max(dim=0).values
    is_best = ((iou >= per_gt[None] - 1e-5) & (iou > 0)
               & gt_valid[None]).any(dim=1)
    any_gt = gt_valid.any()
    fg = ((best >= rpn["POSITIVE_OVERLAP"]) | is_best) & any_gt & inside
    bg = (((best < rpn["NEGATIVE_OVERLAP"]) & ~fg) | ~any_gt) & inside
    size = rpn["BATCH_SIZE_PER_IM"]
    fg_keep = _subsample(fg, int(size * rpn["FG_FRACTION"]), u_fg)
    bg_keep = _subsample(bg, size - fg_keep.sum(), u_bg)
    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1))
    tgt = ops.bbox_transform_inv(anchors[:, None].expand(n, t, 4),
                                 gt[best_gt].reshape(n, t, 4))
    return labels, tgt.reshape(n, 4 * t)


def proposal_targets(props, prop_valid, gt, gt_kps, gt_valid, t, u_fg, u_bg,
                     fr):
    pool = torch.cat([props.float(), gt.float()])
    pool_valid = torch.cat([prop_valid, gt_valid])
    p, g = pool.shape[0], gt.shape[0]
    iou = ops.bbox_overlaps(pool.reshape(p, t, 4)[:, t // 2],
                            gt.reshape(g, t, 4)[:, t // 2])
    iou = torch.where(gt_valid[None] & pool_valid[:, None], iou, -1.0)
    best, best_gt = iou.max(dim=1)
    fg = best >= fr["FG_THRESH"]
    bgi = best.clamp(min=0.0)
    bg = (bgi < fr["BG_THRESH_HI"]) & (bgi >= fr["BG_THRESH_LO"]) & pool_valid
    size = min(fr["BATCH_SIZE_PER_IM"], p)
    fg_keep = _subsample(fg, int(size * fr["FG_FRACTION"]), u_fg)
    bg_keep = _subsample(bg, size - fg_keep.sum(), u_bg)
    rank = torch.where(fg_keep, 0, torch.where(bg_keep, 1, 2))
    order = torch.argsort(rank, stable=True)[:size]
    sel = rank[order] < 2
    rois = pool[order]
    m = best_gt[order]
    tgt = ops.bbox_transform_inv(rois.reshape(size, t, 4),
                                 gt[m].reshape(size, t, 4),
                                 fr["BBOX_REG_WEIGHTS"]).reshape(size, 4 * t)
    is_fg = fg_keep[order] & sel
    return rois, is_fg.long(), tgt, is_fg.float(), gt_kps[m], is_fg, sel


def heatmap_targets(rois, kps, hs):
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    w = (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1.0)
    h = (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1.0)
    fx = (kps[..., 0] - x1) / w * hs
    fy = (kps[..., 1] - y1) / h * hs
    bx = torch.floor(fx).clamp(0, hs - 1)
    by = torch.floor(fy).clamp(0, hs - 1)
    inside = (fx >= 0) & (fx < hs) & (fy >= 0) & (fy < hs)
    return (by * hs + bx).long(), (inside & (kps[..., 2] > 0)).float()


# -- losses -----------------------------------------------------------------

def _norm(w):
    return w.sum().clamp(min=1.0)


def smooth_l1(d, beta):
    d = d.abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def sigmoid_ce(logits, labels, w):
    loss = (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
    return (loss * w).sum() / _norm(w)


def softmax_ce(logits, labels, w):
    nll = -torch.gather(F.log_softmax(logits, -1), -1, labels[:, None])[:, 0]
    return (nll * w).sum() / _norm(w)


# -- the step ---------------------------------------------------------------

def train_forward(det: Detector, batch: Dict[str, torch.Tensor],
                  draws: Draws) -> Dict[str, torch.Tensor]:
    """Loss terms of one step (with graphs to the parameters)."""
    cfg, t = det.cfg, det.t
    clips = batch["clips"]
    b = clips.shape[0]
    image_hw = (float(clips.shape[2]), float(clips.shape[3]))
    rpn, fr, kr = cfg["RPN"], cfg["FAST_RCNN"], cfg["KRCNN"]
    pyramid = det.features(clips)
    raw = det.rpn(pyramid)
    tubes, p_valid = det.propose(pyramid, raw, image_hw, train=True)

    anchors = torch.cat(det.anchor_fields(pyramid))
    logits = torch.cat([lg for lg, _ in raw], 1)
    deltas = torch.cat([dl for _, dl in raw], 1)
    u_fg, u_bg = draws("rpn", b, anchors.shape[0])
    cls_terms, box_terms = [], []
    for i in range(b):
        labels, tgt = rpn_targets(anchors, batch["gt_boxes"][i],
                                  batch["gt_valid"][i], t, image_hw,
                                  u_fg[i].to(clips.device),
                                  u_bg[i].to(clips.device), rpn)
        sampled = (labels >= 0).float()
        cls_terms.append(sigmoid_ce(logits[i], labels.clamp(min=0).float(),
                                    sampled))
        box = smooth_l1(deltas[i] - tgt, rpn["SMOOTH_L1_BETA"]).sum(-1)
        box_terms.append((box * (labels == 1).float()).sum()
                         / _norm(sampled))
    terms = {"loss_rpn_cls": torch.stack(cls_terms).mean(),
             "loss_rpn_bbox": torch.stack(box_terms).mean()}

    u_fg, u_bg = draws("proposals", b,
                       tubes.shape[1] + batch["gt_boxes"].shape[1])
    rows = [proposal_targets(tubes[i], p_valid[i], batch["gt_boxes"][i],
                             batch["gt_keypoints"][i], batch["gt_valid"][i],
                             t, u_fg[i].to(clips.device),
                             u_bg[i].to(clips.device), fr) for i in range(b)]
    rois, labels, tgt, bw, kp_gt, is_fg, sel = (torch.stack(f)
                                                for f in zip(*rows))
    s = rois.shape[1]
    pooled = det.roi_transform(pyramid, rois, fr["ROI_XFORM_RESOLUTION"],
                               fr["ROI_XFORM_SAMPLING_RATIO"])
    cls, dl, _ = det.box_head(pooled)
    w = sel.reshape(-1).float()
    terms["loss_cls"] = softmax_ce(cls, labels.reshape(-1), w)
    dl = dl.reshape(b * s, cfg["MODEL"]["NUM_CLASSES"], t, 4)
    idx = labels.reshape(-1)[:, None, None, None].expand(b * s, 1, t, 4)
    picked = torch.gather(dl, 1, idx)[:, 0].reshape(b * s, 4 * t)
    box = smooth_l1(picked - tgt.reshape(b * s, 4 * t),
                    fr["SMOOTH_L1_BETA"]).sum(-1)
    terms["loss_bbox"] = (box * bw.reshape(-1)).sum() / _norm(w)

    kp = min(kr["TRAIN_MAX_ROIS_PER_IM"] or s, s)
    kp_rois = rois[:, :kp]
    hm = det.kps_head(det.roi_transform(pyramid, kp_rois,
                                        kr["ROI_XFORM_RESOLUTION"],
                                        kr["ROI_XFORM_SAMPLING_RATIO"]))
    hs, n_kp = hm.shape[2], kr["NUM_KEYPOINTS"]
    bins, wk = heatmap_targets(kp_rois.reshape(-1, 4),
                               kp_gt[:, :kp].reshape(-1, n_kp, 3), hs)
    fg = is_fg[:, :kp].reshape(-1).float().repeat_interleave(t)
    wk = wk * fg[:, None]
    lg = hm.reshape(-1, hs, hs, n_kp).permute(0, 3, 1, 2).reshape(
        -1, n_kp, hs * hs)
    nll = -torch.gather(F.log_softmax(lg, -1), -1, bins[..., None])[..., 0]
    denom = (_norm(wk) if kr["NORMALIZE_BY_VISIBLE_KEYPOINTS"]
             else (wk > 0).sum().clamp(min=1))
    terms["loss_kps"] = kr["LOSS_WEIGHT"] * (nll * wk).sum() / denom
    terms["loss_total"] = sum(terms.values())
    return terms


def frozen(cfg: Dict, name: str) -> bool:
    """A parameter of a stage at or below RESNETS.FREEZE_AT."""
    at = cfg["RESNETS"]["FREEZE_AT"]
    stages = ({"conv1"} | {f"res{s}" for s in range(2, at + 1)}
              if at >= 1 else set())
    return any(part.split("_")[0] in stages for part in name.split("."))


def decayed(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to convolution and fully connected kernels."""
    parts = name.split(".")
    return not ("bn" in parts or parts[-1] == "bias" or p.ndim <= 1)


def learning_rate(solver: Dict, step: int) -> float:
    """The solver's rate at `step` (steps with decay, linear warm-up), in
    float32 as the system evaluates it."""
    s = torch.tensor(float(step), dtype=torch.float32)
    if solver["LR_POLICY"] == "fixed":
        lr = torch.tensor(solver["BASE_LR"], dtype=torch.float32)
    elif solver["LR_POLICY"] == "steps_with_decay":
        idx = (s >= torch.tensor(solver["STEPS"], dtype=torch.float32)).sum()
        lr = solver["BASE_LR"] * torch.tensor(
            solver["GAMMA"], dtype=torch.float32) ** (idx - 1).clamp(
                min=0).float()
    else:
        lr = solver["BASE_LR"] * torch.tensor(
            solver["GAMMA"], dtype=torch.float32) ** torch.floor(s / 30000.0)
    if solver["WARM_UP_ITERS"] > 0:
        a = (s / solver["WARM_UP_ITERS"]).clamp(0.0, 1.0)
        if solver["WARM_UP_METHOD"] == "linear":
            lr = lr * (solver["WARM_UP_FACTOR"] * (1 - a) + a)
        else:
            lr = lr * (solver["WARM_UP_FACTOR"]
                       if step < solver["WARM_UP_ITERS"] else 1.0)
    return float(lr)


class ReferenceStep:
    """Steps the reference from `params` and `momentum` (copied to float32
    leaves) at step number `step`."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 precision: str = "f32",
                 momentum: Dict[str, torch.Tensor] = None, step: int = 0):
        self.cfg = cfg
        self.params = {k: v.detach().float().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.momentum: Dict[str, torch.Tensor] = {
            k: v.detach().float().clone() for k, v in (momentum or {}).items()}
        self.precision = precision
        self.step = step

    def __call__(self, batch, draws: Draws) -> Tuple[Dict[str, float],
                                                     Dict[str, torch.Tensor]]:
        """One step → (loss terms, the gradients as the optimizer gets them
        after the clip)."""
        solver = self.cfg["SOLVER"]
        for p in self.params.values():
            p.grad = None
        det = Detector(self.cfg, self.params, self.precision)
        terms = train_forward(det, batch, draws)
        terms["loss_total"].backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        clip = solver["CLIP_GRAD_NORM"]
        if clip > 0:
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            if not norm < clip:
                grads = {k: g / norm * clip for k, g in grads.items()}
        lr = learning_rate(solver, self.step)
        with torch.no_grad():
            for k, p in self.params.items():
                if frozen(self.cfg, k):
                    continue
                g = grads[k]
                rate = (solver["WEIGHT_DECAY"] if decayed(k, p)
                        else solver["WEIGHT_DECAY_BN"])
                if rate > 0:
                    g = g + rate * p
                m = self.momentum.get(k)
                m = g if m is None else g + solver["MOMENTUM"] * m
                self.momentum[k] = m
                p.sub_(lr * m)
        self.step += 1
        return ({k: float(v.detach()) for k, v in terms.items()},
                {k: g.detach() for k, g in grads.items()})


def leaf_gap_map(ours: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 keep: Sequence[str]) -> Dict[str, float]:
    """Per leaf of `keep`, the gap between the two norms over max(the
    reference's norm of the leaf, the median leaf's reference norm)."""
    norms = {k: float(ref[k].float().norm()) for k in keep}
    med = sorted(norms.values())[len(norms) // 2] if norms else 0.0
    return {k: abs(float(ours[k].float().norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in keep}
