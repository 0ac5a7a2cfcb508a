"""Training: loss forward, SGD step, on one device or data-parallel over
ranks (port of detectandtrack_tpu/engine/train.py).

`make_train_step(model, cfg, mesh=None)` returns `step_fn(state, batch) →
(state, metrics)`: forward with targets and losses, backward through the
RoIAlign and conv1 kernels' autograd Functions, then the update of
`make_optimizer` (clip by global norm → masked weight decay → SGD with
momentum → zero for the frozen stages), in place on the model's
parameters. With a mesh of more than one rank (`parallel/mesh.py`, one
process per card), each rank runs the forward and backward on its own rows
with its own draws, then the gradients and the metrics are averaged over
the ranks in one all-reduce before the update, as JAX's `shard_map` step
`pmean`s them: the clip sees the global gradient. After a step each
parameter's `.grad` holds that step's (global) gradient.

Batch contract (padded, fixed shapes, tensors on the model's device):
  clips          (B, T, H, W, 3) float32
  gt_boxes       (B, G, 4·T)
  gt_keypoints   (B, G, T, K, 3)
  gt_valid       (B, G) bool
  gt_masks       (B, G, T, M, M) optional, MODEL.MASK_ON: GT bitmaps drawn
                 in each GT box
  gt_mask_valid  (B, G, T) bool, with gt_masks: which frames are annotated
A MASK_ON batch without gt_masks trains every other loss and reports no
loss_mask.

Random sampling enters as draws (see engine/targets.py): a `Draws`
callable gives, for a sampling stage ("rpn" or "proposals") and its
(batch, candidates) size, the uniforms the fg and bg samplers rank by. By
default they come from a CPU `torch.Generator` seeded by (RNG_SEED, step),
so a run on any device samples the same rows; rank r > 0 of a mesh seeds
from (RNG_SEED, step, r), as JAX folds the shard index into its key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.detector import GeneralizedRCNN
from ..parallel.mesh import Mesh, pmean
from ..models.rpn import anchor_cell_for_level, flatten_rpn_outputs
from ..ops.anchors import shifted_anchor_field
from ..utils.lr_policy import make_schedule
from ..utils.params import flax_path
from . import losses as L
from . import targets as T

Draws = Callable[[str, int, int], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, nn.Parameter]      # the model's, by port name
    momentum: Dict[str, torch.Tensor]    # SGD trace of the trained ones
    step: int


def generator_draws(seed: int, step: int, shard: int = 0) -> Draws:
    """Draws from a CPU generator seeded by (seed, step): seed·2^32 + step
    for shard 0 (one process, or rank 0), and for a rank `shard` > 0 a
    seed numpy's SeedSequence mixes from (seed, step, shard), so the ranks
    sample from streams apart from each other's."""
    if shard == 0:
        gen_seed = seed * 2 ** 32 + step
    else:
        gen_seed = int(np.random.SeedSequence([seed, step, shard])
                       .generate_state(1, np.uint64)[0])
    gen = torch.Generator().manual_seed(gen_seed)

    def draw(stage: str, b: int, n: int):
        u = torch.rand((2, b, n), generator=gen)
        return u[0], u[1]

    return draw


def _anchor_field_all_levels(cfg, maps, strides) -> np.ndarray:
    """Concatenated anchor field across the RPN levels' (B, T, H, W, C)
    maps (C4: the one res4 map with every RPN.SIZES anchor), in the order of
    the concatenated RPN outputs."""
    fields = [shifted_anchor_field(anchor_cell_for_level(cfg, li, stride),
                                   stride, fmap.shape[2], fmap.shape[3])
              for li, (fmap, stride) in enumerate(zip(maps, strides))]
    return np.concatenate(fields, axis=0)


def _stack(rows):
    """Per-image NamedTuples → one NamedTuple of (B, ...) tensors."""
    return type(rows[0])(*[torch.stack(f) for f in zip(*rows)])


def train_forward(model: GeneralizedRCNN, clips: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_keypoints: torch.Tensor,
                  gt_valid: torch.Tensor, draws: Draws,
                  gt_masks: Optional[torch.Tensor] = None,
                  gt_mask_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full training forward → (total loss, loss terms), with graphs.
    RPN_ONLY trains the RPN losses alone."""
    cfg = model.cfg
    t = model.num_frames
    b = clips.shape[0]
    dev = clips.device
    image_hw = (float(clips.shape[2]), float(clips.shape[3]))

    pyramid = model.features(clips)
    (tubes, _, p_valid), rpn_raw = model.propose(pyramid, image_hw,
                                                 train=True)

    # ---- RPN losses over the concatenated anchor field ----
    anchors = torch.as_tensor(
        _anchor_field_all_levels(cfg, *model._pyramid_list(pyramid)),
        device=dev)
    flat = [flatten_rpn_outputs(lg, dl, t) for lg, dl in rpn_raw]
    logits_all = torch.cat([f[0] for f in flat], dim=1)
    deltas_all = torch.cat([f[1] for f in flat], dim=1)
    u_fg, u_bg = draws("rpn", b, anchors.shape[0])
    rpn_terms = []
    for i in range(b):
        tgt = T.rpn_targets(
            anchors, gt_boxes[i], gt_valid[i], t, image_hw, u_fg[i].to(dev),
            u_bg[i].to(dev), cfg.RPN.POSITIVE_OVERLAP,
            cfg.RPN.NEGATIVE_OVERLAP, cfg.RPN.BATCH_SIZE_PER_IM,
            cfg.RPN.FG_FRACTION, float(cfg.RPN.STRADDLE_THRESH))
        rpn_terms.append(L.rpn_losses(logits_all[i], deltas_all[i],
                                      tgt.labels, tgt.bbox_targets,
                                      cfg.RPN.SMOOTH_L1_BETA))
    rpn_cls = torch.stack([c for c, _ in rpn_terms]).mean()
    rpn_box = torch.stack([bx for _, bx in rpn_terms]).mean()
    if cfg.MODEL.RPN_ONLY:
        total = rpn_cls + rpn_box
        return total, {"loss_rpn_cls": rpn_cls, "loss_rpn_bbox": rpn_box,
                       "loss_total": total}

    # ---- Proposal sampling + box head ----
    u_fg, u_bg = draws("proposals", b, tubes.shape[1] + gt_boxes.shape[1])
    ptgt = _stack([T.proposal_targets(
        tubes[i], p_valid[i], gt_boxes[i], gt_keypoints[i], gt_valid[i], t,
        u_fg[i].to(dev), u_bg[i].to(dev), cfg.FAST_RCNN.BATCH_SIZE_PER_IM,
        cfg.FAST_RCNN.FG_FRACTION, cfg.FAST_RCNN.FG_THRESH,
        cfg.FAST_RCNN.BG_THRESH_HI, cfg.FAST_RCNN.BG_THRESH_LO,
        cfg.FAST_RCNN.BBOX_REG_WEIGHTS) for i in range(b)])

    s = ptgt.rois.shape[1]
    pooled = model.roi_transform(pyramid, ptgt.rois,
                                 cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                                 cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO)
    cls_logits, deltas, _ = model.box_head(pooled)
    cls_loss, box_loss = L.fast_rcnn_losses(
        cls_logits, deltas.reshape(b * s, cfg.MODEL.NUM_CLASSES, t, 4),
        ptgt.labels.reshape(b * s), ptgt.bbox_targets.reshape(b * s, 4 * t),
        ptgt.bbox_weights.reshape(b * s), ptgt.valid.reshape(b * s),
        cfg.FAST_RCNN.SMOOTH_L1_BETA)

    total = rpn_cls + rpn_box + cls_loss + box_loss
    metrics = {"loss_rpn_cls": rpn_cls, "loss_rpn_bbox": rpn_box,
               "loss_cls": cls_loss, "loss_bbox": box_loss}

    # ---- Keypoint head on the first M (fg-first) RoIs ----
    if cfg.MODEL.KEYPOINTS_ON:
        kp = min(cfg.KRCNN.TRAIN_MAX_ROIS_PER_IM or s, s)
        kp_rois = ptgt.rois[:, :kp]                       # (B, KP, 4·T)
        kp_gt = ptgt.keypoint_targets[:, :kp]             # (B, KP, T, K, 3)
        kp_pooled = model.roi_transform(pyramid, kp_rois,
                                        cfg.KRCNN.ROI_XFORM_RESOLUTION,
                                        cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO)
        t_kp = t
        if cfg.VIDEO.VIDEO_ON and not cfg.VIDEO.PREDICT_ALL_FRAMES:
            # Center-frame supervision: the head trains on each tube's
            # center frame.
            c = t // 2
            kp_pooled = kp_pooled[:, c:c + 1]
            kp_rois = kp_rois.reshape(b, kp, t, 4)[:, :, c]
            kp_gt = kp_gt[:, :, c:c + 1]
            t_kp = 1
        hm_logits = model.kps_head(kp_pooled)           # (B·KP, Tk, S, S, K)
        hs = hm_logits.shape[2]
        n_kp = cfg.KRCNN.NUM_KEYPOINTS
        bins, w = T.keypoint_heatmap_targets(
            kp_rois.reshape(-1, 4), kp_gt.reshape(-1, n_kp, 3), hs)
        fg = ptgt.is_fg[:, :kp].reshape(-1).float().repeat_interleave(t_kp)
        kp_loss = L.keypoint_loss(hm_logits.reshape(-1, hs, hs, n_kp), bins,
                                  w * fg[:, None],
                                  cfg.KRCNN.NORMALIZE_BY_VISIBLE_KEYPOINTS,
                                  cfg.KRCNN.LOSS_WEIGHT)
        total = total + kp_loss
        metrics["loss_kps"] = kp_loss

    # ---- Mask head: per-pixel sigmoid CE of the person channel ----
    if cfg.MODEL.MASK_ON and gt_masks is not None:
        mb = min(cfg.MRCNN.TRAIN_MAX_ROIS_PER_IM or s, s)
        m_rois = ptgt.rois[:, :mb]                        # (B, MB, 4·T)
        gi = ptgt.gt_inds[:, :mb]                         # (B, MB)
        rows = torch.arange(b, device=dev)[:, None]
        mk_boxes = gt_boxes[rows, gi]                     # (B, MB, 4·T)
        mk_masks = gt_masks[rows, gi]                     # (B, MB, T, M, M)
        mk_valid = gt_mask_valid[rows, gi]                # (B, MB, T)
        m_logits = model.mask_head(model.roi_transform(
            pyramid, m_rois, cfg.MRCNN.ROI_XFORM_RESOLUTION,
            cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO))          # (B·MB, T, P, P, C)
        pm = m_logits.shape[2]
        mg = mk_masks.shape[-1]
        tgt = T.mask_targets(m_rois.reshape(-1, 4), mk_boxes.reshape(-1, 4),
                             mk_masks.reshape(-1, mg, mg), pm)
        w_mask = (ptgt.is_fg[:, :mb, None] & mk_valid.bool()).reshape(-1)
        m_loss = L.mask_loss(m_logits[..., 1].reshape(-1, pm, pm), tgt,
                             w_mask.float(), cfg.MRCNN.WEIGHT_LOSS_MASK)
        total = total + m_loss
        metrics["loss_mask"] = m_loss

    metrics["loss_total"] = total
    return total, metrics


def _frozen_stages(cfg) -> set:
    if cfg.RESNETS.FREEZE_AT < 1:
        return set()
    return {"conv1"} | {f"res{s}"
                        for s in range(2, cfg.RESNETS.FREEZE_AT + 1)}


class SGDMomentum:
    """`make_optimizer`'s optax chain: clip_by_global_norm (over every
    gradient, frozen ones included) → weight decay on the decay mask (conv
    and fc kernels) and WEIGHT_DECAY_BN on the rest → SGD trace
    m = g + μ·m → update −lr(step)·m, zero for the frozen stages. The masks
    come from each parameter's flax name (`utils.params.flax_path`)."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor]):
        solver = cfg.SOLVER
        self.schedule = make_schedule(solver)
        self.clip = solver.CLIP_GRAD_NORM
        self.decay_rate = solver.WEIGHT_DECAY
        self.decay_bn_rate = solver.WEIGHT_DECAY_BN
        self.mu = solver.MOMENTUM
        frozen_names = _frozen_stages(cfg)
        self.decay, self.frozen = set(), set()
        for key, p in params.items():
            names = flax_path(key)
            if not ("bn" in names or names[-1] == "bias" or p.ndim <= 1):
                self.decay.add(key)
            if any(n.split("_")[0] in frozen_names for n in names):
                self.frozen.add(key)

    def update(self, state: TrainState) -> None:
        """One step on `state` in place, from the parameters' `.grad`
        (a parameter without one has a zero gradient)."""
        grads = {k: p.grad for k, p in state.params.items()
                 if p.grad is not None}
        if self.clip > 0 and grads:
            norm = torch.sqrt(torch.stack(
                [g.float().square().sum() for g in grads.values()]).sum())
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, (g / norm) * self.clip)
                     for k, g in grads.items()}
        lr = self.schedule(state.step)
        with torch.no_grad():
            for key, p in state.params.items():
                if key in self.frozen:
                    continue
                g = grads.get(key)
                if g is None:
                    g = torch.zeros_like(p)
                if self.decay_rate > 0 and key in self.decay:
                    g = g + self.decay_rate * p
                if self.decay_bn_rate > 0 and key not in self.decay:
                    g = g + self.decay_bn_rate * p
                m = state.momentum.get(key)
                m = g if m is None else g + self.mu * m
                state.momentum[key] = m
                p.add_(m * -lr)


def make_optimizer(cfg, model: nn.Module) -> SGDMomentum:
    return SGDMomentum(cfg, dict(model.named_parameters()))


def create_train_state(cfg, model: nn.Module) -> TrainState:
    """State over the model's parameters. Frozen stages take no update, so
    their gradient is computed only where the global-norm clip reads it
    (CLIP_GRAD_NORM > 0), as JAX's clip sees every gradient."""
    params = dict(model.named_parameters())
    frozen = make_optimizer(cfg, model).frozen
    for key, p in params.items():
        p.requires_grad_(key not in frozen or cfg.SOLVER.CLIP_GRAD_NORM > 0)
    return TrainState(params=params, momentum={}, step=0)


def make_train_step(model: GeneralizedRCNN, cfg,
                    mesh: Optional[Mesh] = None):
    """→ step_fn(state, batch, draws=None) → (state, metrics): one SGD step;
    `draws` defaults to `generator_draws(RNG_SEED, step, rank)`. With a
    mesh, `batch` is this rank's rows of the global batch, and the
    gradients and metrics are the means over the ranks (a parameter with
    no gradient on a rank counts as zeros there, so every rank reduces the
    same buffer). Metrics are detached 0-d tensors on the device."""
    opt = make_optimizer(cfg, model)
    rank = mesh.rank if mesh is not None else 0

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                draws: Optional[Draws] = None):
        if draws is None:
            draws = generator_draws(cfg.RNG_SEED, state.step, rank)
        for p in state.params.values():
            p.grad = None
        total, metrics = train_forward(
            model, batch["clips"], batch["gt_boxes"], batch["gt_keypoints"],
            batch["gt_valid"], draws, batch.get("gt_masks"),
            batch.get("gt_mask_valid"))
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None and mesh.size > 1:
            trained = [p for p in state.params.values() if p.requires_grad]
            names = sorted(metrics)
            means = pmean(mesh, [p.grad if p.grad is not None
                                 else torch.zeros_like(p) for p in trained]
                          + [metrics[k] for k in names])
            for p, g in zip(trained, means):
                p.grad = g
            metrics = dict(zip(names, means[len(trained):]))
        opt.update(state)
        state = TrainState(state.params, state.momentum, state.step + 1)
        return state, metrics

    return step_fn
