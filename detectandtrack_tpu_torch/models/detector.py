"""GeneralizedRCNN — the 3D Mask R-CNN inference path as a torch module.

Port of detectandtrack_tpu/models/detector.py for the FPN keypoint model:
backbone → FPN → tube-RPN → proposal decode + fixed-budget NMS → multilevel
RoIAlign-3D → 2-FC box head → final NMS → RoIAlign-3D on the top
detections → keypoint head → heatmap decode. Shapes are static and padded
with validity masks, as in the JAX model:

  boxes (B, D, 4T) · scores (B, D) · valid (B, D) · features (B, D, 1024)
  · keypoints (B, D, T, K, 4)

`build_model` rejects configurations off this path (masks, RPN-only,
soft-NMS, box voting, TTA, C4, center-frame keypoints) with
NotImplementedError rather than diverging from the reference. The same
model trains: `engine/train.py` runs `features`, `propose(train=True)`,
`roi_transform` and the heads, and gradients flow through the RoIAlign and
conv1 kernels' autograd Functions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detectandtrack_tpu.ops.anchors import shifted_anchor_field

from ..kernels.roi_align import (assign_fpn_levels,
                                 roi_align_multilevel_autograd)
from ..ops import boxes as box_ops
from ..ops.keypoints import heatmaps_to_keypoints
from ..ops.nms import nms_fixed
from .backbone import BASIC_ARCHS, backbone_from_cfg, compute_dtype
from .fpn import FPN
from .heads import BoxHead2MLP, KeypointHead
from .rpn import (RPNHead, anchor_cell_for_level, center_frame_box,
                  collect_fpn_proposals, decode_tube_proposals,
                  flatten_rpn_outputs, topk_stable)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along dim 1 by idx (B, M) → (B, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class GeneralizedRCNN(nn.Module):
    """cfg-driven detection model; forward returns raw head outputs plus the
    decoded, NMS'd detections."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
        self.num_frames = t
        expansion = 1 if cfg.MODEL.CONV_BODY in BASIC_ARCHS else 4
        self.backbone = backbone_from_cfg(cfg)
        self.fpn = FPN({f"res{i + 2}": 64 * expansion * 2 ** i
                        for i in range(4)},
                       dim=cfg.FPN.DIM,
                       zero_init_lateral=cfg.FPN.ZERO_INIT_LATERAL,
                       dtype=dtype)
        self.rpn_head = RPNHead(cfg.FPN.DIM, len(cfg.RPN.ASPECT_RATIOS), t,
                                dtype)
        p_box = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
        self.box_head = BoxHead2MLP(t * p_box * p_box * cfg.FPN.DIM,
                                    cfg.MODEL.NUM_CLASSES, t,
                                    cfg.FAST_RCNN.MLP_HEAD_DIM, dtype)
        if cfg.MODEL.KEYPOINTS_ON:
            self.kps_head = KeypointHead(
                cfg.FPN.DIM, cfg.KRCNN.NUM_KEYPOINTS,
                cfg.KRCNN.NUM_STACKED_CONVS, cfg.KRCNN.CONV_HEAD_DIM,
                cfg.KRCNN.CONV_HEAD_KERNEL, dtype)

    # -- features ---------------------------------------------------------

    def features(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        """clips (B, T, H, W, 3) → pyramid {p2..p6}, (B, T, H_l, W_l, C)."""
        return self.fpn(self.backbone(clips))

    # -- RPN + proposals --------------------------------------------------

    def propose(self, pyramid, image_hw: Tuple[float, float],
                train: bool = False):
        """→ (tubes (B, K, 4T), scores (B, K), valid (B, K)) and the raw
        per-level RPN outputs. Every (level, image) lane shares one batched
        fixed-budget NMS, as the JAX model vmaps it. `train` takes the
        RPN.*_TRAIN budgets. The kept tubes and scores carry no gradient
        (JAX's stop_gradient): the RoI losses must not reach the RPN
        through the roi coordinates."""
        cfg = self.cfg
        t = self.num_frames
        lvls = range(cfg.FPN.RPN_MIN_LEVEL, cfg.FPN.RPN_MAX_LEVEL + 1)
        pre = (cfg.RPN.PRE_NMS_TOP_N_TRAIN if train
               else cfg.RPN.PRE_NMS_TOP_N_TEST)
        post = (cfg.RPN.POST_NMS_TOP_N_TRAIN if train
                else cfg.RPN.POST_NMS_TOP_N_TEST)
        raw = []
        lvl_tubes, lvl_scores = [], []
        for li, lvl in enumerate(lvls):
            fmap, stride = pyramid[f"p{lvl}"], 2 ** lvl
            logits, deltas = self.rpn_head(fmap)
            raw.append((logits, deltas))
            scores, deltas = flatten_rpn_outputs(logits, deltas, t)
            field = torch.as_tensor(shifted_anchor_field(
                anchor_cell_for_level(cfg, li, stride), stride,
                fmap.shape[2], fmap.shape[3]), device=fmap.device)
            k_pre = min(pre, scores.shape[1])
            ts, ti = topk_stable(scores, k_pre)                  # (B, k_pre)
            tubes = decode_tube_proposals(field[ti], _gather_rows(deltas, ti),
                                          image_hw, t)
            if k_pre < pre:            # small level: pad to a common width
                tubes = F.pad(tubes, (0, 0, 0, pre - k_pre))
                ts = F.pad(ts, (0, pre - k_pre), value=float("-inf"))
            lvl_tubes.append(tubes)
            lvl_scores.append(ts)

        b = lvl_tubes[0].shape[0]
        n_lvl = len(lvl_tubes)
        flat_tubes = torch.stack(lvl_tubes).reshape(
            n_lvl * b, pre, 4 * t).detach()
        flat_scores = torch.stack(lvl_scores).reshape(n_lvl * b, pre).detach()
        rep = center_frame_box(flat_tubes, t)
        valid = torch.isfinite(flat_scores)
        if cfg.RPN.MIN_SIZE > 0:
            valid = valid & box_ops.filter_small_boxes(rep, cfg.RPN.MIN_SIZE)
        keep_idx, keep_mask = nms_fixed(rep, flat_scores, cfg.RPN.NMS_THRESH,
                                        post, valid)
        sel_tubes = _gather_rows(flat_tubes, keep_idx).reshape(
            n_lvl, b, post, 4 * t)
        sel_scores = torch.gather(flat_scores, 1, keep_idx).reshape(
            n_lvl, b, post)
        sel_valid = keep_mask.reshape(n_lvl, b, post)
        tubes, scores, valid = collect_fpn_proposals(
            sel_tubes.unbind(0), sel_scores.unbind(0), sel_valid.unbind(0),
            post)
        return (tubes, scores, valid), raw

    # -- RoI feature transform --------------------------------------------

    def roi_transform(self, pyramid, tubes: torch.Tensor, resolution: int,
                      sampling_ratio: int) -> torch.Tensor:
        """tubes (B, K, 4T) → pooled (B·K, T, P, P, C). The level comes from
        the center-frame box; frame f of a tube pools from slab b·T + f."""
        cfg = self.cfg
        t = self.num_frames
        b, k = tubes.shape[:2]
        lvls = range(cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL + 1)
        per_frame = tubes.float().reshape(b, k, t, 4)
        slab_rois = per_frame.permute(0, 2, 1, 3).reshape(b * t, k, 4)
        center = per_frame[:, :, t // 2, :].reshape(b * k, 4)
        levels = assign_fpn_levels(
            center, cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
            cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL)
        slab_levels = levels.reshape(b, 1, k).expand(b, t, k).reshape(b * t,
                                                                      k)
        flat_maps = [pyramid[f"p{l}"].reshape((-1,)
                                              + pyramid[f"p{l}"].shape[2:])
                     .contiguous() for l in lvls]
        pooled = roi_align_multilevel_autograd(
            flat_maps, [2 ** l for l in lvls], slab_rois.contiguous(),
            slab_levels.contiguous(), resolution, sampling_ratio)
        c = pooled.shape[-1]
        pooled = pooled.reshape(b, t, k, resolution, resolution, c)
        return pooled.permute(0, 2, 1, 3, 4, 5).reshape(
            b * k, t, resolution, resolution, c)

    # -- inference stages -------------------------------------------------

    def _box_candidates(self, pyramid, image_hw, proposals=None,
                        run_rpn: bool = True, proposal_valid=None):
        """Proposals + box head → per-candidate refined tubes and scores.

        With `proposals` and `run_rpn` the RPN and its NMS still run and the
        supplied tubes replace the selected ones through the same
        isfinite(sum(scores)) select as the JAX model; without `run_rpn`
        the RPN is skipped.
        """
        cfg = self.cfg
        t = self.num_frames
        if proposals is None or run_rpn:
            (tubes, p_scores, p_valid), rpn_raw = self.propose(pyramid,
                                                               image_hw)
            if proposals is not None:
                kp = proposals.shape[1]
                base = tubes[:, :kp]
                if kp > tubes.shape[1]:
                    base = F.pad(tubes, (0, 0, 0, kp - tubes.shape[1]))
                keep = torch.isfinite(p_scores.sum())
                tubes = torch.where(keep, proposals.float(), base)
                p_scores = torch.ones(tubes.shape[:2], device=tubes.device)
                p_valid = torch.ones(tubes.shape[:2], dtype=torch.bool,
                                     device=tubes.device)
        else:
            tubes = proposals.float()
            p_valid = (torch.ones(tubes.shape[:2], dtype=torch.bool,
                                  device=tubes.device)
                       if proposal_valid is None else proposal_valid.bool())
            p_scores = p_valid.float()
            rpn_raw = []
        b, k = tubes.shape[:2]

        pooled = self.roi_transform(pyramid, tubes,
                                    cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                                    cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO)
        cls_logits, deltas, fc7 = self.box_head(pooled)
        probs = torch.softmax(cls_logits, dim=-1)
        deltas = deltas.reshape(b * k, cfg.MODEL.NUM_CLASSES, t, 4)
        person_deltas = deltas[:, 1].reshape(-1, 4)
        refined = box_ops.bbox_transform(
            tubes.reshape(-1, 4), person_deltas,
            cfg.FAST_RCNN.BBOX_REG_WEIGHTS).reshape(b * k, 4 * t)
        refined = box_ops.clip_boxes(refined, image_hw[0], image_hw[1])
        return {
            "tubes": tubes, "p_scores": p_scores, "p_valid": p_valid,
            "refined": refined.reshape(b, k, 4 * t),
            "scores": probs[:, 1].reshape(b, k),
            "fc7": fc7.reshape(b, k, -1),
            "cls_logits": cls_logits, "box_deltas": deltas,
            "rpn_raw": rpn_raw,
        }

    def _finalize_detections(self, refined, scores, valid, fc7):
        """Candidates (B, K, ...) → final hard-NMS'd detections (B, D, ...)."""
        cfg = self.cfg
        t = self.num_frames
        b, k = scores.shape
        center = refined.reshape(b, k, t, 4)[:, :, t // 2]
        ok = valid & (scores >= cfg.TEST.SCORE_THRESH)
        idx, mask = nms_fixed(center, scores, cfg.TEST.NMS,
                              cfg.TEST.DETECTIONS_PER_IM, ok)
        return (_gather_rows(refined, idx), torch.gather(scores, 1, idx),
                mask, _gather_rows(fc7, idx))

    def _kps_box_prep(self, det_boxes):
        """Score-ranked keypoint budget (KRCNN.MAX_ROIS_PER_IM) →
        (kp_boxes (B, M, 4T), m_kp)."""
        d_max = det_boxes.shape[1]
        m_kp = min(self.cfg.KRCNN.MAX_ROIS_PER_IM or d_max, d_max)
        return det_boxes[:, :m_kp], m_kp

    def _keypoint_heatmaps(self, pyramid, kp_boxes) -> torch.Tensor:
        """Heatmaps (B·M, T, S, S, K) for the given boxes."""
        cfg = self.cfg
        kp_pooled = self.roi_transform(pyramid, kp_boxes,
                                       cfg.KRCNN.ROI_XFORM_RESOLUTION,
                                       cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO)
        return self.kps_head(kp_pooled)

    def _decode_keypoints(self, heatmaps, kp_boxes, m_kp, d_max):
        """Heatmaps (B·M, T, S, S, K) + boxes → padded (B, D, T, K, 4)."""
        cfg = self.cfg
        t = self.num_frames
        b = kp_boxes.shape[0]
        s_hm = heatmaps.shape[2]
        n_kp = cfg.KRCNN.NUM_KEYPOINTS
        hm_flat = heatmaps.reshape(b * m_kp * t, s_hm, s_hm, n_kp)
        kps = heatmaps_to_keypoints(hm_flat.permute(0, 3, 1, 2),
                                    kp_boxes.reshape(b * m_kp * t, 4))
        kps = kps.reshape(b, m_kp, t, n_kp, 4)
        if cfg.KRCNN.INFERENCE_MIN_SIZE > 0:
            cb = kp_boxes.reshape(b, m_kp, t, 4)[:, :, t // 2]
            side = torch.minimum(cb[..., 2] - cb[..., 0],
                                 cb[..., 3] - cb[..., 1])
            big = (side >= cfg.KRCNN.INFERENCE_MIN_SIZE).to(kps.dtype)
            kps = torch.cat([kps[..., :2],
                             kps[..., 2:] * big[:, :, None, None, None]],
                            dim=-1)
        if m_kp != d_max:
            kps = F.pad(kps, (0, 0, 0, 0, 0, 0, 0, d_max - m_kp))
        return kps

    def _keypoint_outputs(self, pyramid, det_boxes):
        b, d_max = det_boxes.shape[:2]
        kp_boxes, m_kp = self._kps_box_prep(det_boxes)
        heatmaps = self._keypoint_heatmaps(pyramid, kp_boxes)
        kps = self._decode_keypoints(heatmaps, kp_boxes, m_kp, d_max)
        return kps, heatmaps.reshape((b, m_kp) + heatmaps.shape[1:])

    def _detections(self, pyramid, cand) -> Dict[str, torch.Tensor]:
        det_boxes, det_scores, det_valid, det_feats = self._finalize_detections(
            cand["refined"], cand["scores"], cand["p_valid"], cand["fc7"])
        out = {
            "boxes": det_boxes,
            "scores": torch.where(det_valid, det_scores,
                                  torch.zeros_like(det_scores)),
            "valid": det_valid,
            "features": det_feats,
            "proposals": cand["tubes"],
        }
        if self.cfg.MODEL.KEYPOINTS_ON:
            out["keypoints"], out["heatmaps"] = self._keypoint_outputs(
                pyramid, det_boxes)
        return out

    # -- entry points -----------------------------------------------------

    def forward(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        """clips (B, T, H, W, 3) → detections dict (static shapes)."""
        image_hw = (float(clips.shape[2]), float(clips.shape[3]))
        pyramid = self.features(clips)
        cand = self._box_candidates(pyramid, image_hw)
        out = self._detections(pyramid, cand)
        out.update(proposal_scores=cand["p_scores"],
                   proposal_valid=cand["p_valid"],
                   cls_logits=cand["cls_logits"],
                   box_deltas=cand["box_deltas"], rpn_raw=cand["rpn_raw"])
        return out

    def detect_with_proposals(self, clips: torch.Tensor,
                              proposals: torch.Tensor, run_rpn: bool = False,
                              proposal_valid: Optional[torch.Tensor] = None
                              ) -> Dict[str, torch.Tensor]:
        """Inference on supplied proposal tubes (B, Kp, 4T).

        `run_rpn=False` skips the RPN (proposal-file inference);
        `run_rpn=True` runs the RPN and its NMS and replaces the selected
        tubes by `proposals` (the benchmark's controlled RoI mix).
        `proposal_valid` masks padded rows, on the run_rpn=False path only.
        """
        image_hw = (float(clips.shape[2]), float(clips.shape[3]))
        pyramid = self.features(clips)
        cand = self._box_candidates(pyramid, image_hw, proposals=proposals,
                                    run_rpn=run_rpn,
                                    proposal_valid=proposal_valid)
        return self._detections(pyramid, cand)


def _unsupported(cfg) -> List[str]:
    """Config options the port does not implement yet."""
    checks = [
        (cfg.MODEL.MASK_ON, "MODEL.MASK_ON"),
        (cfg.MODEL.RPN_ONLY, "MODEL.RPN_ONLY"),
        (cfg.TEST.SOFT_NMS_ENABLED, "TEST.SOFT_NMS_ENABLED"),
        (cfg.TEST.BBOX_VOTE_ENABLED, "TEST.BBOX_VOTE_ENABLED"),
        (cfg.TEST.BBOX_AUG_ENABLED, "TEST.BBOX_AUG_ENABLED (TTA)"),
        (cfg.TEST.KPS_AUG_ENABLED, "TEST.KPS_AUG_ENABLED"),
        (not cfg.FPN.FPN_ON, "FPN.FPN_ON=False (C4)"),
        (cfg.FAST_RCNN.ROI_BOX_HEAD != "2mlp_head",
         f"FAST_RCNN.ROI_BOX_HEAD={cfg.FAST_RCNN.ROI_BOX_HEAD}"),
        (cfg.FPN.EXTRA_CONV_LEVELS, "FPN.EXTRA_CONV_LEVELS"),
        (cfg.RESNETS.RES5_DILATION != 1, "RESNETS.RES5_DILATION"),
        (cfg.VIDEO.VIDEO_ON and not cfg.VIDEO.PREDICT_ALL_FRAMES,
         "VIDEO.PREDICT_ALL_FRAMES=False"),
    ]
    return [name for off, name in checks if off]


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's initializers (MSRA fan_out convs,
    gaussian RPN/predictors, Xavier fc6/fc7, unit affine, zero biases)."""
    for m in model.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(generator)


def build_model(cfg, device="cpu", seed: int = 0,
                train: bool = False) -> GeneralizedRCNN:
    """The port's GeneralizedRCNN for `cfg`, initialized from `seed` on the
    CPU and moved to `device` ("meta" builds it without storage), in eval
    mode or, with `train`, in train mode for `engine.train`."""
    if cfg.MODEL.TYPE != "generalized_rcnn":
        raise ValueError(f"Unknown MODEL.TYPE {cfg.MODEL.TYPE!r}")
    off = _unsupported(cfg)
    if off:
        raise NotImplementedError(
            "not ported to detectandtrack_tpu_torch yet: " + ", ".join(off))
    with torch.device("meta"):
        model = GeneralizedRCNN(cfg)
    if torch.device(device).type != "meta":
        model = model.to_empty(device="cpu")
        init_parameters(model, torch.Generator().manual_seed(seed))
        model = model.to(device)
    return model.train(train)
