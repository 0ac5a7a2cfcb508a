"""GeneralizedRCNN — the (3D) Mask R-CNN as a torch module.

Port of detectandtrack_tpu/models/detector.py: backbone → FPN (or the
stride-16 res4 map in C4) → tube-RPN → proposal decode + fixed-budget NMS →
RoIAlign-3D → box head (2-FC, or res5 in C4) → final NMS or soft-NMS, box
voting → RoIAlign-3D on the top detections → keypoint head (every frame or
the center frame) → heatmap decode, and the mask head. `detect_tta` runs
the mirrored clip too and merges both; RPN_ONLY returns the proposals.
Shapes are static and padded with validity masks, as in the JAX model:

  boxes (B, D, 4T) · scores (B, D) · valid (B, D) · features (B, D, F)
  · keypoints (B, D, T, K, 4) · masks (B, D, T, 2P, 2P, C)

The same model trains: `engine/train.py` runs `features`,
`propose(train=True)`, `roi_transform` and the heads, and gradients flow
through the RoIAlign and conv1 kernels' autograd Functions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.roi_align import (assign_fpn_levels,
                                 roi_align_multilevel_autograd)
from ..ops import boxes as box_ops
from ..ops.anchors import shifted_anchor_field
from ..ops.keypoints import flip_permutation, heatmaps_to_keypoints
from ..ops.nms import nms_fixed, soft_nms_fixed
from .backbone import BASIC_ARCHS, backbone_from_cfg, compute_dtype
from .fpn import FPN
from .heads import BoxHead2MLP, KeypointHead, MaskHead, Res5BoxHead
from .rpn import (RPNHead, anchor_cell_for_level, center_frame_box,
                  collect_fpn_proposals, decode_tube_proposals,
                  flatten_rpn_outputs, topk_stable)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along dim 1 by idx (B, M) → (B, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _flip_tubes(boxes: torch.Tensor, image_w: float, t: int) -> torch.Tensor:
    """Mirror (B, K, 4T) per-frame boxes horizontally (x → W − 1 − x, the
    Detectron +1 convention)."""
    b, k = boxes.shape[:2]
    pf = boxes.reshape(b, k, t, 4)
    out = torch.stack([image_w - 1.0 - pf[..., 2], pf[..., 1],
                       image_w - 1.0 - pf[..., 0], pf[..., 3]], dim=-1)
    return out.reshape(b, k, 4 * t)


class GeneralizedRCNN(nn.Module):
    """cfg-driven detection model; forward returns raw head outputs plus the
    decoded, NMS'd detections."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
        self.num_frames = t
        fpn_on = cfg.FPN.FPN_ON
        expansion = 1 if cfg.MODEL.CONV_BODY in BASIC_ARCHS else 4
        stage_dims = {f"res{i + 2}": 64 * expansion * 2 ** i
                      for i in range(4)}
        # C4 keeps res5's parameters (the JAX backbone builds them) but
        # `features` stops at res4.
        self.backbone = backbone_from_cfg(cfg)
        if fpn_on:
            self.fpn = FPN(stage_dims, dim=cfg.FPN.DIM,
                           zero_init_lateral=cfg.FPN.ZERO_INIT_LATERAL,
                           extra_conv_levels=cfg.FPN.EXTRA_CONV_LEVELS,
                           dtype=dtype)
        # Width of the pooled map every RoI head reads.
        roi_dim = cfg.FPN.DIM if fpn_on else stage_dims["res4"]
        self.roi_dim = roi_dim
        n_anchors = len(cfg.RPN.ASPECT_RATIOS) * (
            1 if fpn_on else len(cfg.RPN.SIZES))
        self.rpn_head = RPNHead(roi_dim, cfg.FPN.DIM if fpn_on else 1024,
                                n_anchors, t, dtype)
        if cfg.MODEL.RPN_ONLY:
            return          # no RoI heads: the JAX model never creates them
        if fpn_on and cfg.FAST_RCNN.ROI_BOX_HEAD == "2mlp_head":
            p_box = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
            self.box_head = BoxHead2MLP(t * p_box * p_box * roi_dim,
                                        cfg.MODEL.NUM_CLASSES, t,
                                        cfg.FAST_RCNN.MLP_HEAD_DIM, dtype)
        else:
            res = cfg.RESNETS
            self.box_head = Res5BoxHead(
                roi_dim, cfg.MODEL.NUM_CLASSES, t,
                cfg.VIDEO.TIME_KERNEL_DIM[4] if cfg.VIDEO.VIDEO_ON else 1,
                res.WIDTH_PER_GROUP * res.NUM_GROUPS * 8, res.STRIDE_1X1,
                dtype, res.NUM_GROUPS, res.RES5_DILATION)
        if cfg.MODEL.KEYPOINTS_ON:
            self.kps_head = KeypointHead(
                roi_dim, cfg.KRCNN.NUM_KEYPOINTS,
                cfg.KRCNN.NUM_STACKED_CONVS, cfg.KRCNN.CONV_HEAD_DIM,
                cfg.KRCNN.CONV_HEAD_KERNEL, dtype)
        if cfg.MODEL.MASK_ON:
            self.mask_head = MaskHead(roi_dim, cfg.MODEL.NUM_CLASSES,
                                      cfg.MRCNN.DIM_REDUCED, dtype)

    # -- features ---------------------------------------------------------

    def features(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        """clips (B, T, H, W, 3) → pyramid {p2..p6}, (B, T, H_l, W_l, C), or
        {res4} in C4, where the RPN and RoI pooling read the stride-16 res4
        map and res5 is the box head."""
        if self.cfg.FPN.FPN_ON:
            return self.fpn(self.backbone(clips))
        return {"res4": self.backbone(clips, last_stage=4)["res4"]}

    def _levels(self, pyramid, lo: int, hi: int
                ) -> Tuple[List[torch.Tensor], List[int]]:
        """(maps, strides) of FPN levels lo..hi, or C4's one res4 level."""
        if self.cfg.FPN.FPN_ON:
            lvls = range(lo, hi + 1)
            return [pyramid[f"p{l}"] for l in lvls], [2 ** l for l in lvls]
        return [pyramid["res4"]], [self.cfg.RPN.STRIDE]

    def _pyramid_list(self, pyramid):
        """(maps, strides) the RPN runs on."""
        return self._levels(pyramid, self.cfg.FPN.RPN_MIN_LEVEL,
                            self.cfg.FPN.RPN_MAX_LEVEL)

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
        pre = (cfg.RPN.PRE_NMS_TOP_N_TRAIN if train
               else cfg.RPN.PRE_NMS_TOP_N_TEST)
        post = (cfg.RPN.POST_NMS_TOP_N_TRAIN if train
                else cfg.RPN.POST_NMS_TOP_N_TEST)
        raw = []
        lvl_tubes, lvl_scores = [], []
        for li, (fmap, stride) in enumerate(zip(*self._pyramid_list(pyramid))):
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
        """tubes (B, K, 4T) → pooled (B·K, T, P, P, C). The FPN level comes
        from the center-frame box (C4: the one res4 level); frame f of a
        tube pools from slab b·T + f."""
        cfg = self.cfg
        t = self.num_frames
        b, k = tubes.shape[:2]
        maps, strides = self._levels(pyramid, cfg.FPN.ROI_MIN_LEVEL,
                                     cfg.FPN.ROI_MAX_LEVEL)
        per_frame = tubes.float().reshape(b, k, t, 4)
        slab_rois = per_frame.permute(0, 2, 1, 3).reshape(b * t, k, 4)
        if cfg.FPN.FPN_ON:
            center = per_frame[:, :, t // 2, :].reshape(b * k, 4)
            levels = assign_fpn_levels(
                center, cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL)
        else:
            levels = torch.zeros((b * k,), dtype=torch.int32,
                                 device=tubes.device)
        slab_levels = levels.reshape(b, 1, k).expand(b, t, k).reshape(b * t,
                                                                      k)
        flat_maps = [m.reshape((-1,) + m.shape[2:]).contiguous()
                     for m in maps]
        pooled = roi_align_multilevel_autograd(
            flat_maps, strides, slab_rois.contiguous(),
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
        """Candidates (B, K, ...) → final detections (B, D, ...): hard NMS
        or soft-NMS on the center-frame boxes, then box voting.

        Soft-NMS's detections carry its decayed scores. Box voting replaces
        each kept tube by the score-weighted mean of every valid refined
        candidate whose center-frame IoU with it is ≥ BBOX_VOTE_THRESH (the
        NMS tube where no weight remains)."""
        cfg = self.cfg
        t = self.num_frames
        b, k = scores.shape
        d_max = cfg.TEST.DETECTIONS_PER_IM
        center = refined.reshape(b, k, t, 4)[:, :, t // 2]
        ok = valid & (scores >= cfg.TEST.SCORE_THRESH)
        if cfg.TEST.SOFT_NMS_ENABLED:
            idx, mask, det_scores = soft_nms_fixed(
                center, scores, d_max, cfg.TEST.SOFT_NMS_SIGMA, cfg.TEST.NMS,
                cfg.TEST.SCORE_THRESH, cfg.TEST.SOFT_NMS_METHOD, ok)
        else:
            idx, mask = nms_fixed(center, scores, cfg.TEST.NMS, d_max, ok)
            det_scores = torch.gather(scores, 1, idx)
        det_boxes = _gather_rows(refined, idx)
        if cfg.TEST.BBOX_VOTE_ENABLED:
            det_centers = det_boxes.reshape(b, -1, t, 4)[:, :, t // 2]
            iou = box_ops.bbox_overlaps(det_centers, center)   # (B, D, K)
            weight = torch.where(valid, scores, torch.zeros_like(scores))
            w_vote = torch.where(
                (iou >= cfg.TEST.BBOX_VOTE_THRESH) & valid[:, None, :],
                weight[:, None, :], torch.zeros_like(iou))
            denom = w_vote.sum(-1, keepdim=True)
            voted = torch.einsum("bdk,bkc->bdc", w_vote, refined)
            det_boxes = torch.where(denom > 0, voted / denom.clamp(min=1e-12),
                                    det_boxes)
        return det_boxes, det_scores, mask, _gather_rows(fc7, idx)

    def _kps_box_prep(self, det_boxes):
        """Score-ranked keypoint budget (KRCNN.MAX_ROIS_PER_IM) and the
        center-frame ablation (VIDEO.PREDICT_ALL_FRAMES=False) →
        (kp_boxes (B, M, 4T), decode_boxes (B, M, 4·t_kp), m_kp, t_kp)."""
        cfg = self.cfg
        t = self.num_frames
        b, d_max = det_boxes.shape[:2]
        m_kp = min(cfg.KRCNN.MAX_ROIS_PER_IM or d_max, d_max)
        kp_boxes = det_boxes[:, :m_kp]
        if cfg.VIDEO.VIDEO_ON and not cfg.VIDEO.PREDICT_ALL_FRAMES:
            center = kp_boxes.reshape(b, m_kp, t, 4)[:, :, t // 2]
            return kp_boxes, center, m_kp, 1
        return kp_boxes, kp_boxes, m_kp, t

    def _keypoint_heatmaps(self, passes: Sequence, kp_boxes: torch.Tensor,
                           t_kp: int, image_w: float) -> torch.Tensor:
        """Pass-averaged heatmaps (B·M, Tk, S, S, K) for the given boxes.

        `passes` holds (pyramid, flipped) pairs. A flipped pass pools the
        mirrored boxes from the mirrored clip's pyramid; its heatmaps are
        mirrored back on W and their joints swapped left/right before the
        average. With t_kp = 1 the head runs on each tube's center frame.
        """
        cfg = self.cfg
        t = self.num_frames
        hm_sum = None
        for pyramid, flipped in passes:
            boxes = _flip_tubes(kp_boxes, image_w, t) if flipped else kp_boxes
            pooled = self.roi_transform(pyramid, boxes,
                                        cfg.KRCNN.ROI_XFORM_RESOLUTION,
                                        cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO)
            if t_kp != t:
                pooled = pooled[:, t // 2:t // 2 + 1]
            hm = self.kps_head(pooled)
            if flipped:
                perm = torch.as_tensor(
                    flip_permutation("posetrack" if cfg.KRCNN.NUM_KEYPOINTS
                                     == 15 else "coco"),
                    device=hm.device)
                hm = hm.flip(3)[..., perm]
            hm_sum = hm if hm_sum is None else hm_sum + hm
        return hm_sum / float(len(passes))

    def _decode_keypoints(self, heatmaps, kp_boxes, decode_boxes, m_kp,
                          t_kp, d_max):
        """Heatmaps (B·M, Tk, S, S, K) + boxes → padded (B, D, T, K, 4); a
        center-frame pose is broadcast to every frame."""
        cfg = self.cfg
        t = self.num_frames
        b = kp_boxes.shape[0]
        s_hm = heatmaps.shape[2]
        n_kp = cfg.KRCNN.NUM_KEYPOINTS
        hm_flat = heatmaps.reshape(b * m_kp * t_kp, s_hm, s_hm, n_kp)
        kps = heatmaps_to_keypoints(hm_flat.permute(0, 3, 1, 2),
                                    decode_boxes.reshape(b * m_kp * t_kp, 4))
        kps = kps.reshape(b, m_kp, t_kp, n_kp, 4)
        if cfg.KRCNN.INFERENCE_MIN_SIZE > 0:
            cb = kp_boxes.reshape(b, m_kp, t, 4)[:, :, t // 2]
            side = torch.minimum(cb[..., 2] - cb[..., 0],
                                 cb[..., 3] - cb[..., 1])
            big = (side >= cfg.KRCNN.INFERENCE_MIN_SIZE).to(kps.dtype)
            kps = torch.cat([kps[..., :2],
                             kps[..., 2:] * big[:, :, None, None, None]],
                            dim=-1)
        if t_kp != t:
            kps = kps.expand(b, m_kp, t, n_kp, 4)
        if m_kp != d_max:
            kps = F.pad(kps, (0, 0, 0, 0, 0, 0, 0, d_max - m_kp))
        return kps

    def _keypoint_outputs(self, passes, det_boxes, image_w: float):
        """Keypoint heatmaps (B, M, Tk, S, S, K) and their decode on the
        final detections."""
        b, d_max = det_boxes.shape[:2]
        kp_boxes, decode_boxes, m_kp, t_kp = self._kps_box_prep(det_boxes)
        heatmaps = self._keypoint_heatmaps(passes, kp_boxes, t_kp, image_w)
        kps = self._decode_keypoints(heatmaps, kp_boxes, decode_boxes, m_kp,
                                     t_kp, d_max)
        return kps, heatmaps.reshape((b, m_kp) + heatmaps.shape[1:])

    def _mask_outputs(self, pyramid, det_boxes) -> torch.Tensor:
        """Mask logits (B, D, T, 2P, 2P, C) of the final detections."""
        cfg = self.cfg
        b, d_max = det_boxes.shape[:2]
        pooled = self.roi_transform(pyramid, det_boxes,
                                    cfg.MRCNN.ROI_XFORM_RESOLUTION,
                                    cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO)
        m = self.mask_head(pooled)
        return m.reshape((b, d_max) + m.shape[1:])

    def _detections(self, pyramids, image_w: float, refined, scores, valid,
                    fc7) -> Dict[str, torch.Tensor]:
        """Final detections and, on them, keypoints (averaged over the
        (pyramid, flipped) passes) and masks (first pass)."""
        det_boxes, det_scores, det_valid, det_feats = (
            self._finalize_detections(refined, scores, valid, fc7))
        out = {
            "boxes": det_boxes,
            "scores": torch.where(det_valid, det_scores,
                                  torch.zeros_like(det_scores)),
            "valid": det_valid,
            "features": det_feats,
        }
        if self.cfg.MODEL.KEYPOINTS_ON:
            out["keypoints"], out["heatmaps"] = self._keypoint_outputs(
                pyramids, det_boxes, image_w)
        if self.cfg.MODEL.MASK_ON:
            out["masks"] = self._mask_outputs(pyramids[0][0], det_boxes)
        return out

    def _cand_detections(self, pyramid, image_w: float, cand):
        out = self._detections([(pyramid, False)], image_w, cand["refined"],
                               cand["scores"], cand["p_valid"], cand["fc7"])
        out["proposals"] = cand["tubes"]
        return out

    # -- entry points -----------------------------------------------------

    def forward(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        """clips (B, T, H, W, 3) → detections dict (static shapes). With
        MODEL.RPN_ONLY the detections are the top proposals, scored by the
        sigmoid of their objectness, with zero features."""
        image_hw = (float(clips.shape[2]), float(clips.shape[3]))
        pyramid = self.features(clips)
        if self.cfg.MODEL.RPN_ONLY:
            (tubes, p_scores, p_valid), rpn_raw = self.propose(pyramid,
                                                               image_hw)
            b, k = p_scores.shape
            d = min(self.cfg.TEST.DETECTIONS_PER_IM, k)
            top = torch.sigmoid(p_scores[:, :d])
            return {"boxes": tubes[:, :d],
                    "scores": torch.where(p_valid[:, :d], top,
                                          torch.zeros_like(top)),
                    "valid": p_valid[:, :d],
                    "features": torch.zeros((b, d, 1), device=clips.device),
                    "proposals": tubes, "proposal_scores": p_scores,
                    "proposal_valid": p_valid, "rpn_raw": rpn_raw}
        cand = self._box_candidates(pyramid, image_hw)
        out = self._cand_detections(pyramid, image_hw[1], cand)
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
        return self._cand_detections(pyramid, image_hw[1], cand)

    def detect_tta(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flip test-time augmentation in one pass: the box candidates of
        the clip and of its mirror (mapped back) are merged before the
        final NMS; keypoint heatmaps of both are averaged before one
        decode; masks come from the original clip."""
        t = self.num_frames
        image_hw = (float(clips.shape[2]), float(clips.shape[3]))
        w_img = image_hw[1]
        pyr_o = self.features(clips)
        pyr_f = self.features(clips.flip(3))
        cand_o = self._box_candidates(pyr_o, image_hw)
        cand_f = self._box_candidates(pyr_f, image_hw)
        refined = torch.cat([cand_o["refined"],
                             _flip_tubes(cand_f["refined"], w_img, t)], dim=1)
        return self._detections(
            [(pyr_o, False), (pyr_f, True)], w_img, refined,
            torch.cat([cand_o["scores"], cand_f["scores"]], dim=1),
            torch.cat([cand_o["p_valid"], cand_f["p_valid"]], dim=1),
            torch.cat([cand_o["fc7"], cand_f["fc7"]], dim=1))

    def keypoint_heatmaps_for_boxes(self, clips: torch.Tensor,
                                    det_boxes: torch.Tensor,
                                    flip: bool = False) -> torch.Tensor:
        """KPS_AUG second phase, one scale: heatmaps (B, M, Tk, S, S, K) at
        the given detections (in this clip's coordinates), averaged with
        the mirrored pass when `flip`. The caller averages the scales and
        decodes once with `decode_keypoints_from_heatmaps`."""
        passes = [(self.features(clips), False)]
        if flip:
            passes.append((self.features(clips.flip(3)), True))
        b = det_boxes.shape[0]
        kp_boxes, _, m_kp, t_kp = self._kps_box_prep(det_boxes)
        hm = self._keypoint_heatmaps(passes, kp_boxes, t_kp,
                                     float(clips.shape[3]))
        return hm.reshape((b, m_kp) + hm.shape[1:])

    def decode_keypoints_from_heatmaps(self, heatmaps: torch.Tensor,
                                       det_boxes: torch.Tensor
                                       ) -> torch.Tensor:
        """Decode averaged heatmaps (B, M, Tk, S, S, K) at det_boxes
        (original image coordinates) → (B, D, T, K, 4)."""
        d_max = det_boxes.shape[1]
        kp_boxes, decode_boxes, m_kp, t_kp = self._kps_box_prep(det_boxes)
        return self._decode_keypoints(
            heatmaps.reshape((-1,) + heatmaps.shape[2:]), kp_boxes,
            decode_boxes, m_kp, t_kp, d_max)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's initializers (MSRA fan_out convs,
    gaussian RPN/predictors, Xavier fc6/fc7, unit affine, zero biases)."""
    for m in model.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(generator)


def build_model(cfg, device="cuda", seed: int = 0,
                train: bool = False) -> GeneralizedRCNN:
    """The port's GeneralizedRCNN for `cfg` (from the port's
    `core.config.load_cfg`), initialized from `seed` on the CPU and moved to
    `device`: the CUDA card unless the caller passes "cpu" ("meta" builds
    it without storage); in eval mode or, with `train`, in train mode for
    `engine.train`."""
    if cfg.MODEL.TYPE != "generalized_rcnn":
        raise ValueError(f"Unknown MODEL.TYPE {cfg.MODEL.TYPE!r}")
    with torch.device("meta"):
        model = GeneralizedRCNN(cfg)
    if torch.device(device).type != "meta":
        model = model.to_empty(device="cpu")
        init_parameters(model, torch.Generator().manual_seed(seed))
        model = model.to(device)
    return model.train(train)
