"""The plain reference of the 3D Mask R-CNN of DetectAndTrack (Girdhar et
al., arXiv:1712.09184): an inflated ResNet, FPN, the tube RPN, RoIAlign-3D,
the 2-FC box head and the keypoint head, with their losses and targets
(`reference/train.py`).

Plain PyTorch over a flat dict of parameters named as the system names
them (`backbone.res2_0.a.conv.weight`, ...), so one seeded dict
(`benchmark/weights.py`) feeds both sides. Every convolution and matrix
product runs in float32 with TF32 off (`f32_mode`), or, for the control,
with its inputs and weights rounded to float8 e4m3 with one scale a tensor
(`precision="fp8"`) wherever the configuration computes in bfloat16.
Activations are (B, T, H, W, C) at module boundaries.

A frozen copy of the system's model as it stood when the benchmark was
written, cut to the FPN path with the 2-FC box head and keypoints. The
keypoint head emits 2·ROI_XFORM_RESOLUTION heatmaps (its deconvolution's
output), as the system's does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import ops

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
FP8_MAX = 448.0
RESIDUAL_SCALE = 0.2     # frozen-BN scale closing each residual branch


@contextlib.contextmanager
def f32_mode():
    """float32 convolutions and matrix products without TF32, restored on
    exit (the system under test keeps its own settings)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), back in float32; differentiable as the
    identity."""
    xf = x.float()
    scale = xf.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (xf.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return xf + (q - xf).detach()


# -- parameters -------------------------------------------------------------

def _msra(shape_thwio) -> float:
    return math.sqrt(2.0 / (math.prod(shape_thwio[:-2]) * shape_thwio[-1]))


def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, value) of every parameter: init "normal" with
    std `value`, or "const" filled with `value`. The system's recipe: MSRA
    fan-out convolutions, gaussian RPN (0.01) and predictors (0.01 class,
    0.001 box and keypoint), Xavier fc6/fc7 (as a gaussian), zero biases,
    unit frozen-BN affines but for the last of each residual branch, whose
    scale is RESIDUAL_SCALE: without it the variance doubles with every
    block and the class logits saturate, so that no box passes
    TEST.SCORE_THRESH."""
    m, v, res, fpn = cfg["MODEL"], cfg["VIDEO"], cfg["RESNETS"], cfg["FPN"]
    tks = v["TIME_KERNEL_DIM"]
    t = v["NUM_FRAMES"]
    out = []

    def conv(name, co, ci, kt, k, std=None, bias=False):
        shape = (co, ci, kt, k, k)
        out.append((name + ".weight", shape, "normal",
                    std if std is not None else _msra((kt, k, k, ci, co))))
        if bias:
            out.append((name + ".bias", (co,), "const", 0.0))

    def affine(name, c, scale=1.0):
        out.append((name + ".scale", (c,), "const", scale))
        out.append((name + ".bias", (c,), "const", 0.0))

    out.append(("backbone.conv1.conv.weight", (tks[0], 7, 7, 3, 64), "normal",
                _msra((tks[0], 7, 7, 3, 64))))
    affine("backbone.conv1.bn", 64)
    width = res["WIDTH_PER_GROUP"] * res["NUM_GROUPS"]
    cin = 64
    for stage, n in enumerate(STAGE_BLOCKS[m["CONV_BODY"]]):
        inner, outc = width * 2 ** stage, 256 * 2 ** stage
        for bi in range(n):
            pre = f"backbone.res{stage + 2}_{bi}"
            if bi == 0:
                conv(pre + ".proj.conv", outc, cin, 1, 1)
                affine(pre + ".proj.bn", outc)
            conv(pre + ".a.conv", inner, cin, 1, 1)
            affine(pre + ".a.bn", inner)
            conv(pre + ".b.conv", inner, inner, tks[stage + 1], 3)
            affine(pre + ".b.bn", inner)
            conv(pre + ".c.conv", outc, inner, 1, 1)
            affine(pre + ".c.bn", outc, RESIDUAL_SCALE)
            cin = outc
    dim = fpn["DIM"]
    for i, name in enumerate(("res2", "res3", "res4", "res5")):
        conv(f"fpn.lateral_{name}", dim, 256 * 2 ** i, 1, 1, bias=True)
    for lvl in ("p2", "p3", "p4", "p5"):
        conv(f"fpn.posthoc_{lvl}", dim, dim, 1, 3, bias=True)
    a = len(cfg["RPN"]["ASPECT_RATIOS"])
    conv("rpn_head.conv", dim, dim, 1, 3, std=0.01, bias=True)
    conv("rpn_head.logits", a, dim, 1, 1, std=0.01, bias=True)
    conv("rpn_head.deltas", a * 4 * t, dim, 1, 1, std=0.01, bias=True)
    p = cfg["FAST_RCNN"]["ROI_XFORM_RESOLUTION"]
    hid = cfg["FAST_RCNN"]["MLP_HEAD_DIM"]
    ncls = m["NUM_CLASSES"]
    for name, fin, fout, std in (
            ("fc6", t * p * p * dim, hid, None), ("fc7", hid, hid, None),
            ("cls_score", hid, ncls, 0.01),
            ("bbox_pred", hid, ncls * 4 * t, 0.001)):
        std = std if std is not None else math.sqrt(2.0 / (fin + fout))
        out.append((f"box_head.{name}.weight", (fout, fin), "normal", std))
        out.append((f"box_head.{name}.bias", (fout,), "const", 0.0))
    kr = cfg["KRCNN"]
    cin = dim
    for i in range(kr["NUM_STACKED_CONVS"]):
        conv(f"kps_head.conv_fcn{i + 1}", kr["CONV_HEAD_DIM"], cin, 1,
             kr["CONV_HEAD_KERNEL"], bias=True)
        cin = kr["CONV_HEAD_DIM"]
    out.append(("kps_head.kps_score_lowres.weight",
                (cin, kr["NUM_KEYPOINTS"], 4, 4), "normal", 0.001))
    out.append(("kps_head.kps_score_lowres.bias", (kr["NUM_KEYPOINTS"],),
                "const", 0.0))
    return out


# -- the model --------------------------------------------------------------

class Detector:
    """Functional forward of the detector over `params` (name → tensor)."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.cfg = cfg
        self.p = params
        self.low = fp8_round if precision == "fp8" else (lambda x: x.float())
        self.t = cfg["VIDEO"]["NUM_FRAMES"]

    # -- layers --

    def conv(self, x, name, stride=(1, 1, 1), bias=False, low=True):
        w = self.p[name + ".weight"]
        kt, kh, kw = w.shape[2:]
        if low:
            x, w = self.low(x), self.low(w)
        pads = [((k - 1) // 2, k // 2) for k in (kt, kh, kw)]
        b, tt = x.shape[:2]
        per_frame = kt == 1 and stride[0] == 1
        if per_frame:
            xc = x.reshape((b * tt,) + x.shape[2:]).permute(0, 3, 1, 2)
            w, fn, pads, stride = w[:, :, 0], F.conv2d, pads[1:], stride[1:]
        else:
            xc, fn = x.permute(0, 4, 1, 2, 3), F.conv3d
        extra = [v for lo, hi in reversed(pads) for v in (0, hi - lo)]
        if any(extra):
            xc = F.pad(xc, extra)
        y = fn(xc, w, None, stride, [lo for lo, _ in pads]).movedim(1, -1)
        if per_frame:
            y = y.reshape((b, tt) + y.shape[1:])
        if bias:
            y = y + self.p[name + ".bias"]
        return y

    def affine(self, x, name):
        return x * self.p[name + ".scale"] + self.p[name + ".bias"]

    def conv_affine(self, x, name, stride=(1, 1, 1)):
        return self.affine(self.conv(x, name + ".conv", stride), name + ".bn")

    def linear(self, x, name, low=True):
        w = self.p[name + ".weight"]
        if low:
            x, w = self.low(x), self.low(w)
        return F.linear(x.float(), w.float(), self.p[name + ".bias"])

    # -- backbone and FPN --

    def features(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        """clips (B, T, H, W, 3) → {p2..p6}."""
        cfg = self.cfg
        k7 = self.p["backbone.conv1.conv.weight"]
        t = k7.shape[0]
        xc = F.pad(self.low(clips).permute(0, 4, 1, 2, 3),
                   (3, 3, 3, 3, (t - 1) // 2, t // 2))
        y = F.conv3d(xc, self.low(k7).permute(4, 3, 0, 1, 2),
                     stride=(1, 2, 2)).permute(0, 2, 3, 4, 1)
        y = F.relu(self.affine(y, "backbone.conv1.bn"))
        b, tt, h, w, c = y.shape
        y = F.max_pool2d(y.reshape(b * tt, h, w, c).permute(0, 3, 1, 2),
                         3, 2, 1).permute(0, 2, 3, 1)
        y = y.reshape(b, tt, y.shape[1], y.shape[2], c)
        feats = {}
        for stage, n in enumerate(STAGE_BLOCKS[cfg["MODEL"]["CONV_BODY"]]):
            s = 1 if stage == 0 else 2
            for bi in range(n):
                pre = f"backbone.res{stage + 2}_{bi}"
                st = (1, s, s) if bi == 0 else (1, 1, 1)
                short = (self.conv_affine(y, pre + ".proj", st) if bi == 0
                         else y)
                z = F.relu(self.conv_affine(y, pre + ".a", st))
                z = F.relu(self.conv_affine(z, pre + ".b"))
                y = F.relu(self.conv_affine(z, pre + ".c") + short)
            feats[f"res{stage + 2}"] = y
        lat = [self.conv(feats[n], f"fpn.lateral_{n}", bias=True)
               for n in ("res2", "res3", "res4", "res5")]
        td = lat[-1]
        outs = {"p5": td}
        for i in (2, 1, 0):
            b, tt, h, w, c = td.shape
            up = td[:, :, :, None, :, None, :].expand(b, tt, h, 2, w, 2, c)
            td = lat[i] + up.reshape(b, tt, 2 * h, 2 * w, c)
            outs[f"p{i + 2}"] = td
        for lvl in ("p2", "p3", "p4", "p5"):
            outs[lvl] = self.conv(outs[lvl], f"fpn.posthoc_{lvl}", bias=True)
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs

    # -- RPN --

    def anchor_fields(self, pyramid) -> List[torch.Tensor]:
        cfg = self.cfg
        rpn, fpn = cfg["RPN"], cfg["FPN"]
        out = []
        for li, lvl in enumerate(range(fpn["RPN_MIN_LEVEL"],
                                       fpn["RPN_MAX_LEVEL"] + 1)):
            fmap = pyramid[f"p{lvl}"]
            cell = ops.generate_anchors(2 ** lvl, [rpn["SIZES"][li]],
                                        rpn["ASPECT_RATIOS"])
            out.append(torch.as_tensor(ops.shifted_anchor_field(
                cell, 2 ** lvl, fmap.shape[2], fmap.shape[3]),
                device=fmap.device))
        return out

    def rpn(self, pyramid):
        """Per-level (logits (B, H·W·A), deltas (B, H·W·A, 4T))."""
        fpn = self.cfg["FPN"]
        out = []
        for lvl in range(fpn["RPN_MIN_LEVEL"], fpn["RPN_MAX_LEVEL"] + 1):
            x = pyramid[f"p{lvl}"].mean(dim=1, keepdim=True)
            h = F.relu(self.conv(x, "rpn_head.conv", bias=True))
            lg = self.conv(h, "rpn_head.logits", bias=True)[:, 0]
            dl = self.conv(h, "rpn_head.deltas", bias=True)[:, 0]
            b = lg.shape[0]
            out.append((lg.reshape(b, -1),
                        dl.reshape(b, -1, 4 * self.t)))
        return out

    def propose(self, pyramid, raw, image_hw, train: bool):
        """The RPN's top tubes per level, NMS'd per (level, image) lane,
        then the global top POST_NMS_TOP_N → (tubes, valid), no gradient."""
        rpn, t = self.cfg["RPN"], self.t
        pre = rpn["PRE_NMS_TOP_N_TRAIN" if train else "PRE_NMS_TOP_N_TEST"]
        post = rpn["POST_NMS_TOP_N_TRAIN" if train else "POST_NMS_TOP_N_TEST"]
        lvl_tubes, lvl_scores = [], []
        for field, (scores, deltas) in zip(self.anchor_fields(pyramid), raw):
            scores, deltas = scores.detach(), deltas.detach()
            k = min(pre, scores.shape[1])
            ts, ti = ops.topk_stable(scores, k)
            rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
            tubes = ops.clip_boxes(ops.bbox_transform(
                field[ti].repeat(1, 1, t), deltas[rows, ti]),
                image_hw[0], image_hw[1])
            if k < pre:
                tubes = F.pad(tubes, (0, 0, 0, pre - k))
                ts = F.pad(ts, (0, pre - k), value=float("-inf"))
            lvl_tubes.append(tubes)
            lvl_scores.append(ts)
        n_lvl, b = len(lvl_tubes), lvl_tubes[0].shape[0]
        flat_t = torch.stack(lvl_tubes).reshape(n_lvl * b, pre, 4 * t)
        flat_s = torch.stack(lvl_scores).reshape(n_lvl * b, pre)
        c = (t // 2) * 4
        rep = flat_t[..., c:c + 4]
        valid = torch.isfinite(flat_s)
        if rpn["MIN_SIZE"] > 0:
            valid = valid & ops.filter_small_boxes(rep, rpn["MIN_SIZE"])
        idx, mask = ops.nms_fixed(rep, flat_s, rpn["NMS_THRESH"], post, valid)
        rows = torch.arange(n_lvl * b, device=idx.device)[:, None]
        sel_t = flat_t[rows, idx].reshape(n_lvl, b, post, 4 * t)
        sel_s = torch.gather(flat_s, 1, idx).reshape(n_lvl, b, post)
        sel_v = mask.reshape(n_lvl, b, post)
        tubes = torch.cat(list(sel_t), 1)
        scores = torch.cat(list(sel_s), 1)
        valid = torch.cat(list(sel_v), 1)
        masked = torch.where(valid, scores, torch.full_like(scores, -math.inf))
        top, ix = ops.topk_stable(masked, min(post, masked.shape[1]))
        tubes = torch.gather(tubes, 1,
                             ix[..., None].expand(-1, -1, tubes.shape[-1]))
        return tubes, torch.gather(valid, 1, ix) & torch.isfinite(top)

    # -- RoI heads --

    def roi_transform(self, pyramid, tubes, resolution, sampling):
        """tubes (B, K, 4T) → pooled (B·K, T, P, P, C); the level comes
        from the centre frame, frame f pools from slab b·T + f."""
        fpn, t = self.cfg["FPN"], self.t
        b, k = tubes.shape[:2]
        lvls = range(fpn["ROI_MIN_LEVEL"], fpn["ROI_MAX_LEVEL"] + 1)
        maps = [pyramid[f"p{l}"] for l in lvls]
        per_frame = tubes.float().reshape(b, k, t, 4)
        rois = per_frame.permute(0, 2, 1, 3).reshape(b * t * k, 4)
        levels = ops.assign_fpn_levels(
            per_frame[:, :, t // 2], fpn["ROI_MIN_LEVEL"],
            fpn["ROI_MAX_LEVEL"], fpn["ROI_CANONICAL_SCALE"],
            fpn["ROI_CANONICAL_LEVEL"])                       # (B, K)
        levels = levels[:, None, :].expand(b, t, k).reshape(-1)
        slabs = torch.arange(b * t, device=tubes.device).repeat_interleave(k)
        flat = [m.reshape((-1,) + m.shape[2:]) for m in maps]
        pooled = ops.roi_align(flat, [2 ** l for l in lvls], rois, slabs,
                               levels, resolution, sampling)
        c = pooled.shape[-1]
        pooled = pooled.reshape(b, t, k, resolution, resolution, c)
        return pooled.permute(0, 2, 1, 3, 4, 5).reshape(
            b * k, t, resolution, resolution, c)

    def box_head(self, pooled):
        """pooled (R, T, P, P, C) → (cls logits (R, C), deltas (R, 4·C·T),
        fc7 (R, F), the tracker's appearance feature)."""
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(self.linear(x, "box_head.fc6"))
        x = F.relu(self.linear(x, "box_head.fc7"))
        return (self.linear(x, "box_head.cls_score", low=False),
                self.linear(x, "box_head.bbox_pred", low=False), x)

    def kps_head(self, pooled):
        """pooled (R, T, P, P, C) → heatmap logits (R, T, S, S, K)."""
        r, t, p, _, c = pooled.shape
        x = pooled.reshape(r * t, 1, p, p, c)
        for i in range(self.cfg["KRCNN"]["NUM_STACKED_CONVS"]):
            x = F.relu(self.conv(x, f"kps_head.conv_fcn{i + 1}", bias=True))
        x = x[:, 0].float().permute(0, 3, 1, 2)
        y = F.conv_transpose2d(x, self.p["kps_head.kps_score_lowres.weight"],
                               self.p["kps_head.kps_score_lowres.bias"],
                               stride=2, padding=1).permute(0, 2, 3, 1)
        s = y.shape[1]
        return y.reshape(r, t, s, s, y.shape[-1])

    # -- inference --

    def candidates(self, pyramid, tubes, image_hw):
        """Given tubes (B, K, 4T) → refined tubes (B, K, 4T), person
        scores (B, K) and fc7 features (B, K, F)."""
        cfg, t = self.cfg, self.t
        b, k = tubes.shape[:2]
        fr = cfg["FAST_RCNN"]
        pooled = self.roi_transform(pyramid, tubes, fr["ROI_XFORM_RESOLUTION"],
                                    fr["ROI_XFORM_SAMPLING_RATIO"])
        cls, deltas, fc7 = self.box_head(pooled)
        probs = torch.softmax(cls, dim=-1)
        person = deltas.reshape(b * k, cfg["MODEL"]["NUM_CLASSES"], t, 4)[:, 1]
        refined = ops.bbox_transform(tubes.reshape(-1, 4).float(),
                                     person.reshape(-1, 4),
                                     fr["BBOX_REG_WEIGHTS"])
        refined = ops.clip_boxes(refined, image_hw[0], image_hw[1])
        return (refined.reshape(b, k, 4 * t), probs[:, 1].reshape(b, k),
                fc7.reshape(b, k, -1))

    def heatmaps(self, pyramid, boxes):
        """Keypoint heatmaps (B, M, T, S, S, K) of boxes (B, M, 4T)."""
        kr = self.cfg["KRCNN"]
        pooled = self.roi_transform(pyramid, boxes, kr["ROI_XFORM_RESOLUTION"],
                                    kr["ROI_XFORM_SAMPLING_RATIO"])
        hm = self.kps_head(pooled)
        return hm.reshape(boxes.shape[:2] + hm.shape[1:])

    def detect(self, clips, tubes):
        """The whole detect path on given tubes → outputs in the system's
        format: boxes (B, D, 4T), scores, valid, features (B, D, F),
        keypoints (B, D, T, K, 4)."""
        cfg, t = self.cfg, self.t
        image_hw = (float(clips.shape[2]), float(clips.shape[3]))
        pyramid = self.features(clips)
        refined, scores, fc7 = self.candidates(pyramid, tubes, image_hw)
        te = cfg["TEST"]
        b, k = scores.shape
        centre = refined.reshape(b, k, t, 4)[:, :, t // 2]
        ok = scores >= te["SCORE_THRESH"]
        idx, mask = ops.nms_fixed(centre, scores, te["NMS"],
                                  te["DETECTIONS_PER_IM"], ok)
        rows = torch.arange(b, device=idx.device)[:, None]
        boxes = refined[rows, idx]
        det_scores = torch.where(mask, scores[rows, idx], 0.0)
        m = min(cfg["KRCNN"]["MAX_ROIS_PER_IM"] or idx.shape[1], idx.shape[1])
        hm = self.heatmaps(pyramid, boxes[:, :m])          # (B, M, T, S, S, K)
        s, n_kp = hm.shape[3], hm.shape[-1]
        kps = ops.heatmaps_to_keypoints(
            hm.reshape(-1, s, s, n_kp).permute(0, 3, 1, 2),
            boxes[:, :m].reshape(-1, 4)).reshape(b, m, t, n_kp, 4)
        kps = F.pad(kps, (0, 0, 0, 0, 0, 0, 0, idx.shape[1] - m))
        return {"boxes": boxes, "scores": det_scores, "valid": mask,
                "features": fc7[rows, idx], "keypoints": kps}
