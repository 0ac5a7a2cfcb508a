"""The plain reference of the ResNeXt FPN keypoint R-CNN (Xie et al.,
Aggregated Residual Transformations, arXiv:1611.05431, as the body of
Detectron's e2e_keypoint_rcnn_X-101-64x4d-FPN_s1x): `model.py`'s detector
with grouped bottlenecks.

Each bottleneck is 1x1 → 3x3 in RESNETS.NUM_GROUPS groups → 1x1, of inner
width WIDTH_PER_GROUP · NUM_GROUPS · 2^stage and output 256 · 2^stage, its
spatial stride on the first 1x1 (RESNETS.STRIDE_1X1 true) or on the grouped
3x3 (false, Detectron's ResNeXt configs). Everything else, and the
precision (float32 with TF32 off; float8 e4m3 for the control), is
`model.py`'s. Plain PyTorch: no kernel of the system is imported.

Departures from the published model, as in `model.py`: frozen BatchNorm as
a per-channel affine, random seeded weights (each residual branch's last
affine scale 0.2), 15 PoseTrack keypoints, the keypoint head's
2·ROI_XFORM_RESOLUTION heatmaps; images carry T = 1 frames (clips of one
frame, tubes of 4 coordinates).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import model
from .model import STAGE_BLOCKS


def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """`model.param_spec` with each bottleneck's 3x3 weight (inner, inner /
    NUM_GROUPS, t, 3, 3): the MSRA fan-out std is the same (it counts the
    output channels), only the input channels a group sees shrink."""
    g = cfg["RESNETS"]["NUM_GROUPS"]
    out = []
    for name, shape, kind, value in model.param_spec(cfg):
        if name.startswith("backbone.res") and name.endswith(".b.conv.weight"):
            shape = (shape[0], shape[1] // g) + tuple(shape[2:])
        out.append((name, shape, kind, value))
    return out


class Detector(model.Detector):
    """`model.Detector` with grouped 3x3 convs and the stride where
    RESNETS.STRIDE_1X1 puts it."""

    def conv(self, x, name, stride=(1, 1, 1), bias=False, low=True):
        """`model.Detector.conv` in x.shape[-1] / weight.shape[1] groups."""
        w = self.p[name + ".weight"]
        groups = x.shape[-1] // w.shape[1]
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
        y = fn(xc, w, None, stride, [lo for lo, _ in pads], 1,
               groups).movedim(1, -1)
        if per_frame:
            y = y.reshape((b, tt) + y.shape[1:])
        if bias:
            y = y + self.p[name + ".bias"]
        return y

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
        on_1x1 = cfg["RESNETS"]["STRIDE_1X1"]
        feats = {}
        for stage, n in enumerate(STAGE_BLOCKS[cfg["MODEL"]["CONV_BODY"]]):
            s = 1 if stage == 0 else 2
            for bi in range(n):
                pre = f"backbone.res{stage + 2}_{bi}"
                st = (1, s, s) if bi == 0 else (1, 1, 1)
                s1, s3 = (st, (1, 1, 1)) if on_1x1 else ((1, 1, 1), st)
                short = (self.conv_affine(y, pre + ".proj", st) if bi == 0
                         else y)
                z = F.relu(self.conv_affine(y, pre + ".a", s1))
                z = F.relu(self.conv_affine(z, pre + ".b", s3))
                y = F.relu(self.conv_affine(z, pre + ".c") + short)
            feats[f"res{stage + 2}"] = y
        return self.pyramid(feats)

    def pyramid(self, feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """{res2..res5} → {p2..p6}: `model.Detector.features`' FPN."""
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
