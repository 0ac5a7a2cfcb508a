"""Offline inference of the ResNeXt FPN keypoint model (`x101_64x4d`):
`offline_infer`'s traffic, window and check, with the grouped reference
(`reference/resnext.py`) in the plain reference's place and its weights.

Frames are clips of T = 1, so `clips_per_s` reads frames a second. Traffic
parameters are `offline_infer`'s. `facts()` adds
`grouped_conv_bound_ms_per_call`: the least time of the body's grouped 3x3
convs with their epilogues in one call (`roofline_grouped.py`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import offline_infer
from .. import inputs
from ..reference.resnext import Detector, param_spec
from ..roofline import bound_ms
from ..roofline_grouped import grouped_conv_work, sites


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """`inputs.make_weights`' recipe and stream over the grouped
    reference's parameters."""
    spec = param_spec(cfg)
    total = sum(int(np.prod(shape)) for _, shape, kind, _ in spec
                if kind == "normal")
    flat = torch.randn(total, generator=inputs.generator(seed, device,
                                                         "weights"),
                       device=device)
    out, at = {}, 0
    for name, shape, kind, value in spec:
        n = int(np.prod(shape))
        if kind == "normal":
            out[name] = flat[at:at + n].view(shape).mul_(value)
            at += n
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out


class Driver(offline_infer.Driver):
    def setup(self):
        run, dev = self.run, self.run.device
        self.params = make_weights(run.cfg, run.seed, dev)
        self.ring = self.make_ring(int(self.tr["ring"]))
        self.build_system()
        for r in range(len(self.ring)):        # capture, then a replay each
            self.fetch(self.detect(*self.ring[r]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _meta_detect(self):
        cfg, (h, w) = self.run.cfg, self.hw
        params = {k: torch.empty(v.shape, device="meta")
                  for k, v in self.params.items()}
        k = cfg["RPN"]["POST_NMS_TOP_N_TEST"]
        Detector(cfg, params).detect(
            torch.empty((self.batch, self.t, h, w, 3), device="meta"),
            torch.empty((self.batch, k, 4 * self.t), device="meta"))

    def facts(self) -> Dict[str, float]:
        out = super().facts()
        out["grouped_conv_bound_ms_per_call"] = sum(
            bound_ms(grouped_conv_work(shape, g, s))
            for shape, g, s in sites(self.run.cfg, self.batch * self.t,
                                     self.hw))
        return out

    def readings(self) -> Dict[str, float]:
        run = self.run
        worst: Dict[str, float] = {}
        for slot in sorted({i % len(self.ring) for i, _ in self.kept}):
            calls = [out for i, out in self.kept if i % len(self.ring) == slot]
            for name, v in self.judge_batch(slot, calls, Detector(
                    run.cfg, self.params)).items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst

    def control_readings(self, precision: str = "fp8") -> Dict[str, float]:
        run = self.run
        self.params = make_weights(run.cfg, run.seed, run.device)
        clips, tubes = self.make_ring(1)[0]
        self.ring = [(clips, tubes)]
        low = Detector(run.cfg, self.params, precision)
        with torch.no_grad():
            outs = [low.detect(clips[b:b + 1], tubes[b:b + 1])
                    for b in range(self.batch)]
        out = {k: torch.cat([o[k] for o in outs]).float().cpu().numpy()
               for k in offline_infer.OUTS}
        out["valid"] = out["valid"].astype(bool)
        return self.judge_batch(0, [out], Detector(run.cfg, self.params))
