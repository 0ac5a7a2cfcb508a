"""Offline inference: batches of clips through the graphed detect entry,
double-buffered, as offline evaluation and labelling run it.

Traffic parameters (`traffic/<name>.json`):
  batch          clips a call
  clip_hw        [H, W] of a clip (a shape bucket of the configuration)
  ring           distinct seeded batches the window cycles over
  trace_seconds  the traced window of a `--trace 1` run

The entry is the graphed detect on given tubes with the RPN and its NMS
running (`make_detect_fn(with_proposals=True, run_rpn=True)`): seeded
person-shaped tubes replace the RPN's output, since random weights would
put every proposal on one FPN level. The check judges CHECK_CALLS calls of
the window (`judge.py`).

The window: call i+1 is dispatched before call i is read back to the host;
it ends with the read-back of the first call that ends past `--seconds`.
`clips_per_s` is all clips of all calls over all of that time.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops, inputs, judge
from ..harness import Run, Window
from ..manifest import flatten_cfg
from ..reference.model import Detector, f32_mode
from ..roofline import bound_ms, conv1_work, roi_align_work

OUTS = ("boxes", "scores", "valid", "features", "keypoints")
CHECK_CALLS = 4          # 16 clips at B=4, from both ring batches


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.tr = run.traffic
        self.batch = int(self.tr["batch"])
        self.hw = tuple(self.tr["clip_hw"])
        self.t = run.cfg["VIDEO"]["NUM_FRAMES"]

    # -- set-up --

    def build_system(self):
        """The system's model on the device with the seeded weights, and its
        graphed detect entry."""
        from detectandtrack_tpu_torch.core.config import load_cfg
        from detectandtrack_tpu_torch.engine.inference import make_detect_fn
        from detectandtrack_tpu_torch.models.detector import build_model
        cfg = load_cfg(opts=flatten_cfg(self.run.cfg))
        model = build_model(cfg, device="meta").to_empty(
            device=self.run.device)
        model.load_state_dict(self.params)
        self.model = model.eval()
        self.detect = make_detect_fn(model, with_proposals=True,
                                     run_rpn=True)

    def setup(self):
        run, dev = self.run, self.run.device
        self.params = inputs.make_weights(run.cfg, run.seed, dev)
        self.ring = self.make_ring(int(self.tr["ring"]))
        self.build_system()
        for r in range(len(self.ring)):        # capture, then a replay each
            self.fetch(self.detect(*self.ring[r]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def make_ring(self, n: int):
        """n seeded batches: clips (B, T, H, W, 3) and tubes (B, K, 4T)."""
        run, dev, (h, w) = self.run, self.run.device, self.hw
        k = run.cfg["RPN"]["POST_NMS_TOP_N_TEST"]
        return [(inputs.make_clips(run.seed, r, (self.batch, self.t, h, w, 3),
                                   dev),
                 torch.as_tensor(inputs.make_realistic_tubes(
                     self.batch, k, self.t, h, w,
                     seed=inputs.derive(run.seed, "tubes", r)), device=dev))
                for r in range(n)]

    def _meta_detect(self):
        cfg, (h, w) = self.run.cfg, self.hw
        params = {k: torch.empty(v.shape, device="meta")
                  for k, v in self.params.items()}
        k = cfg["RPN"]["POST_NMS_TOP_N_TEST"]
        Detector(cfg, params).detect(
            torch.empty((self.batch, self.t, h, w, 3), device="meta"),
            torch.empty((self.batch, k, 4 * self.t), device="meta"))

    @staticmethod
    def fetch(out) -> Dict[str, np.ndarray]:
        return {k: (out[k].float() if out[k].is_floating_point()
                    else out[k]).cpu().numpy() for k in OUTS}

    # -- the window --

    def keep(self, i: int, out: Dict[str, np.ndarray]) -> None:
        """Reservoir sampling: after n calls `self.kept` holds CHECK_CALLS
        of them, (call index, outputs), uniform over the n and drawn from
        the seed, without holding every call's outputs."""
        if i < CHECK_CALLS:
            self.kept.append((i, out))
        else:
            j = int(self.sampler.integers(0, i + 1))
            if j < CHECK_CALLS:
                self.kept[j] = (i, out)

    def window(self, seconds: float) -> Window:
        self.run.spans.clear()
        self.kept: List = []
        self.sampler = np.random.default_rng(
            inputs.derive(self.run.seed, "sample"))
        ring = self.ring
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i, pending = 0, None
        while True:
            with self.run.span("dispatch"):
                out = self.detect(*ring[i % len(ring)])
            if pending is not None:
                with self.run.span("read_back"):
                    self.keep(i - 1, self.fetch(pending))
            pending = out
            i += 1
            if time.perf_counter() >= deadline:
                break
        with self.run.span("read_back"):
            last = self.fetch(pending)
        dt = time.perf_counter() - t0
        self.last = last
        self.keep(i - 1, last)
        clips = i * self.batch
        return Window(units=clips, seconds=dt, attempted=clips,
                      values={"clips_per_s": clips / dt})

    def facts(self) -> Dict[str, float]:
        """FLOPs a clip, and the least time a call takes in conv1 and in
        RoIAlign's forward (box stage on the ring's first tubes, keypoint
        stage on the last call's detections)."""
        cfg, (h, w), b, t = self.run.cfg, self.hw, self.batch, self.t
        fpn = cfg["FPN"]
        lvls = list(range(fpn["ROI_MIN_LEVEL"], fpn["ROI_MAX_LEVEL"] + 1))
        shapes = [(b * t, -(-h // 2 ** l), -(-w // 2 ** l), fpn["DIM"])
                  for l in lvls]
        strides = [2 ** l for l in lvls]

        def stage(tubes, p):
            from ..reference import ops
            k = tubes.shape[1]
            per = tubes.float().reshape(b, k, t, 4)
            rois = per.permute(0, 2, 1, 3).reshape(-1, 4)
            lv = ops.assign_fpn_levels(per[:, :, t // 2], lvls[0], lvls[-1],
                                       fpn["ROI_CANONICAL_SCALE"],
                                       fpn["ROI_CANONICAL_LEVEL"])
            lv = lv[:, None, :].expand(b, t, k).reshape(-1)
            slabs = torch.arange(b * t).repeat_interleave(k)
            return bound_ms(roi_align_work(shapes, strides, rois.cpu(),
                                           slabs, lv.cpu(), p))

        m = cfg["KRCNN"]["MAX_ROIS_PER_IM"]
        kp_boxes = torch.as_tensor(self.last["boxes"][:, :m])
        return {
            "flops_per_unit": flops.count(self._meta_detect) / self.batch,
            "units_per_call": float(b),
            "conv1_bound_ms_per_call": bound_ms(conv1_work(
                (b, t, h, w, 3), cfg["VIDEO"]["TIME_KERNEL_DIM"][0])),
            "roi_align_bound_ms_per_call": (
                stage(self.ring[0][1].cpu(),
                      cfg["FAST_RCNN"]["ROI_XFORM_RESOLUTION"])
                + stage(kp_boxes, cfg["KRCNN"]["ROI_XFORM_RESOLUTION"])),
        }

    def release(self):
        del self.detect, self.model

    # -- the check --

    def readings(self) -> Dict[str, float]:
        """The worst gaps of the CHECK_CALLS calls of the window kept."""
        run = self.run
        worst: Dict[str, float] = {}
        for slot in sorted({i % len(self.ring) for i, _ in self.kept}):
            calls = [out for i, out in self.kept if i % len(self.ring) == slot]
            for name, v in self.judge_batch(slot, calls, Detector(
                    run.cfg, self.params)).items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst

    def judge_batch(self, slot: int, calls: List[Dict[str, np.ndarray]],
                    ref: Detector) -> Dict[str, float]:
        """The worst gaps of `calls` (outputs for ring slot `slot`) against
        the reference `ref`, clip by clip."""
        clips, tubes = self.ring[slot]
        cfg = self.run.cfg
        hw = (float(self.hw[0]), float(self.hw[1]))
        worst: Dict[str, float] = {}
        with torch.no_grad(), f32_mode():
            for b in range(self.batch):
                pyr = ref.features(clips[b:b + 1])
                refined, scores, fc7 = ref.candidates(pyr, tubes[b:b + 1], hw)
                for out in calls:
                    gaps = judge.judge_clip(
                        {k: v[b] for k, v in out.items()},
                        refined[0].double().cpu().numpy(),
                        scores[0].double().cpu().numpy(),
                        fc7[0].float().cpu().numpy(),
                        lambda boxes: ref.heatmaps(pyr, boxes.to(
                            clips.device)), cfg["TEST"],
                        cfg["KRCNN"]["MAX_ROIS_PER_IM"])
                    for k, v in gaps.items():
                        worst[k] = max(worst.get(k, 0.0), v)
                del pyr
        return worst

    # -- the control --

    def control_readings(self, precision: str = "fp8") -> Dict[str, float]:
        """The reference in the system's place, computed in `precision`
        (no system is built): the gaps of its outputs on ring slot 0,
        judged as the window's are."""
        run = self.run
        self.params = inputs.make_weights(run.cfg, run.seed, run.device)
        clips, tubes = self.make_ring(1)[0]
        self.ring = [(clips, tubes)]
        low = Detector(run.cfg, self.params, precision)
        with torch.no_grad():
            outs = [low.detect(clips[b:b + 1], tubes[b:b + 1])
                    for b in range(self.batch)]
        out = {k: torch.cat([o[k] for o in outs]).float().cpu().numpy()
               for k in OUTS}
        out["valid"] = out["valid"].astype(bool)
        return self.judge_batch(0, [out], Detector(run.cfg, self.params))
