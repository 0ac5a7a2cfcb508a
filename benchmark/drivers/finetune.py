"""Fine-tuning: SGD steps of the system's training step on seeded clips
and ground truth, as `--mode train` runs them.

Traffic parameters (`traffic/<name>.json`):
  batch          clips a step
  frame_hw       [H, W] of the source frames; the loader's rule scales
                 them to TRAIN.SCALES[0] / TRAIN.MAX_SIZE and pads the
                 result into the smallest of TEST.SHAPE_BUCKETS that fits
  ring           distinct seeded batches the steps cycle over
  gt_range       [lo, hi]: ground-truth person tubes a clip, uniform
  trace_seconds  the traced window of a `--trace 1` run

Set-up builds one training state (model, optimizer state, step function)
and drives it through the ring's first steps (one per batch, each on rows
that differ). The window then runs steps on the same state, cycling over
the ring; it ends with the first step dispatched past `--seconds` (and
not before the window's probe below is complete), then waits for the
card. `train_clips_per_s` is the clips of all those steps over all that
time.

The check follows two probes of three consecutive steps each, both taken
through the same step call: `start`, the first three steps of set-up,
from the seeded weights; and `window`, three steps of the timed window
from a step drawn from the seed (within its first PROBE_SPREAD steps),
from the system's own state there (weights and momentum copied before
the first, the momentum after it, the weights after the third). For
each, the plain reference (`reference/train.py`) runs the same three
steps from the same state on the same batches, draws and step numbers,
in float32. `gaps` computes every number below, for each probe as
`<probe>.<number>`; `limits/<cell>.json` names those the check compares:
  rpn_loss_gap       the largest |RPN loss − the reference's| / |the
                     reference's| over the three steps (objectness and box
                     terms);
  grad_median_gap    the first step's clipped gradient, as the system's
                     optimizer state holds it after that step (momentum
                     less μ × the momentum before and the weight decay of
                     the weights before), against the reference's, by the
                     median leaf (`reference.train.leaf_gap_map`);
  update_median_gap  the weights' change over the three steps against the
                     reference's, by the median leaf;
  grad_median_gap.<module>, update_median_gap.<module>: the same over the
                     leaves of one top-level module (backbone, fpn,
                     rpn_head, box_head, kps_head);
  loss_gap, loss1_gap, <term>_loss_gap, grad_gap, update_gap: the total
                     loss over the three steps and at the first, each loss
                     term, and the worst leaf of each. Not compared: bf16
                     moves the RPN's top-k among near-equal objectness, 4-12%
                     of the proposals then differ from the reference's, the
                     sampled RoIs with them, and the box loss and the
                     leaves the sampled RoIs reach swing (PERF.md).
Leaves of the frozen stages, and leaves whose reference gradient norm is
under a thousandth of the median leaf's (a bias under a softmax, moved by
rounding alone), are left out of the leaf numbers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import flops, inputs
from ..harness import Run, Window
from ..manifest import flatten_cfg
from ..reference.model import Detector, f32_mode
from ..reference.train import (ReferenceStep, decayed, frozen, leaf_gap_map,
                               train_forward)
from ..roofline import bound_ms, roi_align_backward_work

REF_STEPS = 3
SMALL_GRAD = 1e-3
PROBE_SPREAD = 8
TERMS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
         "loss_kps", "loss_total")


def _median(values) -> float:
    vals = sorted(values)
    return vals[len(vals) // 2]


def _copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


@dataclass
class Probe:
    """REF_STEPS consecutive steps from step number `step` as a stepper
    (anything with `params`, `momentum` and `step`) ran them: its weights
    and momentum before the first, its momentum after the first, its
    weights after the last, and each step's loss terms."""
    step: int
    params: Optional[Dict[str, torch.Tensor]] = None
    momentum: Optional[Dict[str, torch.Tensor]] = None
    momentum1: Optional[Dict[str, torch.Tensor]] = None
    after: Optional[Dict[str, torch.Tensor]] = None
    terms: List[Dict] = field(default_factory=list)

    def before(self, stepper) -> None:
        if stepper.step == self.step:
            self.params = _copy(stepper.params)
            self.momentum = _copy(stepper.momentum)

    def took(self, stepper, terms: Dict) -> None:
        """After a step: `stepper.step` is the number of the next one."""
        j = stepper.step - 1 - self.step
        if 0 <= j < REF_STEPS:
            self.terms.append(terms)
            if j == 0:
                self.momentum1 = _copy(stepper.momentum)
            if j == REF_STEPS - 1:
                self.after = _copy(stepper.params)

    @property
    def done(self) -> bool:
        return self.after is not None


def clip_shape(cfg: Dict, frame_hw) -> tuple:
    """((scaled h, w), bucket (H, W)) by the loader's rule: the short side to
    TRAIN.SCALES[0], the long side capped at TRAIN.MAX_SIZE, padded into the
    smallest bucket that fits."""
    h0, w0 = frame_hw
    target, cap = cfg["TRAIN"]["SCALES"][0], cfg["TRAIN"]["MAX_SIZE"]
    scale = target / min(h0, w0)
    if round(scale * max(h0, w0)) > cap:
        scale = cap / max(h0, w0)
    sh, sw = int(round(h0 * scale)), int(round(w0 * scale))
    fits = sorted((b for b in cfg["TEST"]["SHAPE_BUCKETS"]
                   if b[0] >= sh and b[1] >= sw), key=lambda b: b[0] * b[1])
    bucket = tuple(fits[0] if fits else max(
        cfg["TEST"]["SHAPE_BUCKETS"], key=lambda b: b[0] * b[1]))
    return (min(sh, bucket[0]), min(sw, bucket[1])), bucket


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.tr = run.traffic
        self.batch = int(self.tr["batch"])
        self.t = run.cfg["VIDEO"]["NUM_FRAMES"]
        self.valid_hw, self.hw = clip_shape(run.cfg, self.tr["frame_hw"])

    def make_ring(self, n: int) -> List[Dict[str, torch.Tensor]]:
        run, dev = self.run, self.run.device
        out = []
        for r in range(n):
            gt = inputs.make_ground_truth(
                run.seed, r, self.batch, run.cfg["TRAIN"]["MAX_GT_PER_IM"],
                self.t, self.valid_hw, tuple(self.tr["gt_range"]))
            batch = {k: torch.as_tensor(v, device=dev) for k, v in gt.items()}
            batch["clips"] = inputs.make_clips(
                run.seed, r, (self.batch, self.t) + self.hw + (3,), dev,
                self.valid_hw)
            out.append(batch)
        return out

    # -- set-up --

    def setup(self):
        from detectandtrack_tpu_torch.core.config import load_cfg
        from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                           make_train_step)
        from detectandtrack_tpu_torch.models.detector import build_model
        run, dev = self.run, self.run.device
        self.params = inputs.make_weights(run.cfg, run.seed, dev)
        self.ring = self.make_ring(int(self.tr["ring"]))
        cfg = load_cfg(opts=flatten_cfg(run.cfg))
        model = build_model(cfg, device="meta", train=True).to_empty(
            device=dev)
        model.load_state_dict(self.params)
        self.model = model
        self.state = create_train_state(cfg, model)
        self.step_fn = make_train_step(model, cfg)
        self.start = Probe(0)
        for _ in range(len(self.ring)):
            self.step(self.start)
        self.probe = Probe(self.window_probe_step())

    def window_probe_step(self) -> int:
        """The window probe's first step: drawn from the seed among the
        window's first PROBE_SPREAD steps."""
        return len(self.ring) + inputs.derive(self.run.seed,
                                              "probe") % PROBE_SPREAD

    def step(self, probe: Optional[Probe]):
        """One step of the system's state on the ring's next batch, with
        the probe's copies around it; → the step's metrics (on the card)."""
        i = self.state.step
        if probe is not None:
            probe.before(self.state)
        self.state, metrics = self.step_fn(
            self.state, self.ring[i % len(self.ring)],
            draws=inputs.make_draws(self.run.seed, i))
        if probe is not None:
            probe.took(self.state, metrics)
        return metrics

    def _meta_step(self):
        cfg = self.run.cfg
        params = {k: torch.empty(v.shape, device="meta", requires_grad=True)
                  for k, v in self.params.items()}
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                 for k, v in self.ring[0].items()}

        def draws(stage, b, n):
            u = torch.empty((b, n), device="meta")
            return u, u

        terms = train_forward(Detector(cfg, params), batch, draws)
        terms["loss_total"].backward()

    # -- the window --

    def window(self, seconds: float) -> Window:
        """Steps until `--seconds` have passed; the first window of a run
        also holds the probe's steps (a traced window after it takes
        none)."""
        run = self.run
        run.spans.clear()
        probe = None if self.probe.done else self.probe
        step0 = self.state.step
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            with run.span("step"):
                metrics = self.step(probe)
            if (time.perf_counter() >= deadline
                    and (probe is None or probe.done)):
                break
        with run.span("wait"):
            last = float(metrics["loss_total"])
        dt = time.perf_counter() - t0
        steps = self.state.step - step0
        clips = steps * self.batch
        return Window(units=steps, seconds=dt, attempted=steps,
                      failed=0 if np.isfinite(last) else 1,
                      values={"train_clips_per_s": clips / dt})

    def facts(self) -> Dict[str, float]:
        """FLOPs a step, and the least time of a step's RoIAlign backward
        calls (the box head's rois at its resolution, the keypoint head's at
        its own)."""
        cfg, (h, w), b, t = self.run.cfg, self.hw, self.batch, self.t
        fpn, dim = cfg["FPN"], cfg["FPN"]["DIM"]
        shapes = [(b * t, -(-h // 2 ** l), -(-w // 2 ** l), dim)
                  for l in range(fpn["ROI_MIN_LEVEL"],
                                 fpn["ROI_MAX_LEVEL"] + 1)]
        fr, kr = cfg["FAST_RCNN"], cfg["KRCNN"]
        n_box = b * t * fr["BATCH_SIZE_PER_IM"]
        n_kp = b * t * min(kr["TRAIN_MAX_ROIS_PER_IM"],
                           fr["BATCH_SIZE_PER_IM"])
        return {
            "flops_per_unit": flops.count(self._meta_step),
            "roi_align_bwd_bound_ms_per_step": (
                bound_ms(roi_align_backward_work(
                    n_box, fr["ROI_XFORM_RESOLUTION"], dim, shapes))
                + bound_ms(roi_align_backward_work(
                    n_kp, kr["ROI_XFORM_RESOLUTION"], dim, shapes))),
        }

    def release(self):
        del self.step_fn, self.state, self.model

    # -- the check --

    def first_gradient(self, probe: Probe) -> Dict[str, torch.Tensor]:
        """The clipped gradient of the probe's first step from the
        optimizer's state: momentum after = gradient + weight decay ×
        weights before + μ × momentum before."""
        sol = self.run.cfg["SOLVER"]
        out = {}
        for k, m in probe.momentum1.items():
            p0 = probe.params[k].float()
            rate = (sol["WEIGHT_DECAY"] if decayed(k, p0)
                    else sol["WEIGHT_DECAY_BN"])
            g = m.float() - rate * p0
            if k in probe.momentum:
                g = g - sol["MOMENTUM"] * probe.momentum[k].float()
            out[k] = g
        return out

    def follow(self, probe: Probe, precision: str = "f32"):
        """(loss terms of each step, first clipped gradient, weights after
        REF_STEPS) of the plain reference from the probe's state."""
        ref = ReferenceStep(self.run.cfg, probe.params, precision,
                            probe.momentum, probe.step)
        losses, first = [], None
        with f32_mode():
            for j in range(REF_STEPS):
                i = probe.step + j
                terms, grads = ref(self.ring[i % len(self.ring)],
                                   inputs.make_draws(self.run.seed, i))
                losses.append(terms)
                if j == 0:
                    first = grads
        return losses, first, {k: p.detach() for k, p in ref.params.items()}

    def gaps(self, probe: Probe, ref) -> Dict[str, float]:
        """Every number the check can compare of one probe (see the module
        docstring)."""
        r_terms, r_first, r_after = ref
        terms = [{k: float(v) for k, v in t.items()} for t in probe.terms]
        cfg = self.run.cfg
        norms = {k: float(g.norm()) for k, g in r_first.items()}
        med = _median(norms.values())
        keep = [k for k in r_first if not frozen(cfg, k)
                and norms[k] >= SMALL_GRAD * med]
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)  # noqa: E731
        out = {
            "loss1_gap": rel(terms[0]["loss_total"], r_terms[0]["loss_total"]),
            "rpn_loss_gap": max(rel(a["loss_rpn_cls"] + a["loss_rpn_bbox"],
                                    b["loss_rpn_cls"] + b["loss_rpn_bbox"])
                                for a, b in zip(terms, r_terms)),
        }
        for name in TERMS:
            if all(name in t for t in terms):
                out[name.replace("loss_", "") + "_loss_gap"] = max(
                    rel(a[name], b[name]) for a, b in zip(terms, r_terms))
        out["loss_gap"] = out.pop("total_loss_gap")
        first = self.first_gradient(probe)
        base = {k: probe.params[k].float() for k in keep}
        maps = {
            # a leaf with no momentum after the step never moved: every
            # leaf reads as unmoved (gap 1)
            "grad": (leaf_gap_map(first, r_first, keep)
                     if all(k in first for k in keep)
                     else {k: 1.0 for k in keep}),
            "update": leaf_gap_map(
                {k: probe.after[k].float() - base[k] for k in keep},
                {k: r_after[k] - base[k] for k in keep}, keep),
        }
        for name, gaps in maps.items():
            worst = max(gaps, key=gaps.get)
            out[f"{name}_gap"] = gaps[worst]
            out[f"{name}_median_gap"] = _median(gaps.values())
            out[f"{name}_worst_leaf"] = worst
            for module in sorted({k.split(".")[0] for k in gaps}):
                out[f"{name}_median_gap.{module}"] = _median(
                    v for k, v in gaps.items() if k.split(".")[0] == module)
        return out

    def probes(self) -> Dict[str, Probe]:
        return {"start": self.start, "window": self.probe}

    def readings(self) -> Dict[str, float]:
        """Every number of both probes, as `<probe>.<number>`."""
        return {f"{name}.{k}": v for name, probe in self.probes().items()
                for k, v in self.gaps(probe, self.follow(probe)).items()}

    def control_readings(self, precision: str = "fp8") -> Dict[str, float]:
        """Every number of the reference in the system's place, computed in
        `precision` (no system is built) through both probes' steps,
        judged as the system is."""
        run = self.run
        self.params = inputs.make_weights(run.cfg, run.seed, run.device)
        self.ring = self.make_ring(int(self.tr["ring"]))
        self.start = Probe(0)
        self.probe = Probe(self.window_probe_step())
        stepper = ReferenceStep(run.cfg, self.params, precision)
        with f32_mode():
            while not self.probe.done:
                i = stepper.step
                for probe in self.probes().values():
                    probe.before(stepper)
                terms, _ = stepper(self.ring[i % len(self.ring)],
                                   inputs.make_draws(run.seed, i))
                for probe in self.probes().values():
                    probe.took(stepper, terms)
        del stepper
        return self.readings()
