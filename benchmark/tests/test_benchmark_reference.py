"""The plain reference agrees with the system's CPU path at a narrow
size, for the entries the windows drive: the detect entry (box candidates,
NMS, keypoints, features) and the training step (losses, clipped first
gradient, the weights after three steps), both with the configuration's
compute in float32 so that the two can agree to rounding."""

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers.finetune import Driver as TrainDriver
from benchmark.manifest import flatten_cfg
from benchmark.reference.model import Detector

from small import small_config, small_run


def test_detect_entry_agrees():
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.inference import make_detect_fn
    from detectandtrack_tpu_torch.models.detector import build_model
    torch.manual_seed(0)
    cfg = small_config(dtype="float32")["cfg"]
    params = inputs.make_weights(cfg, 2 ** 35 + 9, "cpu")
    model = build_model(load_cfg(opts=flatten_cfg(cfg)), device="meta")
    model = model.to_empty(device="cpu")
    model.load_state_dict(params)
    detect = make_detect_fn(model.eval(), with_proposals=True, run_rpn=True)
    clips = inputs.make_clips(3, 0, (2, 2, 64, 96, 3), "cpu")
    tubes = torch.as_tensor(inputs.make_realistic_tubes(2, 30, 2, 64, 96, 4))
    got = detect(clips, tubes)
    with torch.no_grad():
        ref = Detector(cfg, params).detect(clips, tubes)
    assert got["valid"].sum() > 4
    assert torch.equal(got["valid"], ref["valid"])
    v = ref["valid"]
    for k, tol in (("boxes", 1e-3), ("scores", 1e-5), ("features", 1e-4),
                   ("keypoints", 1e-3)):
        a, b = got[k][v].float(), ref[k][v].float()
        assert torch.allclose(a, b, rtol=1e-4, atol=tol), (
            k, (a - b).abs().max())


def test_training_step_agrees():
    """Both probes: the set-up's first steps and the window's, the latter
    from the system's own state (momentum and step number included)."""
    _, run = small_run("r50_t8.train_b1", dtype="float32")
    d = TrainDriver(run)
    d.setup()
    d.window(0.0)
    assert d.probe.done and d.probe.step >= len(d.ring)
    r = d.readings()
    for probe in ("start", "window"):
        assert r[f"{probe}.loss_gap"] < 1e-5
        assert r[f"{probe}.rpn_loss_gap"] < 1e-5
        assert r[f"{probe}.grad_gap"] < 1e-4
        assert r[f"{probe}.update_gap"] < 5e-3
    assert np.isfinite(list(v for v in r.values()
                            if isinstance(v, float))).all()
