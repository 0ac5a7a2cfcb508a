"""The port's own profiler scopes (`utils/profiling.scope`) on the CPU, at
the tiny R-18 size of the profiling tests: a training step under
torch.profiler shows its `train/*` phases and the `model/*` stages it
runs, nested as the step runs them; an eager detect shows the `model/*`
stages down to the keypoint decode; and with no profiler running neither
enters a `record_function`."""

import os

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.engine.inference import make_detect_fn
from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                   make_train_step)
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_CFG = os.path.join(ROOT, "configs/video/3d_R50_T8_tubes_kps.yaml")
OPTS = ["MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "RESNETS.WIDTH_PER_GROUP", "8", "FPN.DIM", "32",
        "FAST_RCNN.MLP_HEAD_DIM", "64", "VIDEO.NUM_FRAMES", "2",
        "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "RPN.PRE_NMS_TOP_N_TEST", "50", "RPN.POST_NMS_TOP_N_TEST", "16",
        "TEST.DETECTIONS_PER_IM", "4", "TEST.SCORE_THRESH", "-1.0",
        "TEST.SHAPE_BUCKETS", "[[64, 96]]",
        "KRCNN.NUM_STACKED_CONVS", "1", "KRCNN.CONV_HEAD_DIM", "16",
        "RPN.PRE_NMS_TOP_N_TRAIN", "100", "RPN.POST_NMS_TOP_N_TRAIN", "32",
        "RPN.BATCH_SIZE_PER_IM", "32", "FAST_RCNN.BATCH_SIZE_PER_IM", "32",
        "MODEL.MASK_ON", "True", "MRCNN.DIM_REDUCED", "8",
        "MRCNN.TRAIN_MAX_ROIS_PER_IM", "8", "KRCNN.TRAIN_MAX_ROIS_PER_IM", "8"]
TRAIN_PHASES = {"train/forward", "train/targets", "train/losses",
                "train/backward", "train/update"}
MODEL_STAGES = {"model/backbone", "model/fpn", "model/rpn", "model/nms",
                "model/roi_transform", "model/box_head", "model/kps_head",
                "model/mask_head"}


@pytest.fixture(scope="module")
def small():
    cfg = load_cfg(MAIN_CFG, opts=OPTS)
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.normal(size=(1, 2, 64, 96, 3)).astype(
        np.float32))
    tmodel = build_model(cfg, device="cpu", seed=0, train=True)
    state = create_train_state(cfg, tmodel)
    step_fn = make_train_step(tmodel, cfg)
    batch = {"clips": clip,
             "gt_boxes": torch.tensor([[[10.0, 8.0, 50.0, 60.0,
                                         12.0, 8.0, 52.0, 61.0]]]),
             "gt_keypoints": torch.zeros((1, 1, 2, 15, 3)),
             "gt_valid": torch.ones((1, 1), dtype=torch.bool),
             "gt_masks": torch.ones((1, 1, 2, 28, 28)),
             "gt_mask_valid": torch.ones((1, 1, 2), dtype=torch.bool)}
    box = {"state": state}

    def train_step():
        box["state"], metrics = step_fn(box["state"], batch)
        return metrics

    detect = make_detect_fn(build_model(cfg, device="cpu", seed=0))
    detect = getattr(detect, "eager", detect)
    return train_step, lambda: detect(clip)


def _program_scopes(prof):
    """(name, start, end) of every `train/*` and `model/*` scope."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith(("train/", "model/"))]


def test_train_step_phases_nest_under_the_profiler(small):
    train_step, _ = small
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = train_step()
    assert set(metrics) >= {"loss_kps", "loss_mask"}
    scopes = _program_scopes(prof)
    names = {n for n, _, _ in scopes}
    assert names == TRAIN_PHASES | MODEL_STAGES
    one = {n: (s, e) for n, s, e in scopes
           if n in ("train/forward", "train/backward", "train/update")}
    assert [n for n, _, _ in scopes].count("train/forward") == 1
    f0, f1 = one["train/forward"]
    for n, s, e in scopes:
        if n.startswith("model/") or n in ("train/targets", "train/losses"):
            assert f0 <= s and e <= f1, n
    b0, b1 = one["train/backward"]
    u0, u1 = one["train/update"]
    assert f1 <= b0 < b1 <= u0 < u1


def test_eager_detect_shows_the_model_stages(small):
    _, detect = small
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = detect()
    assert "keypoints" in out and "masks" in out
    names = {n for n, _, _ in _program_scopes(prof)}
    assert names == MODEL_STAGES | {"model/decode"}


def test_no_record_function_without_a_profiler(small, monkeypatch):
    train_step, detect = small
    built = []
    init = record_function.__init__

    def counting(self, *args, **kwargs):
        built.append(args[0] if args else kwargs.get("name"))
        init(self, *args, **kwargs)

    monkeypatch.setattr(record_function, "__init__", counting)
    train_step()
    detect()
    assert built == []
    # The count sees the scopes once a profiler runs.
    with profile(activities=[ProfilerActivity.CPU]):
        detect()
    assert "model/backbone" in built


def test_scope_is_one_flag_check():
    off = profiling.scope("train/update")
    assert off is profiling.scope("model/backbone")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.scope("train/update")
        assert isinstance(on, record_function)
