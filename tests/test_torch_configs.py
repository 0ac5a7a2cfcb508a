"""Every model configuration in configs/video/ builds in the port and
infers what the JAX model infers, on the CPU with bridged seeded weights.

Each case runs its config at a 64x96 clip with narrow heads and small
budgets. Where depth is not what a config tests, the case swaps its body to
R-18 (C4 then feeds a 256-wide res4 into the 1024-wide RPN trunk); the
ResNeXt config keeps its grouped R-101 body at 4 groups of width 4. The
option each config exists for stays: C4, dilation, masks, soft-NMS and box
voting, flip TTA, RPN-only, center-frame keypoints, T. The flip-TTA config
runs `detect_tta`, RPN_ONLY the model's forward. This file holds the 2D
configs, tests/test_torch_configs_video.py the 3D ones (RPN-only among
them).

Tolerances: scores 1e-4, boxes and keypoints 1e-2, mask probabilities
1e-4, appearance features 1e-4 of their largest entry. Every output has
the static shape `detect_output_shapes` gives it."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.models.detector import GeneralizedRCNN
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.engine.inference import (
    detect_output_shapes, detect_outputs, make_detect_fn)
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils.params import jax_params_to_state_dict
from test_torch_slice import _compare_outputs, _np, _pair

H, W = 64, 96
SMALL_OPTS = [
    "MODEL.COMPUTE_DTYPE", "float32", "TEST.SHAPE_BUCKETS", "[[64, 96]]",
    "RPN.PRE_NMS_TOP_N_TEST", 128, "RPN.POST_NMS_TOP_N_TEST", 32,
    "TEST.DETECTIONS_PER_IM", 12, "TEST.SCORE_THRESH", 0.0,
    "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 16,
    "FAST_RCNN.MLP_HEAD_DIM", 64, "MRCNN.DIM_REDUCED", 16,
]
CONFIGS = sorted(os.path.basename(p)[:-5]
                 for p in glob.glob("configs/video/*.yaml"))


def _frames(name):
    cfg = load_cfg(f"configs/video/{name}.yaml")
    return cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1


def small_opts(name):
    cfg = load_cfg(f"configs/video/{name}.yaml")
    if cfg.RESNETS.NUM_GROUPS > 1:
        return SMALL_OPTS + ["RESNETS.NUM_GROUPS", 4,
                             "RESNETS.WIDTH_PER_GROUP", 4]
    return SMALL_OPTS + ["MODEL.CONV_BODY", "resnet18",
                         "RESNETS.WIDTH_PER_GROUP", 8]


# JAX's seeded weights and outputs per reduced model configuration.
# Configs that differ only in tracking, data or solver settings reduce to
# one model (the seven T=8 R-50/R-101 ones do) and share one JAX run on the
# same seeded weights and clip; each still builds and runs its own port
# model from its own file.
_MODEL_SECTIONS = ("MODEL", "RESNETS", "FPN", "RPN", "FAST_RCNN", "KRCNN",
                   "MRCNN", "VIDEO", "TEST")
_JAX_RUNS = {}


def check_config(name, opts=()):
    """Build `name` small in both packages (with `opts` on top of
    `small_opts`), run one clip, compare."""
    t = _frames(name)
    clip = np.random.default_rng(7).normal(size=(1, t, H, W, 3)).astype(
        np.float32)
    path = f"configs/video/{name}.yaml"
    opts = small_opts(name) + list(opts)
    cfg = load_cfg(path, opts=opts)
    tta = cfg.TEST.BBOX_AUG_ENABLED
    key = tuple(repr(getattr(cfg, s)) for s in _MODEL_SECTIONS)
    if key not in _JAX_RUNS:
        _, jm, params, tm = _pair(path, opts, clip.shape, seed=3)
        method = (GeneralizedRCNN.detect_tta if tta
                  else GeneralizedRCNN.__call__)
        _JAX_RUNS[key] = params, jax.jit(
            lambda p, c: jm.apply(p, c, method=method))(params,
                                                       jnp.asarray(clip))
    else:
        tm = build_model(cfg, device="cpu")
        tm.load_state_dict(jax_params_to_state_dict(_JAX_RUNS[key][0], tm))
    jout = _JAX_RUNS[key][1]
    with torch.no_grad():
        x = torch.from_numpy(clip)
        tout = tm.detect_tta(x) if tta else tm(x)
    valid = np.asarray(jout["valid"])
    assert set(jout) <= set(tout)
    for k in ("boxes", "scores", "valid", "features", "keypoints", "masks"):
        if k in jout:
            assert tuple(tout[k].shape) == jout[k].shape, k
    assert {k: tuple(v.shape) for k, v in detect_outputs(tout).items()} == (
        detect_output_shapes(tm, 1))
    if cfg.MODEL.RPN_ONLY:
        assert not hasattr(tm, "box_head")
        np.testing.assert_array_equal(_np(tout["valid"]), valid)
        assert valid.any()
        np.testing.assert_allclose(_np(tout["scores"]),
                                   np.asarray(jout["scores"]), atol=1e-4)
        np.testing.assert_allclose(_np(tout["boxes"])[valid],
                                   np.asarray(jout["boxes"])[valid],
                                   atol=1e-2)
        return cfg, tm, clip, tout
    _compare_outputs(jout, tout)
    if cfg.MODEL.MASK_ON:
        probs = torch.sigmoid(tout["masks"][..., -1]).numpy()
        np.testing.assert_allclose(
            probs[valid], np.asarray(jax.nn.sigmoid(jout["masks"][..., -1]))
            [valid], atol=1e-4)
        det = make_detect_fn(tm, flip_tta=tta)(torch.from_numpy(clip))
        np.testing.assert_array_equal(det["masks"].numpy(), probs)
    return cfg, tm, clip, tout


@pytest.mark.parametrize("name", [n for n in CONFIGS if _frames(n) == 1])
def test_config_matches_jax(name):
    check_config(name)


def test_x101_with_the_stride_on_the_grouped_3x3_matches_jax():
    """The benchmark's ResNeXt-101 64x4d puts each stage's stride on the
    grouped 3x3 (Detectron's RESNETS.STRIDE_1X1 False; the YAML keeps the
    1x1): the port against the JAX package there, at 4 groups of 4."""
    cfg, tm, _, _ = check_config("2d_X101_64x4d_FPN_kps",
                                 ["RESNETS.STRIDE_1X1", False])
    assert not cfg.RESNETS.STRIDE_1X1 and cfg.RESNETS.NUM_GROUPS == 4
    block = tm.backbone.res3_0
    assert block.a.conv.strides == (1, 1, 1)
    assert block.b.conv.strides == (1, 2, 2) and block.b.conv.groups == 4


def test_every_config_builds():
    """build_model accepts every configs/video/*.yaml at full size."""
    assert len(CONFIGS) == 21
    for name in CONFIGS:
        model = build_model(load_cfg(f"configs/video/{name}.yaml"),
                            device="meta")
        assert sum(p.numel() for p in model.parameters()) > 0


def test_unknown_model_type_raises():
    cfg = load_cfg("configs/video/2d_R50_C4_kps.yaml",
                   opts=["MODEL.TYPE", "retinanet"])
    with pytest.raises(ValueError, match="MODEL.TYPE"):
        build_model(cfg, device="meta")
