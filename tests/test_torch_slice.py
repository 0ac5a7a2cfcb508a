"""The port's detect → track slice against the JAX model with bridged
weights, on the CPU (the JAX model runs its exact dense RoIAlign and plain
conv1 here; the port runs its kernels' plain versions)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.core.config import load_cfg as jax_load_cfg
from detectandtrack_tpu.engine import inference as jinf
from detectandtrack_tpu.models.detector import GeneralizedRCNN
from detectandtrack_tpu.models.detector import build_model as jax_build
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.engine import inference as tinf
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.tracking.tracker import Tracker, TrackerConfig
from detectandtrack_tpu_torch.utils.params import jax_params_to_state_dict
from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes

# tests/test_golden.py's model: R-18, T=2, 64x96, f32.
GOLDEN_OPTS = [
    "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
    "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
    "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
    "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
    "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
    "TEST.SHAPE_BUCKETS", "[[64, 96]]",
    "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 32,
]


def _random_params(shapes, rng, path=()):
    """Seeded params shaped like the flax tree, drawn like its initializers
    (MSRA convs, Xavier dense, small predictors) with non-trivial affine
    scales and biases so every leaf matters."""
    if isinstance(shapes, dict):
        return {k: _random_params(v, rng, path + (k,))
                for k, v in shapes.items()}
    name, parent = path[-1], path[-2]
    if name == "scale":
        v = rng.uniform(0.8, 1.2, shapes)
    elif name == "bias":
        v = rng.normal(0.0, 0.02, shapes)
    elif (parent in ("cls_score", "kps_score_lowres", "mask_fcn_logits")
          or "rpn_head" in path):
        v = rng.normal(0.0, 0.01, shapes)
    elif parent == "bbox_pred":
        v = rng.normal(0.0, 0.001, shapes)
    elif len(shapes) == 2:
        v = rng.normal(0.0, math.sqrt(2.0 / sum(shapes)), shapes)
    else:
        v = rng.normal(0.0, math.sqrt(
            2.0 / (math.prod(shapes[:-2]) * shapes[-1])), shapes)
    return v.astype(np.float32)


def both_cfgs(yaml_path=None, opts=()):
    """(JAX config, port config): each package's own `load_cfg` on the
    same YAML and opts."""
    return (jax_load_cfg(yaml_path, opts=list(opts)),
            load_cfg(yaml_path, opts=list(opts)))


def _pair(yaml_path, opts, clip_shape, seed=0):
    """(port cfg, jax model, jax params, port model with the same
    weights); the JAX model is built from the JAX package's config."""
    jcfg, cfg = both_cfgs(yaml_path, opts)
    jm = jax_build(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(clip_shape, jnp.float32))
    shapes = jax.tree.map(lambda s: tuple(s.shape), shapes,
                          is_leaf=lambda s: hasattr(s, "shape"))
    params = _random_params(shapes, np.random.default_rng(seed))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    return cfg, jm, params, tm


def _np(x):
    return x.float().numpy() if x.is_floating_point() else x.numpy()


def _compare_outputs(jout, tout, box_tol=1e-2):
    valid = np.asarray(jout["valid"])
    np.testing.assert_array_equal(_np(tout["valid"]), valid)
    assert valid.any()
    np.testing.assert_allclose(_np(tout["scores"])[valid],
                               np.asarray(jout["scores"])[valid], atol=1e-4)
    np.testing.assert_allclose(_np(tout["boxes"])[valid],
                               np.asarray(jout["boxes"])[valid], atol=box_tol)
    # fc7 sums ~10^5 products per unit: compare against its own scale.
    feats = np.asarray(jout["features"])[valid]
    np.testing.assert_allclose(_np(tout["features"])[valid], feats,
                               atol=1e-4 * max(1.0, np.abs(feats).max()))
    kv = valid[:, :tout["keypoints"].shape[1]]
    np.testing.assert_allclose(_np(tout["keypoints"])[kv],
                               np.asarray(jout["keypoints"])[kv],
                               atol=box_tol)


@pytest.fixture(scope="module")
def golden():
    clip = np.random.default_rng(42).normal(size=(1, 2, 64, 96, 3)).astype(
        np.float32)
    return _pair(None, GOLDEN_OPTS, clip.shape) + (clip,)


def test_golden_pyramid_and_pooled_features(golden):
    cfg, jm, params, tm, clip = golden
    jpyr = jm.apply(params, jnp.asarray(clip),
                    method=GeneralizedRCNN.features)
    with torch.no_grad():
        tpyr = tm.features(torch.from_numpy(clip))
    assert set(tpyr) == set(jpyr) == {"p2", "p3", "p4", "p5", "p6"}
    for lvl in jpyr:
        np.testing.assert_allclose(tpyr[lvl].numpy(), np.asarray(jpyr[lvl]),
                                   atol=1e-4, rtol=1e-4, err_msg=lvl)
    tubes = make_realistic_tubes(1, 16, 2, 64, 96)
    for res in (7, 14):
        jp = jm.apply(params, jpyr, jnp.asarray(tubes), res, 2,
                      method=GeneralizedRCNN.roi_transform)
        with torch.no_grad():
            tp = tm.roi_transform(tpyr, torch.from_numpy(tubes), res, 2)
        assert tuple(tp.shape) == (16, 2, res, res, 256)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4,
                                   rtol=1e-4)


def test_golden_detections(golden):
    cfg, jm, params, tm, clip = golden
    jout = jm.apply(params, jnp.asarray(clip))
    with torch.no_grad():
        tout = tm(torch.from_numpy(clip))
    assert tuple(tout["boxes"].shape) == (1, 4, 8)
    assert tuple(tout["keypoints"].shape) == (1, 4, 2, 15, 4)
    _compare_outputs(jout, tout)
    np.testing.assert_array_equal(_np(tout["proposal_valid"]),
                                  np.asarray(jout["proposal_valid"]))
    pv = np.asarray(jout["proposal_valid"])
    np.testing.assert_allclose(_np(tout["proposals"])[pv],
                               np.asarray(jout["proposals"])[pv], atol=1e-2)


def test_detect_fn_frames_and_tracker(golden):
    """make_detect_fn → clip_slice → detections_to_frames equals the JAX
    engine's host hand-off on the same outputs, and feeds the tracker."""
    cfg, jm, params, tm, clip = golden
    det = tinf.make_detect_fn(tm)(torch.from_numpy(clip))
    assert set(det) == {"boxes", "scores", "valid", "features", "keypoints"}
    det_np = {k: _np(v) for k, v in det.items()}
    got = tinf.detections_to_frames(tinf.clip_slice(det, 0), 2, 0.5)
    want = jinf.detections_to_frames(jinf.clip_slice(det_np, 0), 2, 0.5)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    tracker = Tracker(TrackerConfig(score_thresh=0.0))
    ids = [tracker.update(f["boxes"], f["scores"], f["keypoints"],
                          f["features"], f["valid"]) for f in got]
    n_valid = int(det_np["valid"].sum())
    assert (ids[0] >= 0).sum() == n_valid
    assert (ids[1] >= 0).sum() == n_valid
