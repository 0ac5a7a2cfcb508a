"""The port's training ops against the JAX package on the CPU, at f32 on
seeded numpy inputs: the losses (atol 1e-6), the target samplers fed the
very draws `jax.random.uniform` makes (labels, indices and validity exact;
regression targets atol 1e-5), and the LR schedules (rtol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_realistic_tubes
from detectandtrack_tpu.engine import losses as jl
from detectandtrack_tpu.engine import targets as jt
from detectandtrack_tpu.ops.anchors import (generate_anchors,
                                            shifted_anchor_field)
from detectandtrack_tpu.utils import lr_policy as jlr
from detectandtrack_tpu_torch.engine import losses as tl
from detectandtrack_tpu_torch.engine import targets as tt
from detectandtrack_tpu_torch.utils import lr_policy as tlr
from test_torch_slice import both_cfgs


def _t(x):
    return torch.from_numpy(np.array(x))


def _loss_inputs(name, rng):
    """Positional arguments of loss `name`: f32 arrays, int32 labels."""
    s, c, t, k, hs = 12, 3, 2, 5, 6
    f = np.float32
    labels = rng.integers(0, c, s).astype(np.int32)
    rpn_labels = rng.integers(-1, 2, 40).astype(np.int32)
    return {
        "smooth_l1": (rng.normal(size=(9, 8)).astype(f),
                      rng.normal(size=(9, 8)).astype(f), 0.3),
        "softmax_ce": (rng.normal(size=(s, c)).astype(f), labels,
                       (rng.uniform(size=s) > 0.3).astype(f)),
        "sigmoid_ce": ((rng.normal(size=40) * 3).astype(f),
                       rpn_labels.clip(0).astype(f),
                       (rng.uniform(size=40) > 0.2).astype(f)),
        "rpn_losses": (rng.normal(size=40).astype(f),
                       rng.normal(size=(40, 4 * t)).astype(f), rpn_labels,
                       rng.normal(size=(40, 4 * t)).astype(f), 0.111),
        "fast_rcnn_losses": (rng.normal(size=(s, c)).astype(f),
                             rng.normal(size=(s, c, t, 4)).astype(f), labels,
                             rng.normal(size=(s, 4 * t)).astype(f),
                             (labels > 0).astype(f),
                             rng.uniform(size=s) > 0.2, 1.0),
        "keypoint_loss": (rng.normal(size=(s, hs, hs, k)).astype(f),
                          rng.integers(0, hs * hs, (s, k)).astype(np.int32),
                          (rng.uniform(size=(s, k)) > 0.4).astype(f)),
    }[name]


@pytest.mark.parametrize("name,kw", [
    ("smooth_l1", {}), ("softmax_ce", {}), ("sigmoid_ce", {}),
    ("rpn_losses", {}), ("fast_rcnn_losses", {}), ("keypoint_loss", {}),
    ("keypoint_loss", {"normalize_by_visible": False, "loss_weight": 0.7})])
def test_losses_match_jax(name, kw):
    args = _loss_inputs(name, np.random.default_rng(0))
    want = getattr(jl, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args], **kw)
    got = getattr(tl, name)(*[_t(a) if isinstance(a, np.ndarray) else a
                              for a in args], **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def _gt(rng, t, n_valid, g=6, h=64, w=96):
    tubes = make_realistic_tubes(1, g, t, h, w, seed=int(rng.integers(100)))
    kps = np.zeros((g, t, 15, 3), np.float32)
    bx = tubes[0].reshape(g, t, 4)
    u = rng.uniform(-0.1, 1.1, size=(g, t, 15, 2))
    kps[..., 0] = bx[..., None, 0] + u[..., 0] * (bx[..., None, 2]
                                                  - bx[..., None, 0])
    kps[..., 1] = bx[..., None, 1] + u[..., 1] * (bx[..., None, 3]
                                                  - bx[..., None, 1])
    kps[..., 2] = rng.integers(0, 3, size=(g, t, 15))
    valid = np.zeros(g, bool)
    valid[:n_valid] = True
    return tubes[0], kps, valid


def _draws(key, n):
    k1, k2 = jax.random.split(key)
    return _t(jax.random.uniform(k1, (n,))), _t(jax.random.uniform(k2, (n,)))


@pytest.mark.parametrize("n_valid,straddle", [(3, 0.0), (6, -1.0), (0, 0.0)])
def test_rpn_targets_match_jax(n_valid, straddle):
    rng = np.random.default_rng(10 + n_valid)
    t = 2
    anchors = np.concatenate([
        shifted_anchor_field(generate_anchors(s, [8 * s], (0.5, 1.0, 2.0)),
                             s, 64 // s, 96 // s) for s in (4, 8)])
    gt, _, valid = _gt(rng, t, n_valid)
    key = jax.random.PRNGKey(n_valid)
    args = dict(positive_overlap=0.7, negative_overlap=0.3, batch_size=64,
                fg_fraction=0.5, straddle_thresh=straddle)
    want = jt.rpn_targets(key, jnp.asarray(anchors), jnp.asarray(gt),
                          jnp.asarray(valid), t, (64.0, 96.0), **args)
    got = tt.rpn_targets(_t(anchors), _t(gt), _t(valid), t, (64.0, 96.0),
                         *_draws(key, anchors.shape[0]), **args)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), atol=1e-5)
    assert (got.labels == 0).any()
    assert (got.labels == 1).any() == (n_valid > 0)


@pytest.mark.parametrize("n_valid", [4, 0])
def test_proposal_targets_match_jax(n_valid):
    rng = np.random.default_rng(20 + n_valid)
    t = 2
    gt, kps, valid = _gt(rng, t, n_valid)
    props = make_realistic_tubes(1, 40, t, 64, 96, seed=3)[0]
    # Some proposals near the GT so that fg rows exist.
    props[:8] = gt[np.arange(8) % 6] + rng.normal(0, 2.0, (8, 4 * t))
    pvalid = rng.uniform(size=40) > 0.1
    key = jax.random.PRNGKey(7)
    args = dict(batch_size=24, fg_fraction=0.25, fg_thresh=0.5,
                bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                reg_weights=(10.0, 10.0, 5.0, 5.0))
    want = jt.proposal_targets(key, jnp.asarray(props), jnp.asarray(pvalid),
                               jnp.asarray(gt), jnp.asarray(kps),
                               jnp.asarray(valid), t, **args)
    got = tt.proposal_targets(_t(props), _t(pvalid), _t(gt), _t(kps),
                              _t(valid), t, *_draws(key, 46), **args)
    for field in ("rois", "labels", "bbox_weights", "keypoint_targets",
                  "is_fg", "valid", "gt_inds"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), atol=1e-5)
    assert got.is_fg.any() == (n_valid > 0)


def test_keypoint_heatmap_targets_match_jax():
    rng = np.random.default_rng(30)
    gt, kps, _ = _gt(rng, 1, 6)
    rois = gt + rng.normal(0, 3.0, gt.shape).astype(np.float32)
    want = jt.keypoint_heatmap_targets(jnp.asarray(rois),
                                       jnp.asarray(kps[:, 0]), 28)
    got = tt.keypoint_heatmap_targets(_t(rois), _t(kps[:, 0]), 28)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[1].sum() < got[1].numel()


@pytest.mark.parametrize("policy", ["steps_with_decay", "step", "fixed"])
@pytest.mark.parametrize("warm", [("linear", 500), ("constant", 100),
                                  ("linear", 0)])
def test_lr_schedules_match_jax(policy, warm):
    method, iters = warm
    jcfg, cfg = both_cfgs(opts=[
        "SOLVER.LR_POLICY", policy, "SOLVER.BASE_LR", 0.02,
        "SOLVER.STEPS", "[0, 300, 450]", "SOLVER.GAMMA", 0.1,
        "SOLVER.WARM_UP_METHOD", method, "SOLVER.WARM_UP_ITERS", iters])
    jsched = jlr.make_schedule(jcfg.SOLVER)
    tsched = tlr.make_schedule(cfg.SOLVER)
    steps = np.arange(601)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
    got = np.array([tsched(int(s)).item() for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    kw = dict(base_lr=0.02, policy=policy, gamma=0.1, steps=(0, 300, 450),
              step_size=200, warm_up_iters=iters, warm_up_method=method)
    assert [tlr.get_lr_at_iter(int(s), **kw) for s in steps] == [
        jlr.get_lr_at_iter(int(s), **kw) for s in steps]
