"""The port's training step against the JAX package's on the CPU, at f32:
the small model of tests/test_golden_hard.py (R-18, T=2, 64x96, B=2), the
same bridged weights, one seeded batch, and the very draws JAX's samplers
make (`jax.random` on the key tree of `make_train_step`).

Tolerances: loss terms atol and rtol 1e-4; parameters after 3 steps rtol 1e-4,
atol 1e-5; gradients rtol 1e-3 and atol 1e-5 or 1% of the leaf's largest
entry, whichever is larger. The 1% is JAX's own spread: on this CPU the
jitted JAX gradient of the 3x3 convs (backbone, FPN, keypoint head)
differs from the same gradient computed without `jit` by up to 0.6% of the
leaf's largest entry, while the port agrees with the un-jitted one to
2.5e-6 of it (which takes JAX ~160 s, too long to run here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.engine import train as jtrain
from detectandtrack_tpu_torch.engine import train as ttrain
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils.params import (jax_params_to_state_dict,
                                                   state_dict_to_jax_params)
from detectandtrack_tpu_torch.utils.synthetic import (make_realistic_tubes,
                                                      train_batch)
from test_golden_hard import _OPTS as HARD_OPTS
from test_torch_slice import _pair, both_cfgs

B, T, G, H, W = 2, 2, 10, 64, 96
LOSS_TOL = 1e-4


def make_batch(seed=0, t=T, mask_size=0):
    """Seeded numpy batch in the train-step contract at t frames:
    realistic GT tubes, 15 keypoints per frame inside them, 3 and 2 valid
    GT rows; with `mask_size`, disc bitmaps and frame validity."""
    return train_batch(np.random.default_rng(seed),
                       make_realistic_tubes(B, G, t, H, W, seed=seed + 1),
                       [3, 2], (H, W), mask_size)


def jax_draws(seed, step, shard=None):
    """The uniforms JAX's train step draws at `step`, as port Draws; with
    `shard`, those of that shard of its `shard_map` step (the JAX CLI's),
    whose key folds the shard index in after the step."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    if shard is not None:
        rng = jax.random.fold_in(rng, shard)
    _, k_anchor, k_prop = jax.random.split(rng, 3)

    def draw(stage, b, n):
        keys = jax.random.split(k_anchor if stage == "rpn" else k_prop, b)
        pairs = [jax.random.split(k) for k in keys]
        return tuple(torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(p[i], (n,))) for p in pairs]))
            for i in (0, 1))

    return draw


def _cfgs(clip, base_lr=0.004):
    """(JAX config, port config) of the golden-hard model."""
    return both_cfgs(opts=HARD_OPTS + ["SOLVER.CLIP_GRAD_NORM", clip,
                                      "SOLVER.BASE_LR", base_lr])


@pytest.fixture(scope="module")
def weights():
    """(jax model, flax params) of the golden-hard model, seeded."""
    cfg, jm, params, _ = _pair(None, HARD_OPTS, (1, T, H, W, 3), seed=5)
    return jm, params


def _port(cfg, params):
    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(params, model))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def jax_grads(weights):
    """JAX's step-0 loss terms, total gradient, and the gradient of the
    Fast R-CNN losses alone."""
    jm, params = weights
    cfg, _ = _cfgs(10.0)
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.RNG_SEED), 0)

    @jax.jit
    def run(p):
        metrics, vjp = jax.vjp(lambda q: jm.apply(
            q, batch["clips"], batch["gt_boxes"], batch["gt_keypoints"],
            batch["gt_valid"], rng, method=jtrain.train_forward)[1], p)
        pick = {k: jnp.zeros(()) for k in metrics}
        total = vjp(dict(pick, loss_total=jnp.ones(())))[0]
        roi = vjp(dict(pick, loss_cls=jnp.ones(()),
                       loss_bbox=jnp.ones(())))[0]
        return metrics, total, roi

    return run(params)


def test_one_step_losses_and_gradients_match_jax(weights, jax_grads):
    _, params = weights
    want_metrics, want_grads, _ = jax_grads
    _, cfg = _cfgs(10.0)
    model = _port(cfg, params)
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_train_step(model, cfg)
    state, metrics = step(state, _torch_batch(make_batch()),
                          jax_draws(cfg.RNG_SEED, 0))
    assert state.step == 1
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    grads = state_dict_to_jax_params(
        {k: p.grad for k, p in model.named_parameters()}, model)
    got = dict(_flat(grads["params"]))
    want = dict(_flat(want_grads["params"]))
    assert set(got) == set(want)
    for k in want:
        atol = max(1e-5, 1e-2 * float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=atol,
                                   err_msg=k)
    # The global-norm trap: conv1 and res2 (frozen) have gradients here.
    assert np.abs(got["backbone/conv1/conv/kernel"]).sum() > 0


def test_box_losses_do_not_reach_the_rpn(weights, jax_grads):
    """The kept proposals carry no gradient: the Fast R-CNN losses give
    the RPN head exactly zero gradient, in the port and in JAX."""
    jm, params = weights
    _, cfg = _cfgs(10.0)
    model = _port(cfg, params)
    batch = _torch_batch(make_batch())
    _, metrics = ttrain.train_forward(
        model, batch["clips"], batch["gt_boxes"], batch["gt_keypoints"],
        batch["gt_valid"], jax_draws(cfg.RNG_SEED, 0))
    rpn = list(model.rpn_head.parameters())
    roi = torch.autograd.grad(metrics["loss_cls"] + metrics["loss_bbox"],
                              rpn, retain_graph=True, allow_unused=True)
    assert all(g is None or not g.any() for g in roi)
    total = torch.autograd.grad(metrics["loss_total"], rpn)
    assert all(g.abs().sum() > 0 for g in total)
    for name, g in _flat(jax_grads[2]["params"]["rpn_head"]):
        assert not g.any(), name


# Unclipped, the golden-hard LR moves the RPN far enough in 2 steps that
# a last-ulp difference flips a sampled proposal and the trajectories
# part; a smaller LR keeps the comparison on one trajectory.
@pytest.mark.parametrize("clip,base_lr", [(10.0, 0.004), (0.0, 0.001)])
def test_three_steps_match_jax_make_train_step(weights, clip, base_lr):
    jm, params = weights
    jcfg, cfg = _cfgs(clip, base_lr)
    jstate = jtrain.create_train_state(jcfg, params)
    jstep = jtrain.make_train_step(jm, jcfg, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    model = _port(cfg, params)
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_train_step(model, cfg)
    batch = _torch_batch(make_batch())
    for i in range(3):
        jstate, jm_metrics = jstep(jstate, jbatch)
        state, metrics = step(state, batch, jax_draws(cfg.RNG_SEED, i))
        for k, v in jm_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=f"{i} {k}")
    got = dict(_flat(state_dict_to_jax_params(model.state_dict(),
                                              model)["params"]))
    want = dict(_flat(jstate.params["params"]))
    start = dict(_flat(params["params"]))
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(want[k], start[k])
    frozen = [k for k in want if k.startswith(("backbone/conv1/",
                                               "backbone/res2_"))]
    assert frozen and all(np.array_equal(got[k], start[k]) for k in frozen)
    assert moved > len(want) // 2
