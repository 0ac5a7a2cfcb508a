"""One training step of the model-surface branches against the JAX
package's jitted step on the CPU, at f32 and a small size: the mask head
(MODEL.MASK_ON) and the C4 res5 box head here, RPN_ONLY and center-frame
keypoints in tests/test_torch_surface_train_video.py. Same bridged weights,
one seeded batch, and the very draws JAX's samplers make.

Tolerances as in tests/test_torch_train_step.py: loss terms atol and rtol
1e-4; gradients rtol 1e-3 and atol 1e-5 or 1% of the leaf's largest entry
(the spread of JAX's own jitted gradient on this CPU)."""

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
from test_torch_slice import _pair
from test_torch_train_step import H, W, LOSS_TOL, jax_draws, make_batch

M = 16                      # GT mask bitmap side
MASK_CFG = "configs/video/2d_R50_FPN_mask_kps.yaml"
TRAIN_OPTS = [
    "MODEL.COMPUTE_DTYPE", "float32", "MODEL.CONV_BODY", "resnet18",
    "RESNETS.WIDTH_PER_GROUP", 8,
    "RPN.PRE_NMS_TOP_N_TRAIN", 100, "RPN.POST_NMS_TOP_N_TRAIN", 32,
    "RPN.BATCH_SIZE_PER_IM", 32, "FAST_RCNN.BATCH_SIZE_PER_IM", 32,
    "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 16,
    "KRCNN.TRAIN_MAX_ROIS_PER_IM", 16, "FAST_RCNN.MLP_HEAD_DIM", 64,
    "MRCNN.DIM_REDUCED", 16, "MRCNN.TRAIN_MAX_ROIS_PER_IM", 16,
    "SOLVER.CLIP_GRAD_NORM", 10.0, "SOLVER.BASE_LR", 0.004,
]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def check_one_step(yaml_path, opts, masks=False, seed=5):
    """JAX's jitted loss terms and gradient at step 0 against the port's
    step on the same weights, batch and draws → the port's metrics."""
    cfg, jm, params, _ = _pair(yaml_path, list(TRAIN_OPTS) + list(opts),
                               (1, _frames(yaml_path, opts), H, W, 3),
                               seed=seed)
    t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
    batch = make_batch(t=t, mask_size=M if masks else 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.RNG_SEED), 0)

    @jax.jit
    def run(p):
        def loss(q):
            return jm.apply(q, jbatch["clips"], jbatch["gt_boxes"],
                            jbatch["gt_keypoints"], jbatch["gt_valid"], rng,
                            jbatch.get("gt_masks"),
                            jbatch.get("gt_mask_valid"),
                            method=jtrain.train_forward)
        (_, metrics), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return metrics, grads

    want_metrics, want_grads = run(params)
    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(params, model))
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_train_step(model, cfg)
    state, metrics = step(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        jax_draws(cfg.RNG_SEED, 0))
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    got = dict(_flat(state_dict_to_jax_params(grads, model)["params"]))
    want = dict(_flat(want_grads["params"]))
    assert set(got) == set(want)
    for k in want:
        atol = max(1e-5, 1e-2 * float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=atol,
                                   err_msg=k)
    return model, metrics, got


def _frames(yaml_path, opts):
    from detectandtrack_tpu_torch.core.config import load_cfg
    cfg = load_cfg(yaml_path, opts=list(TRAIN_OPTS) + list(opts))
    return cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1


def test_mask_train_step_matches_jax():
    model, metrics, grads = check_one_step(MASK_CFG, [], masks=True)
    assert float(metrics["loss_mask"]) > 0
    assert np.abs(grads["mask_head/conv5_mask/kernel"]).max() > 0


def test_mask_on_batch_without_masks_trains_the_rest():
    """A MASK_ON batch without gt_masks trains every other loss exactly as
    the same batch with them (same weights and draws; that one is held to
    JAX above) and reports no loss_mask; the mask head takes no
    gradient."""
    cfg, _, params, _ = _pair(MASK_CFG, TRAIN_OPTS, (1, 1, H, W, 3), seed=5)
    runs = []
    for masks in (True, False):
        model = build_model(cfg, device="cpu", train=True)
        model.load_state_dict(jax_params_to_state_dict(params, model))
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in make_batch(
                     t=1, mask_size=M if masks else 0).items()}
        _, metrics = ttrain.make_train_step(model, cfg)(
            ttrain.create_train_state(cfg, model), batch,
            jax_draws(cfg.RNG_SEED, 0))
        runs.append((model, {k: float(v) for k, v in metrics.items()}))
    (_, with_masks), (model, without) = runs
    assert set(without) == set(with_masks) - {"loss_mask"}
    for k, v in without.items():
        want = with_masks[k] - (with_masks["loss_mask"] if k == "loss_total"
                                else 0.0)
        np.testing.assert_allclose(v, want, rtol=1e-6, err_msg=k)
    assert all(p.grad is None or not p.grad.any()
               for p in model.mask_head.parameters())


# The dilated-C5 config differs from C4 only in its res5 head's dilation,
# whose backward tests/test_torch_surface_ops.py holds to JAX.
@pytest.mark.parametrize("yaml_path", ["configs/video/2d_R50_C4_kps.yaml"])
def test_c4_res5_head_train_step_matches_jax(yaml_path):
    """C4 on R-18: a 256-wide res4 into the 1024-wide RPN trunk and the
    res5 box head; res5 of the backbone keeps its parameters and gets a
    zero gradient, as in JAX."""
    model, metrics, grads = check_one_step(yaml_path, [])
    assert not any(np.abs(v).max() > 0 for k, v in grads.items()
                   if k.startswith("backbone/res5_"))
    assert np.abs(grads["box_head/res5_0/b/conv/kernel"]).max() > 0
