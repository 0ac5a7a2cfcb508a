"""The port's evaluation chain on JAX's trained hard-set weights.

`tests/test_golden_hard.py` trains the JAX model 120 steps on the hard
synthetic set and pins its scores. A port training run cannot be held to
those scores: its samplers draw from a torch generator, and 120 chaotic
steps turn any difference into multi-point moves. So this test trains the
JAX model exactly as that test does, carries the trained params into the
port's model (`utils/params.jax_params_to_state_dict`), and runs the
port's `run_inference`, `run_posetrack_tracking` and evaluators on the
same val set. Every metric is held to the JAX run's own scores of the same
weights within `SAME_WEIGHTS_TOL` and to `tests/fixtures/golden_hard.json`
within its band of 1.0.

    python -m pytest tests/test_torch_golden_hard.py -q -m slow
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.core.config import load_cfg as jax_load_cfg
from detectandtrack_tpu.data.pipeline import ClipBatcher
from detectandtrack_tpu.data.posetrack import PosetrackDataset
from detectandtrack_tpu.data.synthetic import generate_synthetic_posetrack
from detectandtrack_tpu.engine import inference as jinf
from detectandtrack_tpu.engine.train import (create_train_state,
                                             make_train_step)
from detectandtrack_tpu.models.detector import build_model as jax_build_model
from detectandtrack_tpu.tracking import engine as jtrack
from detectandtrack_tpu.tracking import evaluation as jeval
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.data.posetrack import (
    PosetrackDataset as PortDataset)
from detectandtrack_tpu_torch.engine.inference import run_inference
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.tracking import engine as ttrack
from detectandtrack_tpu_torch.tracking import evaluation as teval
from detectandtrack_tpu_torch.utils.params import jax_params_to_state_dict
from test_golden_hard import _OPTS, FIXTURE

# Both packages score the same weights on the same frames; they differ
# only in f32 rounding (~1e-6 of a score, ~1e-4 px of a keypoint). That
# can move a detection across TEST.SCORE_THRESH or a keypoint across an
# OKS / PCKh threshold, and one such move on this 16-frame val set shifts
# an AP by a fraction of a point; a fault in the chain moves several.
SAME_WEIGHTS_TOL = 0.5
FIXTURE_TOL = 1.0            # tests/test_golden_hard.py's band


def _sets(root):
    train_json = generate_synthetic_posetrack(
        str(root / "hard"), num_videos=3, frames_per_video=8,
        image_hw=(64, 96), seed=0, hard=True)
    val_json = generate_synthetic_posetrack(
        str(root / "hard"), num_videos=2, frames_per_video=8,
        image_hw=(64, 96), seed=1, hard=True, json_name="val.json",
        video_prefix="val")
    return train_json, val_json


def _train_jax(cfg, train_ds):
    """`test_golden_hard._train_and_score`'s training, step for step."""
    model = jax_build_model(cfg)
    clip = jnp.zeros((1, 2, 64, 96, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(cfg.RNG_SEED), clip)
    state = create_train_state(cfg, params)
    step_fn = make_train_step(model, cfg, donate=False)
    batcher = ClipBatcher(train_ds, cfg, train=True, seed=cfg.RNG_SEED)
    it = 0
    while it < cfg.SOLVER.MAX_ITER:
        for batch in batcher.epoch(cfg.TRAIN.IMS_PER_BATCH):
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            it += 1
            if it >= cfg.SOLVER.MAX_ITER:
                break
    assert np.isfinite(float(metrics["loss_total"]))
    return model, state.params


def _score(dets, val_ds, cfg, tracking, evaluation):
    det = evaluation.evaluate_detections(dets, val_ds)
    tracked = tracking.run_posetrack_tracking(dets, cfg=cfg)
    gt = {vid: [[evaluation.PoseAnnotation(
        keypoints=p["keypoints"], box=p["box"], head_box=p["head_box"],
        track_id=p["track_id"]) for p in val_ds.gt_poses(fr)]
        for fr in val_ds.video_frames(vid)] for vid in val_ds.videos()}
    tr = tracking.evaluate_tracking(tracked, gt, cfg.KRCNN.NUM_KEYPOINTS)
    return {"box_AP": det["box_AP"], "box_AP50": det["box_AP50"],
            "box_AP75": det["box_AP75"], "keypoint_AP": det["keypoint_AP"],
            "mAP": float(tr["mAP"]), "MOTA": float(tr["MOTA"])}


def _both(tmp_path, max_iter):
    """JAX trained `max_iter` steps; → (JAX's scores, the port's scores of
    the same weights)."""
    opts = list(_OPTS) + ["SOLVER.MAX_ITER", max_iter]
    jcfg = jax_load_cfg(opts=opts)
    train_json, val_json = _sets(tmp_path)
    root = str(tmp_path / "hard")
    jmodel, params = _train_jax(jcfg, PosetrackDataset(train_json, root))
    jval = PosetrackDataset(val_json, root)
    jax_scores = _score(jinf.run_inference(jcfg, jmodel, params, jval), jval,
                        jcfg, jtrack, jeval)

    cfg = load_cfg(opts=opts)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params), model))
    val = PortDataset(val_json, root)
    with torch.no_grad():
        dets = run_inference(cfg, model, val)
    return jax_scores, _score(dets, val, cfg, ttrack, teval)


def _held(got, want, tol, what):
    assert set(got) == set(want)
    moved = {k: (got[k], want[k]) for k in want
             if not abs(got[k] - want[k]) <= tol}
    assert not moved, f"port vs {what} beyond {tol}: {moved}"


@pytest.mark.slow
def test_port_scores_jax_trained_hard_weights(tmp_path):
    jax_scores, port_scores = _both(tmp_path, 120)
    print(f"JAX {jax_scores}\nport {port_scores}")
    _held(port_scores, jax_scores, SAME_WEIGHTS_TOL, "JAX on the same weights")
    with open(FIXTURE) as f:
        _held(port_scores, json.load(f), FIXTURE_TOL, "golden_hard.json")

