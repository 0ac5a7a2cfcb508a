"""The port's `--mode train` against the JAX CLI's on the CPU, and resume.

Both CLIs train the small f32 model of tests/test_golden_hard.py (R-18,
T=2, 64x96, IMS_PER_BATCH 2) for 2 steps on one generated hard synthetic
set, from the same seeded `.npz` (`--weights`), checkpointing every step.
The JAX CLI runs its `shard_map` step on a one-device mesh, so its
sampler key at step s is fold_in(fold_in(PRNGKey(seed), s), 0); the port
is given those very draws in place of its torch generator's. Held: the
final weights (`model_final.npz`, rtol 1e-4 and atol 1e-5, the
tolerances of tests/test_torch_train_step.py; frozen stages bit for bit),
the logged losses (1e-4) and keys of `training_stats.jsonl`, and the
checkpointed steps. The port's `model_final.npz` loads into the JAX
package.

The JAX CLI runs once per file (module fixture); its `_init_model` is
given an `eval_shape` template, as in tests/test_torch_cli.py.

Resume: 4 straight steps equal 2 steps, a checkpoint, a restore into a
fresh model and 2 more steps, bit for bit; the CLI resumes from its latest
checkpoint and takes only the remaining steps."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.cli import launch as jlaunch
from detectandtrack_tpu.data.synthetic import generate_synthetic_posetrack
from detectandtrack_tpu.models.detector import build_model as jax_build
from detectandtrack_tpu.parallel import mesh as jmesh
from detectandtrack_tpu.utils.checkpoint import (load_weights_npz as
                                                 jax_load_npz)
from detectandtrack_tpu.utils.checkpoint import (save_weights_npz as
                                                 jax_save_npz)
from detectandtrack_tpu_torch.cli import launch as tlaunch
from detectandtrack_tpu_torch.engine import train as ttrain
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils.checkpoint import (
    latest_checkpoint_step, restore_checkpoint, save_checkpoint,
    wait_for_checkpoints)
from test_golden_hard import _OPTS as HARD_OPTS
from test_torch_slice import _random_params, both_cfgs
from test_torch_train_step import LOSS_TOL, _torch_batch, jax_draws, \
    make_batch

H, W, T = 64, 96, 2
STEPS = 2


def _opts(data):
    """The golden-hard model on the generated set: 2 steps, a checkpoint
    after each."""
    over = {"SOLVER.MAX_ITER": STEPS, "TRAIN.CHECKPOINT_PERIOD": 1}
    opts = []
    for k, v in zip(HARD_OPTS[::2], HARD_OPTS[1::2]):
        opts += [k, over.pop(k, v)]
    opts += [k for kv in over.items() for k in kv]
    return [str(x) for x in opts + [
        "DATA.ROOT", data, "DATA.NUM_WORKERS", 1,
        "TRAIN.DATASETS", "[posetrack_synthetic_hard_train]"]]


def _template(cfg):
    model = jax_build(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, T, H, W, 3), jnp.float32))
    return model, shapes


def _flat_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The set (3 videos of 5 frames at 64x96), the seeded weights, the
    opts, and the JAX CLI's 2-step run."""
    root = tmp_path_factory.mktemp("train")
    data = root / "data"
    generate_synthetic_posetrack(str(data / "synthetic_hard"), num_videos=3,
                                 frames_per_video=5, image_hw=(H, W),
                                 seed=11, hard=True)
    yaml = root / "hard.yaml"
    yaml.write_text("MODEL:\n  TYPE: generalized_rcnn\n")
    opts = ["--cfg", str(yaml)] + _opts(str(data))
    jcfg, cfg = both_cfgs(str(yaml), opts[2:])
    model, shapes = _template(jcfg)
    params = _random_params(
        jax.tree.map(lambda s: tuple(s.shape), shapes,
                     is_leaf=lambda s: hasattr(s, "shape")),
        np.random.default_rng(5))
    weights = str(root / "init.npz")
    jax_save_npz(weights, params)

    def init_from_template(cfg, weights_path, seed=0):
        return model, jax_load_npz(weights_path, _template(cfg)[1])

    one_device = jmesh.make_mesh
    mp = pytest.MonkeyPatch()
    mp.setattr(jlaunch, "_init_model", init_from_template)
    mp.setattr(jmesh, "make_mesh", lambda *a, **k: one_device(1))
    try:
        jlaunch.main(["--mode", "train", "--weights", weights,
                      "--out", str(root / "jax")] + opts)
    finally:
        mp.undo()
    return {"root": root, "weights": weights, "opts": opts, "cfg": cfg,
            "params": params, "jax": root / "jax"}


def _cli_draws(seed, step, shard=0):
    return jax_draws(seed, step, shard=shard)


@pytest.fixture(scope="module")
def port_out(run):
    out = run["root"] / "port"
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "generator_draws", _cli_draws)
    try:
        final = tlaunch.main(["--mode", "train", "--device", "cpu",
                              "--weights", run["weights"], "--out", str(out)]
                             + run["opts"])
    finally:
        mp.undo()
    assert final == str(out / "model_final.npz")
    return out


def _stats(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_train_final_weights_equal_jax(run, port_out):
    got = _flat_npz(port_out / "model_final.npz")
    want = _flat_npz(run["jax"] / "model_final.npz")
    start = _flat_npz(run["weights"])
    assert sorted(got) == sorted(want) == sorted(start)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(want[k], start[k])
    frozen = [k for k in want if k.startswith(("params/backbone/conv1/",
                                               "params/backbone/res2_"))]
    assert frozen and all(np.array_equal(got[k], start[k]) for k in frozen)
    assert moved > len(want) // 2


def test_cli_train_stats_and_checkpoints_equal_jax(run, port_out):
    """One `json_stats` line (iter 0) in each `training_stats.jsonl`, with
    the same keys and the same losses and lr; checkpoints of steps 1 and 2
    in both (orbax step directories in JAX, `<step>.pt` in the port)."""
    got = _stats(port_out / "training_stats.jsonl")
    want = _stats(run["jax"] / "training_stats.jsonl")
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        if k.startswith("loss_") or k == "lr":
            np.testing.assert_allclose(got[0][k], v, rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
        elif k not in ("time", "eta_seconds"):
            assert got[0][k] == v, k
    jsteps = sorted(int(d) for d in os.listdir(run["jax"] / "checkpoints")
                    if d.isdigit())
    assert jsteps == [1, 2]
    assert sorted(os.listdir(port_out / "checkpoints")) == ["1.pt", "2.pt"]
    assert latest_checkpoint_step(str(port_out / "checkpoints")) == STEPS


def test_port_model_final_loads_into_jax(run, port_out):
    jcfg = both_cfgs(run["opts"][1], run["opts"][2:])[0]
    back = jax_load_npz(str(port_out / "model_final.npz"), _template(jcfg)[1])
    got = _flat_npz(port_out / "model_final.npz")
    for path, leaf in jax.tree.flatten_with_path(back)[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), got[name],
                                      err_msg=name)


def test_cli_train_resumes_from_latest_checkpoint(run, port_out, caplog,
                                                  tmp_path):
    """A second `--mode train` to MAX_ITER 3 in the same OUTPUT_DIR logs the
    resume from step 2, takes exactly 1 step and checkpoints step 3; its
    final weights equal the checkpoint's parameters."""
    out = tmp_path / "resume"
    os.makedirs(out / "checkpoints")
    for name in ("1.pt", "2.pt"):
        with open(port_out / "checkpoints" / name, "rb") as f, \
                open(out / "checkpoints" / name, "wb") as g:
            g.write(f.read())
    steps = []
    make = ttrain.make_train_step

    def counting(model, cfg, mesh=None):
        fn = make(model, cfg, mesh)

        def step(state, batch, draws=None):
            steps.append(state.step)
            return fn(state, batch, draws)

        return step

    opts = list(run["opts"])
    opts[opts.index("SOLVER.MAX_ITER") + 1] = "3"
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "make_train_step", counting)
    try:
        with caplog.at_level(logging.INFO):
            tlaunch.main(["--mode", "train", "--device", "cpu", "--weights",
                          run["weights"], "--out", str(out)] + opts)
    finally:
        mp.undo()
    assert "auto-resumed from step 2" in caplog.text
    assert steps == [2]
    assert sorted(os.listdir(out / "checkpoints")) == ["1.pt", "2.pt", "3.pt"]
    saved = torch.load(out / "checkpoints" / "3.pt", weights_only=True)
    assert saved["step"] == 3
    model = build_model(run["cfg"], device="cpu")
    from detectandtrack_tpu_torch.utils.checkpoint import load_weights_npz
    load_weights_npz(str(out / "model_final.npz"), model)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), saved["params"][k], rtol=0,
                                   atol=0, msg=k)


@pytest.mark.parametrize("clip", [10.0, 0.0])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, clip):
    """4 steps straight equal 2 steps, a checkpoint, a restore into a fresh
    model (another seed) and 2 more steps: parameters, momentum and step,
    bit for bit on the CPU, with the default torch-generator draws (the
    golden-hard model, narrowed, on one clip)."""
    cfg = both_cfgs(opts=HARD_OPTS + [
        "SOLVER.CLIP_GRAD_NORM", clip, "RESNETS.WIDTH_PER_GROUP", 8,
        "FPN.DIM", 32, "FAST_RCNN.MLP_HEAD_DIM", 64])[1]
    batch = {k: v[:1] for k, v in _torch_batch(make_batch()).items()}

    def fresh(seed):
        model = build_model(cfg, device="cpu", seed=seed, train=True)
        return model, ttrain.create_train_state(cfg, model), \
            ttrain.make_train_step(model, cfg)

    model_a, state_a, step_a = fresh(0)
    for _ in range(4):
        state_a, _ = step_a(state_a, batch)

    model_b, state_b, step_b = fresh(0)
    for _ in range(2):
        state_b, _ = step_b(state_b, batch)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state_b, state_b.step)
    wait_for_checkpoints(ckpt)
    model_c, state_c, step_c = fresh(1)
    state_c, step = restore_checkpoint(ckpt, state_c)
    assert step == 2 == state_c.step
    for _ in range(2):
        state_c, _ = step_c(state_c, batch)

    assert state_c.step == state_a.step == 4
    assert set(state_c.momentum) == set(state_a.momentum)
    for k in state_a.momentum:
        torch.testing.assert_close(state_c.momentum[k], state_a.momentum[k],
                                   rtol=0, atol=0, msg=k)
    for (k, p), q in zip(model_a.named_parameters(), model_c.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=k)
