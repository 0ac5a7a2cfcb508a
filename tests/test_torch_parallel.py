"""The port's data-parallel training step (`parallel/mesh.py`,
`engine/train.make_train_step(mesh=)`) on two gloo ranks on the CPU,
against JAX's `shard_map` step on a 2-device mesh and against the port's
own serial emulation (per-shard gradients, their mean, one update).

The model is tests/test_parallel.py's `_tiny_cfg` (R-18, T=2, f32, 64x64,
one clip per rank) with weight decay off, so JAX's update at step 0 is
-lr x its global gradient and the gradient can be read back from the
parameters it returns. Two ranks are spawned once for the module (this
file run as a script, rendezvous through a file in tmp_path, 2 threads
each, a timeout on every rank); they import no JAX: JAX's per-shard draws
(`fold_in(fold_in(key, step), shard)`) are made here and handed to them as
tensors.

Tolerances: against JAX, those of tests/test_torch_train_step.py for one
step (losses 1e-4; gradients rtol 1e-3 and atol 1e-5 or 1% of the leaf's
largest entry, JAX's own spread between its jitted and un-jitted
gradients); against the serial emulation, tests/test_parallel.py's 2e-5
on the parameters and 1e-4 on the metrics."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
RANK_TIMEOUT = 240          # seconds for the whole spawn
TINY_OPTS = [               # tests/test_parallel.py::_tiny_cfg
    "MODEL.CONV_BODY", "resnet18",
    "MODEL.COMPUTE_DTYPE", "float32",
    "VIDEO.VIDEO_ON", True,
    "VIDEO.NUM_FRAMES", 2,
    "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
    "RPN.PRE_NMS_TOP_N_TRAIN", 64,
    "RPN.POST_NMS_TOP_N_TRAIN", 16,
    "RPN.BATCH_SIZE_PER_IM", 32,
    "FAST_RCNN.BATCH_SIZE_PER_IM", 16,
    "KRCNN.NUM_STACKED_CONVS", 2,
    "KRCNN.CONV_HEAD_DIM", 32,
    "TRAIN.MAX_GT_PER_IM", 2,
    "TEST.DETECTIONS_PER_IM", 4,
    "SOLVER.WARM_UP_ITERS", 0,
    "SOLVER.BASE_LR", 0.01,
    "SOLVER.WEIGHT_DECAY", 0.0,
]


def start_ranks(argv, tmp, n=N_RANKS):
    """Start `n` processes of `python argv...` as ranks 0..n-1 (torchrun's
    environment variables, the repo on PYTHONPATH, output in tmp) →
    wait(timeout): a rank that exits nonzero or outlives the timeout fails
    the test, and every rank still running is killed."""
    procs, logs = [], []
    for rank in range(n):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE=str(n),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(n), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable] + list(argv),
                                      cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        logs.append(log)

    def wait(timeout=RANK_TIMEOUT):
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        for rank, p in enumerate(procs):
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            assert p.returncode == 0, (
                f"rank {rank} exited {p.returncode}:\n{tail}")

    return wait


def _replay(recorded):
    """Draws that hand back `recorded` {stage: (u_fg, u_bg)}."""
    def draw(stage, b, n):
        u_fg, u_bg = recorded[stage]
        assert tuple(u_fg.shape) == (b, n), (stage, u_fg.shape, b, n)
        return u_fg, u_bg
    return draw


def _recording(draws, into):
    def draw(stage, b, n):
        into[stage] = draws(stage, b, n)
        return into[stage]
    return draw


# ----------------------------------------------------------------- ranks


def _rank_main(inputs, out_dir, init_file):
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(2)
    assert pmesh.maybe_init_distributed("cpu", f"file://{init_file}")
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.size, mesh.backend) == (N_RANKS, "gloo")
    data = torch.load(inputs, weights_only=False)
    cfg = load_cfg(opts=data["opts"])
    tensors = {k: {n: torch.from_numpy(v) for n, v in b.items()}
               for k, b in data["batches"].items()}

    def fresh():
        # Rank 0 alone holds the weights; `replicate` must bring them over.
        model = build_model(cfg, device="cpu", seed=17 + mesh.rank,
                            train=True)
        if mesh.rank == 0:
            model.load_state_dict(data["state_dict"])
        pmesh.replicate(mesh, model)
        return model, create_train_state(cfg, model), make_train_step(
            model, cfg, mesh)

    def params(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    out = {"rank": mesh.rank}
    model, state, step = fresh()
    out["replicated"] = params(model)
    state, metrics = step(state, pmesh.shard_batch(mesh, tensors["main"]),
                          _replay(data["draws"][mesh.rank]))
    out["jax_draws"] = {
        "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                  if p.grad is not None},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "params": params(model)}

    model, state, step = fresh()
    state, _ = step(state, pmesh.shard_batch(mesh, tensors["identical"]))
    out["identical"] = params(model)

    runs = []
    for _ in range(2):
        model, state, step = fresh()
        for name in ("main", "second"):
            state, metrics = step(state, pmesh.shard_batch(mesh,
                                                           tensors[name]))
        runs.append((params(model), float(metrics["loss_total"])))
    out["two_step_runs"] = runs
    out["rows"] = pmesh.shard_batch(mesh, {"i": np.arange(6)})["i"]
    out["jax_loaded"] = [m for m in sys.modules
                         if m.split(".")[0] in ("jax", "flax")]
    torch.save(out, os.path.join(out_dir, f"out{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


def _world_of_one(init_file):
    """maybe_init_distributed under DAT_DISTRIBUTED=1 alone: a world of 1."""
    from detectandtrack_tpu_torch.parallel import mesh as pmesh
    from detectandtrack_tpu_torch.utils.env import get_runtime_info
    assert pmesh.maybe_init_distributed("cpu", f"file://{init_file}")
    assert not pmesh.maybe_init_distributed("cpu")     # already up
    mesh = pmesh.make_mesh("cpu")
    x = torch.arange(4.0)
    assert pmesh.pmean(mesh, [x])[0] is x
    info = get_runtime_info()
    print("WORLD", mesh.rank, mesh.size, mesh.backend, info["rank"],
          info["world_size"], info["backend"])
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------- parent


def _serial_step(cfg, state_dict, batch, draws):
    """The port's serial emulation of the sharded step: each row's
    gradient and metrics alone with its shard's draws, their mean, one
    update → (parameters, mean metrics, per-shard gradients)."""
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_optimizer,
                                                        train_forward)
    from detectandtrack_tpu_torch.models.detector import build_model

    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(state_dict)
    state = create_train_state(cfg, model)
    trained = {k: p for k, p in state.params.items() if p.requires_grad}
    grads, metrics = [], []
    for r in range(N_RANKS):
        for p in trained.values():
            p.grad = None
        row = {k: torch.from_numpy(v[r:r + 1]) for k, v in batch.items()}
        total, m = train_forward(model, row["clips"], row["gt_boxes"],
                                 row["gt_keypoints"], row["gt_valid"],
                                 draws[r])
        total.backward()
        grads.append({k: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).clone()
                      for k, p in trained.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    for k, p in trained.items():
        p.grad = sum(g[k] for g in grads) / N_RANKS
    make_optimizer(cfg, model).update(state)
    mean = {k: sum(m[k] for m in metrics) / N_RANKS for k in metrics[0]}
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            mean, grads)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The two ranks' outputs, JAX's mesh step and the serial emulations
    (computed while the ranks run)."""
    import jax

    from detectandtrack_tpu.engine import train as jtrain
    from detectandtrack_tpu.parallel import mesh as jmesh
    from detectandtrack_tpu_torch.engine.train import generator_draws
    from test_parallel import _make_batch
    from test_torch_slice import _pair, both_cfgs
    from test_torch_train_step import jax_draws

    tmp = str(tmp_path_factory.mktemp("ranks"))
    cfg, jm, params, tm = _pair(None, TINY_OPTS, (1, 2, 64, 64, 3))
    k = cfg.KRCNN.NUM_KEYPOINTS
    batches = {name: {key: np.asarray(v) for key, v in _make_batch(
        N_RANKS, 2, k, seed=seed, identical=name == "identical").items()}
        for name, seed in (("main", 0), ("identical", 3), ("second", 7))}
    state_dict = {key: v.clone() for key, v in tm.state_dict().items()}

    # The port's emulation with JAX's per-shard draws, recorded for the
    # ranks.
    recorded = [{} for _ in range(N_RANKS)]
    serial = _serial_step(cfg, state_dict, batches["main"], [
        _recording(jax_draws(cfg.RNG_SEED, 0, shard=r), recorded[r])
        for r in range(N_RANKS)])
    inputs = os.path.join(tmp, "inputs.pt")
    torch.save({"opts": TINY_OPTS, "state_dict": state_dict,
                "batches": batches, "draws": recorded}, inputs)
    ranks_done = start_ranks([os.path.abspath(__file__), "ranks", inputs,
                              tmp, os.path.join(tmp, "rendezvous")], tmp)
    try:
        # JAX's shard_map step on a 2-device mesh, while the ranks run.
        jcfg = both_cfgs(opts=TINY_OPTS)[0]
        mesh = jmesh.make_mesh(N_RANKS)
        jstate = jmesh.replicate(mesh, jtrain.create_train_state(jcfg,
                                                                 params))
        jbatch = jmesh.shard_batch(mesh, {
            key: jax.numpy.asarray(v) for key, v in batches["main"].items()})
        jnew, jmetrics = jtrain.make_train_step(
            jm, jcfg, mesh, donate=False)(jstate, jbatch)
        decorrelated = _serial_step(cfg, state_dict, batches["identical"], [
            generator_draws(cfg.RNG_SEED, 0, r) for r in range(N_RANKS)])
        correlated = _serial_step(cfg, state_dict, batches["identical"], [
            generator_draws(cfg.RNG_SEED, 0, 0) for _ in range(N_RANKS)])
    finally:
        ranks_done()
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(N_RANKS)]
    return {"cfg": cfg, "tm": tm, "params": params,
            "jax_new": jax.tree.map(np.asarray, jnew.params),
            "jax_metrics": {key: float(v) for key, v in jmetrics.items()},
            "serial": serial, "decorrelated": decorrelated,
            "correlated": correlated, "outs": outs,
            "state_dict": state_dict}


def _assert_params_close(got, want, atol=2e-5, rtol=2e-5):
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=atol, rtol=rtol,
                                   msg=key)


def _assert_ranks_equal(outs, *path):
    """The ranks hold the same tensors under `path`, bit for bit."""
    def at(out):
        for key in path:
            out = out[key]
        return out
    first = at(outs[0])
    for out in outs[1:]:
        assert set(at(out)) == set(first)
        for key, v in at(out).items():
            assert torch.equal(v, first[key]), (path, key)


def test_ranks_start_from_rank0_weights_and_import_no_jax(env):
    """`replicate` gives rank 1 (built from another seed) rank 0's weights,
    bit for bit; the ranks never imported JAX or flax."""
    for out in env["outs"]:
        assert out["jax_loaded"] == []
        for key, v in env["state_dict"].items():
            assert torch.equal(out["replicated"][key], v), key


def test_sharded_step_matches_jax_shard_map_step(env):
    """(i) The all-reduced gradient equals JAX's global gradient (its update
    at step 0 over -lr), on both ranks bit for bit alike, and the metrics
    JAX's pmean'd ones."""
    from detectandtrack_tpu_torch.utils.lr_policy import make_schedule
    from detectandtrack_tpu_torch.utils.params import state_dict_to_jax_params
    from test_torch_train_step import LOSS_TOL, _flat

    cfg, tm, outs = env["cfg"], env["tm"], env["outs"]
    _assert_ranks_equal(outs, "jax_draws", "grads")
    lr = make_schedule(cfg.SOLVER)(0)
    start = dict(_flat(env["params"]["params"]))
    new = dict(_flat(env["jax_new"]["params"]))
    want = {k: (start[k].astype(np.float64) - new[k]) / lr for k in start}
    grads = outs[0]["jax_draws"]["grads"]
    zeros = {k: torch.zeros_like(p) for k, p in tm.named_parameters()
             if k not in grads}
    got = dict(_flat(state_dict_to_jax_params(dict(grads, **zeros),
                                              tm)["params"]))
    assert set(got) == set(want)
    frozen = [k for k in want if k.startswith(("backbone/conv1/",
                                               "backbone/res2_"))]
    assert frozen and not any(got[k].any() or want[k].any() for k in frozen)
    for key in want:
        atol = max(1e-5, 1e-2 * float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   atol=atol, err_msg=key)
    for out in outs:
        for key, v in env["jax_metrics"].items():
            np.testing.assert_allclose(out["jax_draws"]["metrics"][key], v,
                                       rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=key)


def test_sharded_step_matches_serial_emulation(env):
    """(ii) Parameters within 2e-5 and metrics within 1e-4 of the port's
    per-shard gradients → mean → one update; both ranks alike."""
    params, metrics, _ = env["serial"]
    outs = env["outs"]
    _assert_ranks_equal(outs, "jax_draws", "params")
    _assert_params_close(outs[0]["jax_draws"]["params"], params)
    for out in outs:
        for key, v in metrics.items():
            np.testing.assert_allclose(out["jax_draws"]["metrics"][key], v,
                                       atol=1e-4, rtol=1e-4, err_msg=key)


def test_per_rank_sampling_is_decorrelated(env):
    """(iii) One clip on both ranks with the default draws: the per-shard
    gradients differ, the step equals the decorrelated emulation and not
    the correlated one (every rank with rank 0's draws)."""
    dec_params, _, per_shard = env["decorrelated"]
    diff = sum(float((a - per_shard[1][k]).abs().sum())
               for k, a in per_shard[0].items())
    assert diff > 0.0
    outs = env["outs"]
    _assert_ranks_equal(outs, "identical")
    _assert_params_close(outs[0]["identical"], dec_params)
    corr_params = env["correlated"][0]
    assert any(not torch.allclose(v, corr_params[k], atol=1e-7, rtol=0)
               for k, v in outs[0]["identical"].items())


def test_two_step_runs_are_bitwise_equal(env):
    """(iv) Two 2-step runs from the same weights and batches: parameters
    and the last loss bit for bit, on each rank and across the ranks."""
    runs = [run for out in env["outs"] for run in out["two_step_runs"]]
    first, loss = runs[0]
    moved = sum(not torch.equal(v, env["state_dict"][k])
                for k, v in first.items())
    assert moved > len(first) // 2
    for params, other_loss in runs[1:]:
        assert other_loss == loss
        for key, v in first.items():
            assert torch.equal(params[key], v), key


def test_shard_batch_gives_each_rank_its_rows(env):
    """(v) Rank r holds rows 3r..3r+2 of a global batch of 6; a batch that
    does not split over the ranks is refused."""
    from detectandtrack_tpu_torch.parallel.mesh import Mesh, shard_batch
    for out in env["outs"]:
        r = out["rank"]
        np.testing.assert_array_equal(out["rows"], np.arange(3 * r,
                                                             3 * r + 3))
    mesh = Mesh(1, 2, torch.device("cpu"))
    assert shard_batch(mesh, {"x": torch.arange(4)})["x"].tolist() == [2, 3]
    assert shard_batch(None, {"x": [5, 6]})["x"] == [5, 6]
    with pytest.raises(ValueError):
        shard_batch(mesh, {"x": np.zeros(3)})


def test_maybe_init_distributed_noop_without_env(monkeypatch):
    """(v) Without torchrun's environment or DAT_DISTRIBUTED it starts
    nothing; the mesh is a world of 1 whose helpers are the identity."""
    from detectandtrack_tpu_torch.parallel import mesh as pmesh
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "DAT_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.maybe_init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    x = {"a": np.arange(3)}
    assert pmesh.gather_batch(mesh, x)["a"] is x["a"]
    model = torch.nn.Linear(2, 2)
    assert pmesh.replicate(mesh, model) is model


def test_maybe_init_distributed_world_of_one(tmp_path):
    """(v) DAT_DISTRIBUTED=1 alone, in a child: a gloo world of 1, which
    `get_runtime_info` reports."""
    env = dict(os.environ, PYTHONPATH=REPO, DAT_DISTRIBUTED="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "world1",
         str(tmp_path / "rendezvous")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WORLD 0 1 gloo 0 1 gloo" in proc.stdout


def test_model_keeps_no_running_statistics(env):
    """Nothing but the parameters needs syncing: the frozen-BN affines are
    parameters, the model has no buffers and no BatchNorm module."""
    tm = env["tm"]
    assert list(tm.buffers()) == []
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in tm.modules())


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _rank_main(*sys.argv[2:])
    else:
        _world_of_one(*sys.argv[2:])
