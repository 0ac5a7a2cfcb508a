"""Sharded inference and the multi-process CLI on two gloo ranks on the
CPU, against the one-process runs.

Two ranks are spawned once for the module (this file run as a script,
rendezvous through a file in tmp_path, a timeout on every rank). They run
`run_inference(mesh=)` on the tiny set of tests/test_inference_engine.py's
sharded test (plain, a stream with a sink on each rank, and multi-scale
flip TTA + KPS_AUG), the CLI's `--mode test` and `--mode stream` (which
find the process group up), `--subprocess-shards` (refused), and two
sharded training steps on the `ClipBatcher` plan. The CLI's `--mode train`
runs under torchrun (`python -m torch.distributed.run --standalone
--nproc-per-node 2 -m detectandtrack_tpu_torch.cli.launch`) for 2 steps
and again to 3, resuming. Held: boxes within 1e-4 and scores within 1e-5
absolute or 1e-4 relative of the one-process run (keypoints as boxes),
every frame once, the stream's track ids, the CLI's files equal, rank 0
alone writing, and the CLI's final weights equal to the in-process ranks'
steps."""

import builtins
import filecmp
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import N_RANKS, REPO, start_ranks

INFER_OPTS = [              # tests/test_inference_engine.py's TINY, T=2
    "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
    "RPN.PRE_NMS_TOP_N_TEST", 50, "RPN.POST_NMS_TOP_N_TEST", 16,
    "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
    "TEST.SCALE", 64, "TEST.MAX_SIZE", 96,
    "TEST.SHAPE_BUCKETS", "[[64, 96]]",
    "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 32,
    "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2]
KPS_AUG_OPTS = ["TEST.BBOX_AUG_ENABLED", True, "TEST.BBOX_AUG_SCALES", "[32]",
                "TEST.KPS_AUG_ENABLED", True,
                "TEST.SHAPE_BUCKETS", "[[32, 64], [64, 96]]"]
STREAM_BATCH = 6            # 8 windows → 2 global batches, the last padded
TRAIN_OPTS = [              # the narrow R-18 of the CLI's fine-tuning test
    "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
    "RESNETS.WIDTH_PER_GROUP", 8, "FPN.DIM", 32, "FAST_RCNN.MLP_HEAD_DIM", 64,
    "KRCNN.NUM_STACKED_CONVS", 1, "KRCNN.CONV_HEAD_DIM", 16,
    "TEST.SHAPE_BUCKETS", "[[64, 96]]", "VIDEO.VIDEO_ON", True,
    "VIDEO.NUM_FRAMES", 2, "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
    "RPN.PRE_NMS_TOP_N_TRAIN", 100, "RPN.POST_NMS_TOP_N_TRAIN", 32,
    "RPN.BATCH_SIZE_PER_IM", 32, "FAST_RCNN.BATCH_SIZE_PER_IM", 32,
    "TRAIN.SCALES", "[64]", "TRAIN.MAX_SIZE", 96, "TRAIN.IMS_PER_BATCH", 1,
    "SOLVER.MAX_ITER", 2, "TRAIN.CHECKPOINT_PERIOD", 1,
    "SOLVER.BASE_LR", 0.001, "DATA.NUM_WORKERS", 1,
    "TRAIN.DATASETS", "[posetrack_synthetic_hard_train]"]
CLI_TIMEOUT = 240


def _paths(tmp):
    return {"infer": os.path.join(tmp, "infer"),
            "data": os.path.join(tmp, "data")}


def _cli_opts(tmp):
    return [str(x) for x in INFER_OPTS + [
        "DATA.ROOT", _paths(tmp)["data"],
        "TEST.DATASETS", "[posetrack_synthetic_val]"]]


def _train_opts(tmp, max_iter=2):
    opts = [str(x) for x in TRAIN_OPTS + ["DATA.ROOT", _paths(tmp)["data"]]]
    opts[opts.index("SOLVER.MAX_ITER") + 1] = str(max_iter)
    return opts


# ----------------------------------------------------------------- ranks


def _rank_main(tmp):
    from detectandtrack_tpu_torch.cli.launch import main
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.data.pipeline import ClipBatcher
    from detectandtrack_tpu_torch.data.posetrack import (PosetrackDataset,
                                                         get_dataset)
    from detectandtrack_tpu_torch.engine.inference import run_inference
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.parallel import mesh as pmesh
    from detectandtrack_tpu_torch.tracking.engine import (
        StreamingTrackingSink)

    torch.set_num_threads(2)
    assert pmesh.maybe_init_distributed(
        "cpu", f"file://{os.path.join(tmp, 'rendezvous')}")
    mesh = pmesh.make_mesh("cpu")
    paths = _paths(tmp)
    ds = PosetrackDataset(os.path.join(paths["infer"], "train.json"),
                          paths["infer"])
    out = {}

    def model_for(cfg, **kw):
        # Another seed on rank 1: run_inference broadcasts rank 0's.
        return build_model(cfg, device="cpu", seed=mesh.rank * 9, **kw)

    cfg = load_cfg(opts=INFER_OPTS)
    out["plain"] = run_inference(cfg, model_for(cfg), ds, mesh=mesh)
    sink, sunk = StreamingTrackingSink(cfg=cfg), []

    def recording_sink(*args):
        sunk.append(args[:3])
        sink(*args)

    run_inference(cfg, model_for(cfg), ds, batch_size=STREAM_BATCH,
                  frame_sink=recording_sink, mesh=mesh)
    out["stream"] = sink.results() if sunk else None
    out["sunk"] = sunk
    aug = load_cfg(opts=INFER_OPTS + KPS_AUG_OPTS)
    out["kps_aug"] = run_inference(aug, model_for(aug), ds, mesh=mesh)

    # The CLI on the group already up; rank 1's writes are recorded.
    writes, real_open = [], builtins.open

    def recording_open(file, mode="r", *args, **kw):
        if any(m in mode for m in "wax"):
            writes.append(str(file))
        return real_open(file, mode, *args, **kw)

    if mesh.rank != 0:
        builtins.open = recording_open
    cli = _cli_opts(tmp)
    main(["--mode", "test", "--device", "cpu", "--out",
          os.path.join(tmp, "cli_ranks")] + cli)
    main(["--mode", "stream", "--device", "cpu", "--out",
          os.path.join(tmp, "cli_ranks_stream")] + cli)
    try:
        main(["--mode", "test", "--device", "cpu", "--subprocess-shards",
              "2", "--out", os.path.join(tmp, "refused")] + cli)
        out["refused"] = None
    except SystemExit as e:
        out["refused"] = str(e)
    builtins.open = real_open
    out["writes"] = writes

    # Two sharded steps on the ClipBatcher plan, as the CLI takes them.
    tcfg = load_cfg(opts=_train_opts(tmp))
    model = build_model(tcfg, device="cpu", seed=tcfg.RNG_SEED, train=True)
    state = create_train_state(tcfg, model)
    pmesh.replicate(mesh, state)
    step = make_train_step(model, tcfg, mesh)
    batcher = ClipBatcher(get_dataset("posetrack_synthetic_hard_train",
                                      tcfg.DATA.ROOT), tcfg, train=True,
                          seed=tcfg.RNG_SEED)
    for batch in batcher.epoch(tcfg.TRAIN.IMS_PER_BATCH * mesh.size,
                               mesh=mesh):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        if state.step == tcfg.SOLVER.MAX_ITER:
            break
    out["trained"] = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
    torch.save(out, os.path.join(tmp, f"out{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------- parent


def _torchrun(tmp, name, argv):
    """`--nproc-per-node 2` of the port's CLI under torchrun, each rank's
    output in its own log → (returncode, {rank: its stderr})."""
    logs = os.path.join(tmp, f"logs_{name}")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "DAT_DISTRIBUTED"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(N_RANKS), "--log-dir", logs,
         "--redirects", "3", "-m", "detectandtrack_tpu_torch.cli.launch"]
        + argv, cwd=REPO, env=env, capture_output=True, text=True,
        timeout=CLI_TIMEOUT)
    per_rank = {}
    for path in glob.glob(os.path.join(logs, "**", "stderr.log"),
                          recursive=True):
        with open(path) as f:
            per_rank[int(os.path.basename(os.path.dirname(path)))] = f.read()
    assert proc.returncode == 0, (proc.stderr[-3000:], per_rank)
    assert sorted(per_rank) == list(range(N_RANKS)), per_rank
    return per_rank


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The sets, the two ranks' outputs, the torchrun training runs and
    the one-process counterparts (run while the ranks run)."""
    from detectandtrack_tpu_torch.cli.launch import main
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.data.posetrack import PosetrackDataset
    from detectandtrack_tpu_torch.data.synthetic import (
        generate_synthetic_posetrack)
    from detectandtrack_tpu_torch.engine.inference import run_inference
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.tracking.engine import (
        StreamingTrackingSink)

    tmp = str(tmp_path_factory.mktemp("ranks"))
    paths = _paths(tmp)
    json_path = generate_synthetic_posetrack(
        paths["infer"], num_videos=2, frames_per_video=8,
        image_hw=(64, 96), people_per_video=1, seed=5)
    generate_synthetic_posetrack(
        os.path.join(paths["data"], "synthetic"), num_videos=2,
        frames_per_video=5, image_hw=(64, 96), people_per_video=2, seed=5,
        json_name="val.json")
    generate_synthetic_posetrack(
        os.path.join(paths["data"], "synthetic_hard"), num_videos=2,
        frames_per_video=4, image_hw=(64, 96), seed=3, hard=True)
    ranks_done = start_ranks([os.path.abspath(__file__), tmp], tmp)
    threads = torch.get_num_threads()
    # The ranks' thread count: oneDNN's convs round by it.
    torch.set_num_threads(2)
    try:
        ds = PosetrackDataset(json_path, paths["infer"])
        cfg = load_cfg(opts=INFER_OPTS)
        one = {"plain": run_inference(cfg, build_model(cfg, device="cpu"),
                                      ds)}
        sink = StreamingTrackingSink(cfg=cfg)
        run_inference(cfg, build_model(cfg, device="cpu"), ds,
                      batch_size=STREAM_BATCH, frame_sink=sink)
        one["stream"] = sink.results()
        aug = load_cfg(opts=INFER_OPTS + KPS_AUG_OPTS)
        one["kps_aug"] = run_inference(aug, build_model(aug, device="cpu"),
                                       ds)
        for mode in ("test", "stream"):
            main(["--mode", mode, "--device", "cpu", "--out",
                  os.path.join(tmp, f"cli_one_{mode}")] + _cli_opts(tmp))
        train_logs = _torchrun(tmp, "train", [
            "--mode", "train", "--device", "cpu", "--out",
            os.path.join(tmp, "train")] + _train_opts(tmp))
    finally:
        torch.set_num_threads(threads)
        ranks_done()
    two_steps = os.path.join(tmp, "two_step_final.npz")
    os.replace(os.path.join(tmp, "train", "model_final.npz"), two_steps)
    resume_logs = _torchrun(tmp, "resume", [
        "--mode", "train", "--device", "cpu", "--out",
        os.path.join(tmp, "train")] + _train_opts(tmp, max_iter=3))
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(N_RANKS)]
    return {"tmp": tmp, "ds": ds, "one": one, "outs": outs,
            "train_logs": train_logs, "resume_logs": resume_logs,
            "two_steps": two_steps}


def _assert_dets_close(got, want, keypoints=False):
    """Every frame once; boxes within 1e-4, scores within 1e-5 absolute
    or 1e-4 relative, validity equal (and keypoints as boxes)."""
    assert list(got) == list(want)
    for vid in want:
        assert len(got[vid]) == len(want[vid])
        for g, w in zip(got[vid], want[vid]):
            np.testing.assert_array_equal(g["valid"], w["valid"])
            np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4,
                                       rtol=1e-4)
            np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5,
                                       rtol=1e-4)
            if keypoints:
                np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                           atol=1e-4, rtol=1e-4)


def test_sharded_run_inference_equals_one_process(env):
    ds = env["ds"]
    for out in env["outs"]:
        _assert_dets_close(out["plain"], env["one"]["plain"])
        assert {v: len(f) for v, f in out["plain"].items()} == {
            v: len(ds.video_frames(v)) for v in ds.videos()}


def test_sharded_stream_sinks_on_rank0_only(env):
    """The global batch of 6 over 2 ranks (the last batch padded): rank 0's
    sink receives every frame once and tracks as the one-process stream;
    rank 1's is never called."""
    rank0, rank1 = env["outs"]
    assert rank1["sunk"] == [] and rank1["stream"] is None
    want = env["one"]["stream"]
    n_frames = sum(len(f) for f in want.values())
    assert len(rank0["sunk"]) == len(set(rank0["sunk"])) == n_frames
    _assert_dets_close(rank0["stream"], want)
    for vid in want:
        for g, w in zip(rank0["stream"][vid], want[vid]):
            np.testing.assert_array_equal(g["track_ids"], w["track_ids"])


def test_sharded_kps_aug_equals_one_process(env):
    """Multi-scale flip TTA + KPS_AUG: each rank's heatmaps stay with it,
    the decoded keypoints are gathered."""
    for out in env["outs"]:
        _assert_dets_close(out["kps_aug"], env["one"]["kps_aug"],
                           keypoints=True)


def test_cli_test_and_stream_under_two_ranks(env):
    """`--mode test` and `--mode stream` on the group: the files equal the
    one-process runs' (detections within the tolerance, track files byte
    for byte, metrics equal); rank 1 opened no file for writing."""
    from detectandtrack_tpu_torch.utils.io import load_object
    tmp = env["tmp"]
    ranks, one = (os.path.join(tmp, d) for d in ("cli_ranks",
                                                 "cli_one_test"))
    _assert_dets_close(load_object(os.path.join(ranks, "detections.pkl")),
                       load_object(os.path.join(one, "detections.pkl")))
    with open(os.path.join(ranks, "detection_metrics.json")) as f, open(
            os.path.join(one, "detection_metrics.json")) as g:
        assert json.load(f) == json.load(g)
    ranks, one = (os.path.join(tmp, d, "tracks") for d in (
        "cli_ranks_stream", "cli_one_stream"))
    names = sorted(os.listdir(one))
    assert names and sorted(os.listdir(ranks)) == names
    _, mismatch, errors = filecmp.cmpfiles(ranks, one, names, shallow=False)
    assert not mismatch and not errors
    assert env["outs"][1]["writes"] == []


def test_subprocess_shards_refused_under_two_ranks(env):
    for out in env["outs"]:
        assert out["refused"] and "--subprocess-shards" in out["refused"]
        assert "2 ranks" in out["refused"]
    assert not os.path.exists(os.path.join(env["tmp"], "refused",
                                           "detections.pkl"))


def test_torchrun_train_writes_on_rank0_and_equals_sharded_steps(env):
    """2 steps of `--mode train` under torchrun: one stats line, the
    checkpoints of steps 1 and 2, the final weights logged by rank 0 alone
    and equal to the in-process ranks' 2 steps on the ClipBatcher plan."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.utils.checkpoint import load_weights_npz

    train = os.path.join(env["tmp"], "train")
    logs = env["train_logs"]
    assert "saved final weights" in logs[0]
    assert "saved final weights" not in logs[1]
    assert all("backend gloo" in logs[r] for r in logs)
    with open(os.path.join(train, "training_stats.jsonl")) as f:
        assert len(f.readlines()) == 1
    want = env["outs"][0]["trained"]
    for key, v in env["outs"][1]["trained"].items():
        assert torch.equal(v, want[key]), key
    saved = torch.load(os.path.join(train, "checkpoints", "2.pt"),
                       weights_only=True)
    assert saved["step"] == 2
    for key, v in want.items():
        assert torch.equal(saved["params"][key], v), key
    model = build_model(load_cfg(opts=_train_opts(env["tmp"])),
                        device="cpu", seed=1)
    load_weights_npz(env["two_steps"], model)
    for key, p in model.named_parameters():
        assert torch.equal(p.detach(), want[key]), key


def test_torchrun_train_resumes(env):
    """The rerun to step 3 resumes from step 2 on both ranks, takes one
    step, checkpoints step 3 and writes its weights as the final ones."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.utils.checkpoint import load_weights_npz

    train = os.path.join(env["tmp"], "train")
    for log in env["resume_logs"].values():
        assert "auto-resumed from step 2" in log
    assert sorted(os.listdir(os.path.join(train, "checkpoints"))) == [
        "1.pt", "2.pt", "3.pt"]
    saved = torch.load(os.path.join(train, "checkpoints", "3.pt"),
                       weights_only=True)
    model = build_model(load_cfg(opts=_train_opts(env["tmp"])),
                        device="cpu", seed=1)
    load_weights_npz(os.path.join(train, "model_final.npz"), model)
    for key, p in model.named_parameters():
        assert torch.equal(p.detach(), saved["params"][key]), key


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
