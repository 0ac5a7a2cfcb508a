"""CLI launcher of the port:
`python -m detectandtrack_tpu_torch.cli.launch --cfg ... --mode ...`.

Port of detectandtrack_tpu/cli/launch.py: one entry point that merges the
YAML config and dotted overrides, then runs training (train), the
Detectron weight import (import-weights), dataset inference (test),
stage-2 linking and evaluation (track), scoring of saved tracks (eval),
online detect+track (stream) or the synthetic-data generator (demo-data).
The model runs on `--device` (default `cuda`; `cpu` must be asked for);
with `cuda` and no CUDA device the launcher stops rather than run on the
CPU.

Data parallel, one process per card: under torchrun
(`python -m torch.distributed.run --nproc-per-node N -m
detectandtrack_tpu_torch.cli.launch ...`) the process group starts before
anything touches the card (`parallel.mesh.maybe_init_distributed`; NCCL
where every rank has a card, gloo on the CPU or on a shared card). Train
runs the sharded step on a global batch of TRAIN.IMS_PER_BATCH x ranks;
test and stream shard each global batch (`--batch-size`, by default the
number of ranks) over the ranks. Rank 0 alone writes: training stats,
checkpoints and final weights, detections, tracks and metrics.

Usage:
  launch --cfg ... --mode import-weights --weights detectron.pkl
  launch --cfg ... --mode train [--weights imported_weights.npz]
  launch --cfg ... --mode test --weights model_final.npz [--batch-size N]
                   [--subprocess-shards N]
  launch --cfg ... --mode track [--detections dets.pkl] [--vis]
  launch --cfg ... --mode eval [--detections tracks_dir]
  launch --cfg ... --mode stream --weights model_final.npz [--vis]
  launch --mode demo-data --out data/synthetic
  (--device cpu: run the model on the CPU)

`--weights` takes the JAX package's flat `.npz` (flax naming), so a JAX
`model_final.npz` runs here unchanged, and the port's `model_final.npz`
and `imported_weights.npz` load into the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
from typing import Optional

_NOT_PORTED = {
    # mode → what brings it
    "bench": "the port's bench and its cells are the work of a benchmark "
             "change (ROADMAP.md), not of the port's CLI",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DetectAndTrack launcher "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--cfg", default=None, help="experiment YAML")
    p.add_argument("--mode", required=True,
                   choices=["train", "test", "track", "stream", "eval", "bench",
                            "demo-data", "import-weights"])
    p.add_argument("--weights", default=None,
                   help="npz weights (overrides cfg TRAIN/TEST.WEIGHTS); "
                        "the Detectron .pkl for --mode import-weights")
    p.add_argument("--detections", default=None,
                   help="detections pickle for --mode track; saved-tracks dir "
                        "for --mode eval")
    p.add_argument("--out", default=None, help="output dir override")
    p.add_argument("--max-clips", type=int, default=None,
                   help="limit inference clips (debug)")
    p.add_argument("--video-range", default=None,
                   help="START:END video slice for sharded inference")
    p.add_argument("--det-out", default=None,
                   help="detections pickle path override (test mode)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="clips per model call in test/stream mode, over "
                        "all ranks (default 1, or the number of ranks)")
    p.add_argument("--subprocess-shards", type=int, default=0,
                   help="fan dataset inference (test mode) out over N "
                        "child processes, one video range each")
    p.add_argument("--vis", action="store_true",
                   help="write annotated frames (track/stream mode)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default cuda; no fallback)")
    p.add_argument("opts", nargs="*",
                   help="dotted config overrides: KEY VALUE ...")
    return p.parse_intermixed_args(argv)


def _load_cfg(args):
    from ..core.config import load_cfg
    cfg = load_cfg(args.cfg, args.opts)
    if args.out:
        cfg = dataclasses.replace(cfg, OUTPUT_DIR=args.out)
    return cfg


def _dataset(cfg, names):
    from ..data.posetrack import get_dataset
    if not names:
        raise SystemExit("No dataset configured (TRAIN/TEST.DATASETS)")
    return get_dataset(names[0], cfg.DATA.ROOT)


def _device(args) -> str:
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA device; "
                         "pass --device cpu to run on the CPU")
    return args.device


def _mesh(args, logger):
    """This process's data-parallel mesh on `--device`: a world of 1
    without a process group; under torchrun its rank and backend are
    logged."""
    from ..parallel.mesh import make_mesh
    mesh = make_mesh(_device(args))
    if mesh.backend is not None:
        logger.info("rank %d of %d, backend %s, on %s", mesh.rank, mesh.size,
                    mesh.backend, mesh.device)
    return mesh


def _init_model(cfg, weights: Optional[str], seed: int, device,
                train: bool = False):
    """The port's model on `device`, seeded, with `weights` loaded."""
    from ..models.detector import build_model
    from ..utils.checkpoint import load_weights_npz
    model = build_model(cfg, device=device, seed=seed, train=train)
    if weights:
        load_weights_npz(weights, model)
    return model


def _video_range(args):
    if not args.video_range:
        return None
    lo, hi = args.video_range.split(":")
    return int(lo), int(hi)


def mode_train(args, cfg):
    """SGD on TRAIN.DATASETS from `--weights`/TRAIN.WEIGHTS (or the seeded
    init), resuming from OUTPUT_DIR/checkpoints when TRAIN.AUTO_RESUME;
    checkpoints every TRAIN.CHECKPOINT_PERIOD steps and at MAX_ITER, the
    smoothed losses in OUTPUT_DIR/training_stats.jsonl, the final weights
    in OUTPUT_DIR/model_final.npz (flax naming) → its path.

    Over ranks: every rank restores the same checkpoint, rank 0's state is
    broadcast, each step takes a global batch of IMS_PER_BATCH x ranks (each
    rank decoding its rows), and rank 0 alone writes the files, with every
    rank waiting at each save and at the end."""
    from ..data.pipeline import ClipBatcher, DeviceLoader
    from ..engine.train import create_train_state, make_train_step
    from ..parallel.mesh import barrier, replicate
    from ..utils.checkpoint import (restore_checkpoint, save_checkpoint,
                                    save_weights_npz, wait_for_checkpoints)
    from ..utils.logging_utils import setup_logging
    from ..utils.lr_policy import get_lr_at_iter
    from ..utils.training_stats import TrainingStats

    logger = setup_logging(
        level=logging.DEBUG if cfg.DEBUG else logging.INFO)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    ds = _dataset(cfg, cfg.TRAIN.DATASETS)
    mesh = _mesh(args, logger)
    model = _init_model(cfg, args.weights or cfg.TRAIN.WEIGHTS or None,
                        cfg.RNG_SEED, mesh.device, train=True)
    state = create_train_state(cfg, model)
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "checkpoints")
    if cfg.TRAIN.AUTO_RESUME:
        restored, step = restore_checkpoint(ckpt_dir, state)
        if restored is not None:
            state = restored
            logger.info("auto-resumed from step %d", step)
    replicate(mesh, state)
    writer = mesh.rank == 0

    step_fn = make_train_step(model, cfg, mesh)
    stats = TrainingStats(
        cfg.SOLVER.MAX_ITER,
        jsonl_path=(os.path.join(cfg.OUTPUT_DIR, "training_stats.jsonl")
                    if writer else None))
    batcher = ClipBatcher(ds, cfg, train=True, seed=cfg.RNG_SEED)

    def lr_at(i):
        return get_lr_at_iter(
            i, base_lr=cfg.SOLVER.BASE_LR, policy=cfg.SOLVER.LR_POLICY,
            gamma=cfg.SOLVER.GAMMA, steps=cfg.SOLVER.STEPS,
            warm_up_iters=cfg.SOLVER.WARM_UP_ITERS,
            warm_up_factor=cfg.SOLVER.WARM_UP_FACTOR,
            warm_up_method=cfg.SOLVER.WARM_UP_METHOD)

    def log_metrics(pending_metrics, i):
        # Reads a PREVIOUS step's metrics: `float` waits for the device,
        # and the current step is already dispatched, so the read never
        # leaves the card idle behind the step just queued.
        vals = {k: float(v) for k, v in pending_metrics.items()}
        stats.update_iter_stats(vals, i, lr_at(i))

    def batches():
        """Epoch after epoch through the prefetcher, until closed."""
        while True:
            with DeviceLoader(batcher.epoch(
                    cfg.TRAIN.IMS_PER_BATCH * mesh.size, mesh=mesh),
                    mesh.device, prefetch=cfg.DATA.PREFETCH) as loader:
                yield from loader

    it = state.step
    prev = None                          # (device metrics, iter) 1-step lag
    prev_lr = lr_at(max(it - 1, 0))
    with contextlib.closing(stats), contextlib.closing(batches()) as stream:
        for batch in (stream if it < cfg.SOLVER.MAX_ITER else ()):
            stats.iter_tic()
            state, metrics = step_fn(state, batch)
            if prev is not None:
                log_metrics(*prev)
            prev = (metrics, it)
            stats.iter_toc()
            lr = lr_at(it)
            ratio = (max(lr, prev_lr) / max(min(lr, prev_lr), 1e-12)
                     if prev_lr > 0 else 1.0)
            if lr != prev_lr and ratio >= cfg.SOLVER.LOG_LR_CHANGE_THRESHOLD:
                logger.info("lr change: %.6f -> %.6f at iter %d", prev_lr,
                            lr, it)
            prev_lr = lr
            it += 1
            if it % cfg.TRAIN.CHECKPOINT_PERIOD == 0 or (
                    it >= cfg.SOLVER.MAX_ITER):
                if prev is not None:         # drain before snapshotting
                    log_metrics(*prev)
                    prev = None
                if writer:
                    save_checkpoint(ckpt_dir, state, it)
                barrier(mesh)
            if it >= cfg.SOLVER.MAX_ITER:
                break
        if prev is not None:
            log_metrics(*prev)
    final = os.path.join(cfg.OUTPUT_DIR, "model_final.npz")
    if writer:
        wait_for_checkpoints(ckpt_dir)
        save_weights_npz(final, model)
        logger.info("saved final weights to %s", final)
    barrier(mesh)
    return final


def mode_test(args, cfg):
    """Detect over TEST.DATASETS → OUTPUT_DIR/detections.pkl (or
    `--det-out`), scored unless `--video-range` makes it one shard; over
    ranks, each global batch is sharded and rank 0 writes and scores."""
    from ..engine.inference import run_inference
    from ..utils.io import save_object
    from ..utils.logging_utils import setup_logging
    from ..utils.timer import Timer

    logger = setup_logging()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    ds = _dataset(cfg, cfg.TEST.DATASETS or cfg.TRAIN.DATASETS)
    out = args.det_out or os.path.join(cfg.OUTPUT_DIR, "detections.pkl")
    if args.subprocess_shards and args.subprocess_shards > 1:
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise SystemExit(
                "--subprocess-shards runs its own processes: it cannot run "
                f"under {dist.get_world_size()} ranks (launch one process, "
                "or drop it and let the ranks shard the batches)")
        return _test_in_shards(args, cfg, ds, out, logger)
    mesh = _mesh(args, logger)
    model = _init_model(cfg, args.weights or cfg.TEST.WEIGHTS or None,
                        cfg.RNG_SEED, mesh.device)
    vrange = _video_range(args)
    timer = Timer()
    timer.tic()
    dets = run_inference(cfg, model, ds, batch_size=args.batch_size,
                         max_clips=args.max_clips, video_range=vrange,
                         mesh=mesh)
    dt = timer.toc()
    if mesh.rank != 0:
        return out
    n_frames = sum(len(v) for v in dets.values())
    logger.info("inference over %d frames in %.1fs (%.2f fps)",
                n_frames, dt, n_frames / max(dt, 1e-9))
    save_object(dets, out)
    logger.info("wrote %s", out)
    # A --video-range run is one shard: the full set is scored elsewhere.
    if vrange is None:
        _eval_detections(cfg, ds, dets, logger)
    return out


def _test_in_shards(args, cfg, ds, out, logger):
    """Cross-process fan-out (parity: test_engine.
    multi_gpu_test_net_on_dataset + utils/subprocess.py): each child runs
    `--mode test` over one contiguous video range on the parent's
    `--device`, `--batch-size` and `--weights`; the detections are merged
    by dict union and scored once. Children re-load the experiment from
    `--cfg`, so one is required."""
    from ..utils.io import load_object, save_object
    from ..utils.subprocess_utils import process_in_parallel

    if not args.cfg:
        raise SystemExit("--subprocess-shards requires --cfg (children "
                         "re-parse the experiment YAML)")
    _device(args)                      # the parent stops where a child would
    cmd = [sys.executable, "-m", "detectandtrack_tpu_torch.cli.launch",
           "--mode", "test", "--cfg", args.cfg,
           "--video-range", "{start}:{end}", "--det-out", "{out}",
           "--out", cfg.OUTPUT_DIR, "--device", args.device]
    if args.batch_size is not None:
        cmd += ["--batch-size", str(args.batch_size)]
    if args.weights:
        cmd += ["--weights", args.weights]
    cmd += [str(o) for o in args.opts]
    shard_paths = process_in_parallel(
        "detections", len(ds.videos()), cmd, cfg.OUTPUT_DIR,
        num_workers=args.subprocess_shards)
    dets = {}
    for path in shard_paths:
        dets.update(load_object(path))
    save_object(dets, out)
    logger.info("merged %d shards -> %s", len(shard_paths), out)
    _eval_detections(cfg, ds, dets, logger)
    return out


def _eval_detections(cfg, ds, dets, logger):
    """Dataset-level per-frame detection eval (box AP, keypoint OKS-AP
    [, mask AP]) → OUTPUT_DIR/detection_metrics.json."""
    from ..tracking.evaluation import evaluate_detections
    det_metrics = evaluate_detections(dets, ds, mask_on=cfg.MODEL.MASK_ON)
    logger.info("detection metrics: %s", json.dumps(det_metrics, indent=2))
    with open(os.path.join(cfg.OUTPUT_DIR,
                           "detection_metrics.json"), "w") as f:
        json.dump(det_metrics, f, indent=2)
    return det_metrics


def _gt_by_video(ds, sanitize: bool = False):
    from ..tracking.evaluation import PoseAnnotation
    gt = {}
    for vid in ds.videos():
        frames = [[PoseAnnotation(keypoints=p["keypoints"], box=p["box"],
                                  head_box=p["head_box"],
                                  track_id=p["track_id"])
                   for p in ds.gt_poses(fr)]
                  for fr in ds.video_frames(vid)]
        # The track files' stems are the writer's sanitized video ids.
        gt[vid.replace("/", "_") if sanitize else vid] = frames
    return gt


def _finish_tracking(args, cfg, tracked, logger):
    """Shared tail of track/stream modes: write PoseTrack-format results,
    the annotated frames with `--vis`, evaluate when GT is available →
    OUTPUT_DIR/track_metrics.json."""
    from ..tracking.engine import evaluate_tracking, write_posetrack_results

    out_dir = os.path.join(cfg.OUTPUT_DIR, "tracks")
    paths = write_posetrack_results(tracked, out_dir)
    logger.info("wrote %d track files to %s", len(paths), out_dir)
    if args.vis:
        _write_vis(cfg, tracked, logger)
    try:
        ds = _dataset(cfg, cfg.TEST.DATASETS or cfg.TRAIN.DATASETS)
    except (SystemExit, FileNotFoundError, KeyError):
        ds = None
    if ds is not None:
        metrics = evaluate_tracking(tracked, _gt_by_video(ds),
                                    cfg.KRCNN.NUM_KEYPOINTS)
        summary = {k: v for k, v in metrics.items()
                   if not isinstance(v, list)}
        logger.info("tracking metrics: %s", json.dumps(summary, indent=2))
        with open(os.path.join(cfg.OUTPUT_DIR, "track_metrics.json"),
                  "w") as f:
            json.dump(metrics, f, indent=2)
    return out_dir


def mode_track(args, cfg):
    from ..tracking.engine import run_posetrack_tracking
    from ..utils.io import load_object
    from ..utils.logging_utils import setup_logging

    logger = setup_logging()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    dets = load_object(args.detections or os.path.join(cfg.OUTPUT_DIR,
                                                       "detections.pkl"))
    tracked = run_posetrack_tracking(dets, cfg=cfg)
    return _finish_tracking(args, cfg, tracked, logger)


def mode_eval(args, cfg):
    """Score saved PoseTrack-annolist track files against GT without
    re-running detection or tracking (also takes third-party predictions)
    → OUTPUT_DIR/eval_metrics.json."""
    from ..tracking.engine import evaluate_tracking, read_posetrack_results
    from ..utils.logging_utils import setup_logging

    logger = setup_logging()
    tracks_dir = args.detections or os.path.join(cfg.OUTPUT_DIR, "tracks")
    tracked = read_posetrack_results(tracks_dir)
    ds = _dataset(cfg, cfg.TEST.DATASETS or cfg.TRAIN.DATASETS)
    metrics = evaluate_tracking(tracked, _gt_by_video(ds, sanitize=True),
                                cfg.KRCNN.NUM_KEYPOINTS)
    summary = {k: v for k, v in metrics.items() if not isinstance(v, list)}
    logger.info("eval metrics: %s", json.dumps(summary, indent=2))
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "eval_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def mode_stream(args, cfg):
    """Online detect→track in one pass: every batch read back from the
    device goes straight to the per-video trackers while the next batch
    runs; no detections.pkl in between. Results equal test + track. Over
    ranks, each global batch is sharded and rank 0 tracks and writes."""
    from ..engine.inference import run_inference
    from ..tracking.engine import StreamingTrackingSink
    from ..utils.io import save_object
    from ..utils.logging_utils import setup_logging
    from ..utils.timer import Timer

    logger = setup_logging()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    ds = _dataset(cfg, cfg.TEST.DATASETS or cfg.TRAIN.DATASETS)
    mesh = _mesh(args, logger)
    model = _init_model(cfg, args.weights or cfg.TEST.WEIGHTS or None,
                        cfg.RNG_SEED, mesh.device)
    sink = StreamingTrackingSink(cfg=cfg) if mesh.rank == 0 else None
    timer = Timer()
    timer.tic()
    dets = run_inference(cfg, model, ds, batch_size=args.batch_size,
                         max_clips=args.max_clips,
                         video_range=_video_range(args), frame_sink=sink,
                         mesh=mesh)
    if mesh.rank != 0:
        return None
    tracked = sink.results()
    dt = timer.toc()
    n_frames = sum(len(v) for v in tracked.values())
    logger.info("streamed detect+track over %d frames in %.1fs (%.2f fps)",
                n_frames, dt, n_frames / max(dt, 1e-9))
    if args.det_out:                      # optional detections artifact
        save_object(dets, args.det_out)
        logger.info("wrote %s", args.det_out)
    return _finish_tracking(args, cfg, tracked, logger)


def _write_vis(cfg, tracked, logger):
    """Draw tracked detections over the source frames →
    OUTPUT_DIR/vis/<video>_<frame>.jpg (parity: utils/vis)."""
    import cv2
    from ..utils.vis import draw_detections
    try:
        ds = _dataset(cfg, cfg.TEST.DATASETS or cfg.TRAIN.DATASETS)
    except (SystemExit, FileNotFoundError, KeyError):
        logger.warning("--vis: no dataset available for source frames")
        return
    vis_dir = os.path.join(cfg.OUTPUT_DIR, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    n_written = 0
    for vid, frames in tracked.items():
        recs = ds.video_frames(vid)
        for fi, fr in enumerate(frames):
            if fi >= len(recs):
                break
            img = cv2.imread(ds.image_path(recs[fi]))
            if img is None:
                continue
            img = draw_detections(
                img, fr["boxes"], fr["scores"],
                keypoints=fr.get("keypoints"),
                track_ids=fr["track_ids"],
                valid=fr["track_ids"] >= 0)
            out = os.path.join(vis_dir, f"{vid.replace('/', '_')}_"
                               f"{fi:06d}.jpg")
            cv2.imwrite(out, img)
            n_written += 1
    logger.info("--vis: wrote %d annotated frames to %s", n_written, vis_dir)


def mode_demo_data(args, cfg):
    from ..data.synthetic import generate_synthetic_posetrack
    out = args.out or os.path.join(cfg.DATA.ROOT, "synthetic")
    json_path = generate_synthetic_posetrack(
        out, num_videos=4, frames_per_video=16, people_per_video=2)
    generate_synthetic_posetrack(
        out, num_videos=2, frames_per_video=16, people_per_video=2,
        seed=1, json_name="val.json")
    # Hard variant (separate dirs; see the catalog in data/posetrack.py).
    hard_out = out.rstrip("/") + "_hard"
    generate_synthetic_posetrack(
        hard_out, num_videos=4, frames_per_video=16, seed=0, hard=True)
    generate_synthetic_posetrack(
        hard_out, num_videos=2, frames_per_video=16, seed=1, hard=True,
        json_name="val.json")
    print(f"synthetic dataset written: {json_path} (+val, +hard train/val)")
    return json_path


def mode_import_weights(args, cfg):
    """Detectron .pkl → OUTPUT_DIR/imported_weights.npz for --weights
    (reference weight-loading parity: utils/net.initialize_gpu_from_
    weights_file with 2D→3D inflation and COCO→PoseTrack head surgery).
    The model is built on `--device`; what the .pkl leaves unmapped keeps
    its seeded init."""
    from ..utils.checkpoint import save_weights_npz
    from ..utils.detectron_import import import_detectron_weights
    from ..utils.logging_utils import setup_logging

    logger = setup_logging()
    if not args.weights:
        raise SystemExit("--weights <detectron.pkl> required")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    model = _init_model(cfg, None, cfg.RNG_SEED, _device(args))
    imported, report = import_detectron_weights(args.weights, model, cfg)
    model.load_state_dict(imported)
    out = os.path.join(cfg.OUTPUT_DIR, "imported_weights.npz")
    save_weights_npz(out, model)
    logger.info("mapped %d params (%d surgeries); %d unmatched; "
                "%d source blobs unused", len(report["mapped"]),
                len(report["surgery"]), len(report["missing"]),
                len(report["unused"]))
    for line in report["surgery"]:
        logger.info("surgery: %s", line)
    for line in report["missing"]:
        logger.warning("fresh init kept: %s", line)
    logger.info("wrote %s — pass it via --weights", out)
    return out


_MODES = {"train": mode_train, "test": mode_test, "track": mode_track,
          "stream": mode_stream, "eval": mode_eval,
          "demo-data": mode_demo_data,
          "import-weights": mode_import_weights}


def main(argv=None):
    args = parse_args(argv)
    if args.mode in _NOT_PORTED:
        raise SystemExit(f"--mode {args.mode} is not ported to "
                         f"detectandtrack_tpu_torch: {_NOT_PORTED[args.mode]}")
    # A multi-process launch starts its process group before anything
    # touches the card (a no-op without torchrun's environment).
    import torch.distributed as dist
    from ..parallel.mesh import maybe_init_distributed
    started = maybe_init_distributed(args.device)
    try:
        return _MODES[args.mode](args, _load_cfg(args))
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
