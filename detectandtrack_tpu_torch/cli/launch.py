"""CLI launcher of the port:
`python -m detectandtrack_tpu_torch.cli.launch --cfg ... --mode ...`.

Port of detectandtrack_tpu/cli/launch.py: one entry point that merges the
YAML config and dotted overrides, then runs dataset inference (test),
stage-2 linking and evaluation (track), scoring of saved tracks (eval),
online detect+track (stream) or the synthetic-data generator (demo-data).
The model runs on `--device` (default `cuda`; `cpu` must be asked for);
with `cuda` and no CUDA device the launcher stops rather than run on the
CPU.

Usage:
  launch --cfg ... --mode test --weights model_final.npz [--batch-size N]
  launch --cfg ... --mode track [--detections dets.pkl]
  launch --cfg ... --mode eval [--detections tracks_dir]
  launch --cfg ... --mode stream --weights model_final.npz
  launch --mode demo-data --out data/synthetic
  (--device cpu: run the model on the CPU)

`--weights` takes the JAX package's flat `.npz` (flax naming), so a JAX
`model_final.npz` runs here unchanged.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

_NOT_PORTED = {
    # mode or flag → the ROADMAP.md §1 item that brings it
    "train": "item 3 (the rest of the CLI: mode_train with a torch "
             "prefetcher in place of DeviceLoader)",
    "import-weights": "item 2 (weights: the Detectron .pkl import)",
    "bench": "item 1 (the port's bench)",
    "--subprocess-shards": "item 3 (the rest of the CLI: "
                           "subprocess_utils.py)",
    "--vis": "item 3 (the rest of the CLI: utils/vis.py)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DetectAndTrack launcher "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--cfg", default=None, help="experiment YAML")
    p.add_argument("--mode", required=True,
                   choices=["train", "test", "track", "stream", "eval", "bench",
                            "demo-data", "import-weights"])
    p.add_argument("--weights", default=None,
                   help="npz weights (overrides cfg TEST.WEIGHTS)")
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
    p.add_argument("--batch-size", type=int, default=1,
                   help="clips per model call in test/stream mode")
    p.add_argument("--subprocess-shards", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--vis", action="store_true", help="not ported yet")
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


def _init_model(cfg, weights: Optional[str], seed: int, device: str):
    """The port's model on `device`, seeded, with `weights` loaded."""
    from ..models.detector import build_model
    from ..utils.checkpoint import load_weights_npz
    model = build_model(cfg, device=device, seed=seed)
    if weights:
        load_weights_npz(weights, model)
    return model


def _video_range(args):
    if not args.video_range:
        return None
    lo, hi = args.video_range.split(":")
    return int(lo), int(hi)


def mode_test(args, cfg):
    from ..engine.inference import run_inference
    from ..utils.io import save_object
    from ..utils.logging_utils import setup_logging
    from ..utils.timer import Timer

    logger = setup_logging()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    ds = _dataset(cfg, cfg.TEST.DATASETS or cfg.TRAIN.DATASETS)
    out = args.det_out or os.path.join(cfg.OUTPUT_DIR, "detections.pkl")
    model = _init_model(cfg, args.weights or cfg.TEST.WEIGHTS or None,
                        cfg.RNG_SEED, _device(args))
    vrange = _video_range(args)
    timer = Timer()
    timer.tic()
    dets = run_inference(cfg, model, ds, batch_size=args.batch_size,
                         max_clips=args.max_clips, video_range=vrange)
    dt = timer.toc()
    n_frames = sum(len(v) for v in dets.values())
    logger.info("inference over %d frames in %.1fs (%.2f fps)",
                n_frames, dt, n_frames / max(dt, 1e-9))
    save_object(dets, out)
    logger.info("wrote %s", out)
    # A --video-range run is one shard: the full set is scored elsewhere.
    if vrange is None:
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


def _finish_tracking(cfg, tracked, logger):
    """Shared tail of track/stream modes: write PoseTrack-format results,
    evaluate when GT is available → OUTPUT_DIR/track_metrics.json."""
    from ..tracking.engine import evaluate_tracking, write_posetrack_results

    out_dir = os.path.join(cfg.OUTPUT_DIR, "tracks")
    paths = write_posetrack_results(tracked, out_dir)
    logger.info("wrote %d track files to %s", len(paths), out_dir)
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
    return _finish_tracking(cfg, tracked, logger)


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
    runs; no detections.pkl in between. Results equal test + track."""
    from ..engine.inference import run_inference
    from ..tracking.engine import StreamingTrackingSink
    from ..utils.io import save_object
    from ..utils.logging_utils import setup_logging
    from ..utils.timer import Timer

    logger = setup_logging()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    ds = _dataset(cfg, cfg.TEST.DATASETS or cfg.TRAIN.DATASETS)
    model = _init_model(cfg, args.weights or cfg.TEST.WEIGHTS or None,
                        cfg.RNG_SEED, _device(args))
    sink = StreamingTrackingSink(cfg=cfg)
    timer = Timer()
    timer.tic()
    dets = run_inference(cfg, model, ds, batch_size=args.batch_size,
                         max_clips=args.max_clips,
                         video_range=_video_range(args), frame_sink=sink)
    tracked = sink.results()
    dt = timer.toc()
    n_frames = sum(len(v) for v in tracked.values())
    logger.info("streamed detect+track over %d frames in %.1fs (%.2f fps)",
                n_frames, dt, n_frames / max(dt, 1e-9))
    if args.det_out:                      # optional detections artifact
        save_object(dets, args.det_out)
        logger.info("wrote %s", args.det_out)
    return _finish_tracking(cfg, tracked, logger)


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


_MODES = {"test": mode_test, "track": mode_track, "stream": mode_stream,
          "eval": mode_eval, "demo-data": mode_demo_data}


def main(argv=None):
    args = parse_args(argv)
    asked = [args.mode] + (["--subprocess-shards"]
                           if args.subprocess_shards else []) + (
        ["--vis"] if args.vis else [])
    for what in asked:
        if what in _NOT_PORTED:
            raise SystemExit(f"{what} is not ported to detectandtrack_tpu_torch"
                             f" yet: ROADMAP.md §1 {_NOT_PORTED[what]}")
    return _MODES[args.mode](args, _load_cfg(args))


if __name__ == "__main__":
    main()
