"""The port's benchmark: inference clips/s with MFU, training steps/s and
streaming per-frame latency, one JSON line per run.

    python -m detectandtrack_tpu_torch.bench [--device cuda|cpu]
    python -m detectandtrack_tpu_torch.cli.launch --mode bench [--device ...]

Port of the repository's root `bench.py` (the JAX package's bench), with its
environment knobs, defaults, configs and JSON keys:

  BENCH_MODE            infer (default), train or stream
  BENCH_BATCH           clips per inference call (4)
  BENCH_ITERS           timed calls or steps (10)
  BENCH_BODY            backbone (resnet50)
  BENCH_T               frames per clip (8)
  BENCH_BUCKET          HxW of the clips (800x1344, the PoseTrack eval shape)
  BENCH_KPS_BUDGET      keypointed detections per clip, 0 = all (0)
  BENCH_SKIP_DEGENERATE 1: the realistic-RoI inference number only
  BENCH_TRAIN_BATCH     clips per training step (1)
  BENCH_STREAM_BATCH    clips per streaming model call (1)
  BENCH_STREAM_FRAMES   frames per synthetic video, two videos (64)

Inference runs the whole graph on deterministic person-shaped proposal
tubes injected after the RPN and its NMS (`detect_with_proposals(run_rpn=
True)`): random weights collapse every proposal to one FPN level, which
would understate RoIAlign. The random-proposal number is kept as the
`*_degenerate` fields.

Every line carries `card`, the card's `nvidia-smi` name and power limit, and
`flops_source`, what the MFU's numerator counts (`utils/flops.py`: model
FLOPs of convolutions, matrix products and the hand kernels, counted in one
untimed call). `mfu_pct` divides by the card's dense peak for the compute
dtype (`utils/roofline.py`); `mfu_peak_dtype` names it. `vs_baseline`
divides by an estimated 0.5 clips/s for the reference's Caffe2 GPU
pipeline, which never published its throughput (`vs_baseline_is_estimate`).

The bench runs on the card; the CPU only when the caller passes
`device="cpu"` (`--device cpu`), and then reports no MFU: a CPU run gives
no device metric. A failure prints one JSON line with `error` and
re-raises, so the exit code is nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .core.config import load_cfg
from .utils import roofline
from .utils.flops import FLOPS_SOURCE, count_flops

CAFFE2_GPU_CLIPS_PER_SEC_ESTIMATE = 0.5

_OUTS = ("boxes", "scores", "valid", "keypoints")   # what a request reads


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: device cuda, but torch finds no CUDA "
                           "device; pass device='cpu' (--device cpu) to run "
                           "on the CPU")
    return device


def _card(device: torch.device) -> str:
    from .utils.env import card_line
    return card_line() if device.type == "cuda" else "cpu (no card)"


# The dense peak each compute dtype is held to: float32 convs may run as
# TF32 on the tensor cores (cuDNN's default), so TF32's rate bounds them.
_PEAK_KIND = {"bfloat16": "bf16", "float32": "tf32"}


def _peak(cfg, device: torch.device) -> Tuple[Optional[float], str]:
    """(FLOP/s, its name) of the card's dense peak for the compute dtype;
    (None, why) on the CPU."""
    if device.type != "cuda":
        return None, "none: a CPU run has no device peak"
    peaks = roofline.peaks_for(torch.cuda.get_device_name(device))
    kind = _PEAK_KIND[cfg.MODEL.COMPUTE_DTYPE]
    rate = peaks.flops(kind)
    return rate, f"{kind}: {rate / 1e12:g} TFLOP/s dense ({peaks.name})"


def _mfu(flops, iters, dt, peak):
    return (round(flops * iters / dt / peak * 100.0, 2)
            if flops and peak else None)


def _timed(fn: Callable, args, iters: int, fetch: Callable) -> float:
    """Double-buffered dispatch/consume loop → seconds in all: call i+1 is
    dispatched before call i is read back to the host, as `run_inference`
    does, and the clock stops after the last read-back."""
    t0 = time.perf_counter()
    pending = fn(*args)
    for _ in range(iters - 1):
        nxt = fn(*args)
        fetch(pending)
        pending = nxt
    fetch(pending)
    return time.perf_counter() - t0


def _bucket() -> Tuple[int, int]:
    bh, bw = (int(x) for x in os.environ.get("BENCH_BUCKET",
                                             "800x1344").split("x"))
    return bh, bw


def infer_cfg():
    """The infer mode's configuration, from the BENCH_* environment."""
    body = os.environ.get("BENCH_BODY", "resnet50")
    t = int(os.environ.get("BENCH_T", "8"))
    bh, bw = _bucket()
    kps_budget = int(os.environ.get("BENCH_KPS_BUDGET", "0"))
    return load_cfg(opts=[
        "MODEL.CONV_BODY", body,
        "VIDEO.VIDEO_ON", t > 1,
        "VIDEO.NUM_FRAMES", t,
        "VIDEO.TIME_KERNEL_DIM", "[3, 3, 3, 3, 1]",
        "TEST.SHAPE_BUCKETS", f"[[{bh}, {bw}]]",
        "TEST.SCORE_THRESH", 0.0,
        "KRCNN.MAX_ROIS_PER_IM", kps_budget,
    ])


def bench_infer(device="cuda") -> Dict:
    """Inference clips/s with MFU at B=BENCH_BATCH on realistic RoIs, and
    on the model's own (degenerate) proposals → the printed line."""
    from .engine.inference import make_detect_fn, read_back
    from .models.detector import build_model
    from .utils.synthetic import make_realistic_tubes

    batch = int(os.environ.get("BENCH_BATCH", "4"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    body = os.environ.get("BENCH_BODY", "resnet50")
    bh, bw = _bucket()
    cfg = infer_cfg()
    t = cfg.VIDEO.NUM_FRAMES
    device = _check_device(device)
    model = build_model(cfg, device=device, seed=0)

    rng = np.random.default_rng(0)
    clips = torch.as_tensor(rng.normal(size=(batch, t, bh, bw, 3)).astype(
        np.float32)).to(device)
    tubes = torch.as_tensor(make_realistic_tubes(
        batch, cfg.RPN.POST_NMS_TOP_N_TEST, t, bh, bw)).to(device)
    detect_realistic = make_detect_fn(model, with_proposals=True,
                                      run_rpn=True)
    detect_degenerate = make_detect_fn(model)

    def fetch(out):
        read_back({k: out[k] for k in _OUTS if k in out})

    flops = count_flops(detect_realistic, clips, tubes)
    fetch(detect_realistic(clips, tubes))              # warm-up
    dt = _timed(detect_realistic, (clips, tubes), iters, fetch)
    clips_per_sec = batch * iters / dt
    peak, peak_name = _peak(cfg, device)

    result = {
        "metric": f"PoseTrack inference clips/sec/chip "
                  f"({body} T={t} {bh}x{bw} b{batch}, realistic RoI mix)",
        "value": round(clips_per_sec, 3),
        "unit": "clips/sec/chip",
        "vs_baseline": round(
            clips_per_sec / CAFFE2_GPU_CLIPS_PER_SEC_ESTIMATE, 2),
        "vs_baseline_is_estimate": True,
        "baseline_denominator_clips_per_sec":
            CAFFE2_GPU_CLIPS_PER_SEC_ESTIMATE,
        "frames_per_sec": round(clips_per_sec * t, 1),
        "mfu_pct": _mfu(flops, iters, dt, peak),
        "mfu_peak_dtype": peak_name,
        "model_tflops_per_clip": round(flops / batch / 1e12, 3),
        "roi_mix": "banded P2/P3/P4/P5=.35/.35/.20/.10 sqrt-area, "
                   "K=%d proposals/clip" % cfg.RPN.POST_NMS_TOP_N_TEST,
        "roi_align_impl": ("csrc/roi_align.cu (K1)" if device.type == "cuda"
                           else "roi_align_multilevel_reference (plain)"),
    }
    if os.environ.get("BENCH_SKIP_DEGENERATE") != "1":
        # The model's own random-weight proposals: one FPN level, which
        # flatters RoIAlign; kept for continuity.
        fetch(detect_degenerate(clips))
        dt_d = _timed(detect_degenerate, (clips,), iters, fetch)
        flops_d = count_flops(detect_degenerate, clips)
        result["clips_per_sec_degenerate"] = round(batch * iters / dt_d, 3)
        result["mfu_pct_degenerate"] = _mfu(flops_d, iters, dt_d, peak)
    result.update(card=_card(device), flops_source=FLOPS_SOURCE)
    print(json.dumps(result), flush=True)
    return result


def bench_train(device="cuda") -> Dict:
    """Training steps/s: the train step (forward, targets, losses,
    backward, clipped SGD) at B=BENCH_TRAIN_BATCH on one seeded synthetic
    batch at the bucket's scale → the printed line."""
    from .engine.train import create_train_state, make_train_step
    from .models.detector import build_model
    from .utils.synthetic import make_realistic_tubes

    batch = int(os.environ.get("BENCH_TRAIN_BATCH", "1"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    body = os.environ.get("BENCH_BODY", "resnet50")
    t = int(os.environ.get("BENCH_T", "8"))
    bh, bw = _bucket()
    cfg = load_cfg(opts=[
        "MODEL.CONV_BODY", body,
        "VIDEO.VIDEO_ON", t > 1,
        "VIDEO.NUM_FRAMES", t,
        "VIDEO.TIME_KERNEL_DIM", "[3, 3, 3, 3, 1]",
        "TRAIN.SCALES", f"[{bh}]",
        "TRAIN.MAX_SIZE", bw,
        # Repeated steps on one batch from random weights: the random RPN
        # gives degenerate tubes with huge bbox targets, and unclipped
        # updates blow the activations up within a few steps. Clipping
        # (the synthetic recipe's knob) and a modest LR keep the loss
        # finite; the clip's global-norm pass is part of the timed step.
        "SOLVER.BASE_LR", "0.0005",
        "SOLVER.CLIP_GRAD_NORM", "10.0",
    ])
    device = _check_device(device)
    model = build_model(cfg, device=device, seed=0, train=True)

    rng = np.random.default_rng(0)
    g = cfg.TRAIN.MAX_GT_PER_IM
    k = cfg.KRCNN.NUM_KEYPOINTS
    clips = rng.normal(size=(batch, t, bh, bw, 3)).astype(np.float32)
    gtb = make_realistic_tubes(batch, g, t, bh, bw, seed=1)
    gtk = rng.uniform(0, min(bh, bw), size=(batch, g, t, k, 3)).astype(
        np.float32)
    gtk[..., 2] = 2.0
    batch_d = {name: torch.as_tensor(v).to(device) for name, v in (
        ("clips", clips), ("gt_boxes", gtb), ("gt_keypoints", gtk),
        ("gt_valid", np.ones((batch, g), bool)))}

    state = create_train_state(cfg, model)
    step_fn = make_train_step(model, cfg)
    probe = list(state.params.values())[-1]      # a head's, always trained

    def _force(metrics) -> float:
        # The loss and one updated parameter read back to the host: the
        # forward/backward chain and the update have run.
        loss = float(metrics["loss_total"])
        probe.detach().reshape(-1)[0].item()
        return loss

    stepped = {}

    def counted_step():
        stepped["out"] = step_fn(state, batch_d)

    flops = count_flops(counted_step)          # one step: fwd, bwd, update
    state = stepped.pop("out")[0]
    state, metrics = step_fn(state, batch_d)   # warm-up
    _force(metrics)

    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step_fn(state, batch_d)
    final_loss = _force(metrics)
    dt = time.perf_counter() - t0

    steps_per_sec = iters / dt
    peak, peak_name = _peak(cfg, device)
    result = {
        "metric": f"PoseTrack TRAIN steps/sec/chip "
                  f"({body} T={t} {bh}x{bw} b{batch})",
        "value": round(steps_per_sec, 3),
        "unit": "steps/sec/chip",
        "clips_per_sec": round(steps_per_sec * batch, 3),
        "mfu_pct": _mfu(flops, iters, dt, peak),
        "mfu_peak_dtype": peak_name,
        "model_tflops_per_step": round(flops / 1e12, 3),
        "loss_total": final_loss,
        "card": _card(device),
        "flops_source": FLOPS_SOURCE,
    }
    print(json.dumps(result), flush=True)
    return result


def warm_latencies_ms(latencies: Dict[Hashable, float],
                      dispatch_log: Dict[Hashable, float],
                      skip: int) -> np.ndarray:
    """The latencies (s) of all frames but the first `skip` by dispatch
    time (at least one frame stays), in ms. Dropping by dispatch order,
    not by magnitude, leaves the tail of the warm frames as it is."""
    by_dispatch = sorted(latencies, key=lambda key: dispatch_log[key])
    keep = by_dispatch[min(skip, max(len(by_dispatch) - 1, 0)):]
    return np.array([latencies[key] for key in keep]) * 1e3


def bench_stream(device="cuda") -> Dict:
    """Streaming (online detect → track) per-frame latency: the real
    `run_inference` path (bucketed batches, double-buffered dispatch and
    read-back, `StreamingTrackingSink` fed while the next batch runs) over
    a synthetic set of two videos at the bucket's resolution; latency is a
    frame's batch dispatch → the frame out of the online sink, p50/p95/p99
    over the frames after the first two batches → the printed line."""
    from .data.posetrack import PosetrackDataset
    from .data.synthetic import generate_synthetic_posetrack
    from .engine.inference import run_inference
    from .models.detector import build_model
    from .tracking.engine import StreamingTrackingSink

    batch = int(os.environ.get("BENCH_STREAM_BATCH", "1"))
    body = os.environ.get("BENCH_BODY", "resnet50")
    t = int(os.environ.get("BENCH_T", "8"))
    frames = int(os.environ.get("BENCH_STREAM_FRAMES", "64"))
    bh, bw = _bucket()
    cfg = load_cfg(opts=[
        "MODEL.CONV_BODY", body,
        "VIDEO.VIDEO_ON", t > 1,
        "VIDEO.NUM_FRAMES", t,
        "VIDEO.TIME_KERNEL_DIM",
        "[3, 3, 3, 1, 1]" if body == "resnet101" else "[3, 3, 3, 3, 1]",
        # The online config's semantics: keypoints for the top detections
        # only, the Hungarian tracker (stream_3d_R101_online.yaml).
        "KRCNN.MAX_ROIS_PER_IM", 20,
        "TRACKING.BIPARTITE_MATCHING_ALGO", "hungarian",
        "TEST.SCALE", bh, "TEST.MAX_SIZE", bw,
        "TEST.SHAPE_BUCKETS", f"[[{bh}, {bw}]]",
    ])
    device = _check_device(device)

    # One set per shape and length, in the temporary directory: a set of
    # another length is never reused.
    data_dir = os.path.join(tempfile.gettempdir(),
                            f"dat_torch_stream_{bh}x{bw}_{frames}f")
    json_path = os.path.join(data_dir, "train.json")
    if not os.path.exists(json_path):
        json_path = generate_synthetic_posetrack(
            data_dir, num_videos=2, frames_per_video=frames,
            image_hw=(bh, bw), people_per_video=3, seed=0)
    ds = PosetrackDataset(json_path, data_dir)
    model = build_model(cfg, device=device, seed=0)

    sink = StreamingTrackingSink(cfg)
    dispatch_log = {}
    latencies = {}

    def timed_sink(vid, ordinal, total, frame):
        # Every frame is covered, so its ordinal is its frame index, the
        # key of its dispatch stamp.
        latencies[(vid, ordinal)] = (
            time.perf_counter() - dispatch_log[(vid, ordinal)])
        sink(vid, ordinal, total, frame)

    t0 = time.perf_counter()
    run_inference(cfg, model, ds, batch_size=batch, frame_sink=timed_sink,
                  dispatch_log=dispatch_log)
    wall = time.perf_counter() - t0
    sink.results()                       # raises unless every video ended

    # The first two batches pay one-off warm-up costs an online deployment
    # pays once: their frames are left out, by dispatch order.
    n_frames = len(latencies)
    warm = warm_latencies_ms(latencies, dispatch_log, 2 * batch * t)
    hw = max(sink.buffer_high_water.values()) if sink.buffer_high_water \
        else 0
    result = {
        "metric": f"PoseTrack STREAM per-frame latency p50 "
                  f"({body} T={t} {bh}x{bw} b{batch}, online track)",
        "value": round(float(np.percentile(warm, 50)), 1),
        "unit": "ms",
        "p95_ms": round(float(np.percentile(warm, 95)), 1),
        "p99_ms": round(float(np.percentile(warm, 99)), 1),
        "max_ms": round(float(warm.max()), 1),
        "frames": n_frames,
        "fps_end_to_end": round(n_frames / wall, 1),
        "sink_buffer_high_water": int(hw),
        "note": "latency = detection-batch dispatch -> tracked frame out "
                "of the online sink; percentiles exclude the first "
                "2 batches' frames by dispatch order (one-off "
                "warm-up cost an online deployment pays once)",
        "card": _card(device),
        "flops_source": "none: the stream line reports no MFU",
    }
    print(json.dumps(result), flush=True)
    return result


_MODES = {"infer": bench_infer, "train": bench_train, "stream": bench_stream}


def main(argv=None) -> int:
    """Run BENCH_MODE (infer, train or stream; anything else is infer, as
    the JAX bench reads it) on `--device` → 0. A failure prints one JSON
    line with `error` and re-raises."""
    p = argparse.ArgumentParser(description="DetectAndTrack bench "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    mode = os.environ.get("BENCH_MODE", "infer")
    try:
        _MODES.get(mode, bench_infer)(args.device)
    except BaseException as e:  # noqa: BLE001 — still print ONE JSON line
        print(json.dumps({
            "metric": "PoseTrack inference clips/sec/chip",
            "value": None,
            "unit": "clips/sec/chip",
            "error": f"{type(e).__name__}: {e}"[:400],
        }), flush=True)
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
