#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`detectandtrack_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each (any failure ends the run with a nonzero exit):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile both CUDA kernels from csrc/ (nvcc, sm_90a);
  3. conv1 kernel against its plain version (F.conv3d) at the main path's
     (2, 8, 800, 1344, 3) t=3 clip and an odd-sized t=1 clip, f32 and bf16;
  4. RoIAlign kernel against its plain version at the box stage (S=16,
     K=300, P=7) and the keypoint stage (K=20, P=14) over the four FPN
     levels of an 800x1344 clip, f32 and bf16, with realistic tubes plus
     degenerate, sub-pixel, out-of-map and 6:1 rois;
  5. the slice at full width: the 3D R-50 T=8 keypoint model in bf16 with
     seeded random weights answers 4 requests of B=2 clips of 8x800x1344
     (3 through detect_with_proposals(run_rpn=True) with realistic tubes,
     1 through the model's own RPN), the launch counters are checked, and
     every clip is tracked; then a small f32 model is held against the
     port's CPU path.
Then it prints the kernels' JSON line, the nvidia-smi card line and, last,
{"ok": true, "device": {...}}. It exits nonzero without a CUDA device.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BF16_REL_TOL = 2.0 ** -6    # bf16 outputs: 4 ulps at the largest |ref| >= 1
F32_TOL = 1e-4              # f32 outputs of magnitude ~1
BOX_CFG = "configs/video/3d_R50_T8_tubes_kps.yaml"


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check(name, got, ref, dtype, torch):
    """Max |got - ref| and whether it is within the stated tolerance."""
    torch.cuda.synchronize()
    if got.shape != ref.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} vs plain "
                           f"{tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        tol = F32_TOL
    else:
        tol = BF16_REL_TOL * max(1.0, ref.float().abs().max().item())
    if not err <= tol:
        raise RuntimeError(f"{name}: max_abs_err {err} > tol {tol}")
    return err, tol


def phase_conv1(torch, results):
    from detectandtrack_tpu_torch.kernels.conv1 import conv1, conv1_reference
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [((2, 8, 800, 1344, 3), 3), ((1, 3, 97, 131, 3), 1)]
    for shape, t in cases:
        x = torch.randn(shape, device="cuda", generator=gen)
        k7 = torch.randn((t, 7, 7, 3, 64), device="cuda", generator=gen) * (
            2.0 / (t * 49 * 64)) ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            got = conv1(x, k7, t, dtype)
            ref = conv1_reference(x, k7, t, dtype)
            name = f"conv1 {shape} t={t} {str(dtype)[6:]}"
            err, tol = _check(name, got, ref, dtype, torch)
            ms = _time_ms(torch, lambda: conv1(x, k7, t, dtype))
            plain_ms = _time_ms(torch, lambda: conv1_reference(x, k7, t,
                                                               dtype))
            print(f"[conv1] {name}: max_abs_err={err:.3g} (tol {tol:.3g}) "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            if shape[0] == 2 and dtype == torch.bfloat16:
                results["conv1"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms)


def _roi_cases(torch, k):
    """(S=16, K, 4) slab rois from realistic tubes with special rois mixed
    in, and their (S, K) levels."""
    from bench import make_realistic_tubes
    from detectandtrack_tpu_torch.kernels.roi_align import assign_fpn_levels
    b, t, h, w = 2, 8, 800, 1344
    tubes = torch.as_tensor(make_realistic_tubes(b, k, t, h, w, seed=k))
    rois = tubes.reshape(b, k, t, 4).permute(0, 2, 1, 3).reshape(b * t, k, 4)
    rois = rois.clone()
    special = torch.tensor([
        [100.0, 100.0, 100.0, 100.0],       # degenerate (zero extent)
        [400.2, 300.1, 400.7, 300.6],       # sub-pixel
        [-300.0, -200.0, -20.0, -10.0],     # wholly outside the map
        [1200.0, 700.0, 1700.0, 1000.0],    # partly outside
        [10.0, 300.0, 610.0, 400.0],        # 6:1, wider than tall
        [500.0, 50.0, 560.0, 410.0],        # 1:6, taller than wide
    ])
    n = min(len(special), k)
    rois[:, :n] = special[:n]
    levels = assign_fpn_levels(rois, 2, 5)
    # Some rois pooled from every level, whatever their size.
    levels[:, n:n + 4] = torch.arange(4, dtype=torch.int32)
    return rois.cuda().contiguous(), levels.cuda().contiguous()


def phase_roi_align(torch, results):
    from detectandtrack_tpu_torch.kernels.roi_align import (
        roi_align_multilevel, roi_align_multilevel_reference)
    gen = torch.Generator(device="cuda").manual_seed(2)
    strides = [4, 8, 16, 32]
    maps32 = [torch.randn((16, 800 // s, 1344 // s, 256), device="cuda",
                          generator=gen) for s in strides]
    for stage, k, p in (("box", 300, 7), ("keypoint", 20, 14)):
        rois, levels = _roi_cases(torch, k)
        for dtype in (torch.float32, torch.bfloat16):
            maps = [m.to(dtype) for m in maps32]
            got = roi_align_multilevel(maps, strides, rois, levels, p, 2)
            ref = roi_align_multilevel_reference(maps, strides, rois, levels,
                                                 p, 2)
            name = f"roi_align {stage} S=16 K={k} P={p} {str(dtype)[6:]}"
            err, tol = _check(name, got, ref, dtype, torch)
            ms = _time_ms(torch, lambda: roi_align_multilevel(
                maps, strides, rois, levels, p, 2))
            plain_ms = _time_ms(torch, lambda: roi_align_multilevel_reference(
                maps, strides, rois, levels, p, 2), iters=3, warmup=1)
            print(f"[roi_align] {name}: max_abs_err={err:.3g} (tol {tol:.3g})"
                  f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            if stage == "box" and dtype == torch.bfloat16:
                results["roi_align"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=plain_ms)
        del maps


def _track(frames_per_clip):
    """Link each clip's frames; → (track ids, detections matched to a
    track of an earlier frame)."""
    from detectandtrack_tpu.tracking.tracker import Tracker, TrackerConfig
    n_tracks, linked = 0, 0
    for frames in frames_per_clip:
        tracker = Tracker(TrackerConfig(score_thresh=0.0))
        seen = set()
        for fr in frames:
            tid = tracker.update(fr["boxes"], fr["scores"], fr["keypoints"],
                                 fr["features"], fr["valid"])
            tid = {int(i) for i in tid if i >= 0}
            linked += len(tid & seen)
            seen |= tid
        n_tracks += len(seen)
    return n_tracks, linked


def phase_slice(torch):
    from bench import make_realistic_tubes
    from detectandtrack_tpu.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.inference import (
        clip_slice, detections_to_frames, make_detect_fn)
    from detectandtrack_tpu_torch.kernels.conv1 import conv1
    from detectandtrack_tpu_torch.kernels.roi_align import roi_align_multilevel
    from detectandtrack_tpu_torch.models.detector import build_model

    cfg = load_cfg(os.path.join(REPO, BOX_CFG))
    b, t, (h, w) = 2, cfg.VIDEO.NUM_FRAMES, cfg.TEST.SHAPE_BUCKETS[0]
    k, d = cfg.RPN.POST_NMS_TOP_N_TEST, cfg.TEST.DETECTIONS_PER_IM
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] model {BOX_CFG} {cfg.MODEL.COMPUTE_DTYPE}, {n_params} "
          f"params, built in {time.perf_counter() - t0:.1f} s", flush=True)
    detect = make_detect_fn(model)
    detect_p = make_detect_fn(model, with_proposals=True, run_rpn=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tubes = torch.as_tensor(make_realistic_tubes(b, k, t, h, w)).cuda()
    requests = [(torch.randn((b, t, h, w, 3), device="cuda", generator=gen),
                 tubes if i < 3 else None) for i in range(4)]

    def run(clips, tb):
        return detect_p(clips, tb) if tb is not None else detect(clips)

    run(*requests[0])                       # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv1.launches = 0
    roi_align_multilevel.launches = 0
    outs, secs = [], []
    for clips, tb in requests:
        t0 = time.perf_counter()
        out = run(clips, tb)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {"conv1": conv1.launches,
                "roi_align": roi_align_multilevel.launches}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"conv1": len(requests), "roi_align": 2 * len(requests)}:
        raise RuntimeError(f"launch counters {launches} for {len(requests)} "
                           "forwards (expected conv1 = forwards, "
                           "roi_align = 2 x forwards)")
    shapes = {"boxes": (b, d, 4 * t), "scores": (b, d), "valid": (b, d),
              "features": (b, d, cfg.FAST_RCNN.MLP_HEAD_DIM),
              "keypoints": (b, d, t, cfg.KRCNN.NUM_KEYPOINTS, 4)}
    n_valid = 0
    for out in outs:
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape:
                raise RuntimeError(f"slice: {key} {tuple(out[key].shape)} "
                                   f"!= {shape}")
            if out[key].is_floating_point() and not torch.isfinite(
                    out[key]).all():
                raise RuntimeError(f"slice: {key} has non-finite values")
        n_valid += int(out["valid"].sum())
    frames = [detections_to_frames(clip_slice(out, i), t, 1.0)
              for out in outs for i in range(b)]
    n_tracks, linked = _track(frames)
    if n_valid == 0 or linked == 0:
        raise RuntimeError(f"slice: {n_valid} valid detections, {linked} "
                           "linked across frames")
    print(f"[slice] {len(requests)} requests of B={b} {t}x{h}x{w}: "
          f"per-request s {[round(s, 4) for s in secs]} "
          f"(median {sorted(secs)[len(secs) // 2]:.4f}); launches {launches};"
          f" peak memory {peak / 2 ** 30:.2f} GiB; {n_valid} valid "
          f"detections; {n_tracks} track ids, {linked} detections linked",
          flush=True)
    return launches


def phase_small_parity(torch):
    """The golden-test model (R-18, T=2, 64x96, f32) on the card — both
    kernels on its path — against the port's CPU path on the same weights
    and clip."""
    from detectandtrack_tpu.core.config import load_cfg
    from detectandtrack_tpu_torch.models.detector import build_model

    cfg = load_cfg(opts=[
        "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
        "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
        "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
        "TEST.SHAPE_BUCKETS", "[[64, 96]]", "KRCNN.NUM_STACKED_CONVS", 2,
        "KRCNN.CONV_HEAD_DIM", 32])
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device="cuda", seed=0)
    clip = torch.as_tensor(np.random.default_rng(42).normal(
        size=(1, 2, 64, 96, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = cpu(clip)
        got = gpu(clip.cuda())
    worst = {}
    for key, tol in (("scores", 1e-4), ("boxes", 1e-2), ("keypoints", 1e-2)):
        valid = ref["valid"]
        if not torch.equal(got["valid"].cpu(), valid):
            raise RuntimeError("small parity: valid masks differ")
        err = (got[key].cpu()[valid] - ref[key][valid]).abs().max().item()
        if not err <= tol:
            raise RuntimeError(f"small parity: {key} err {err} > {tol}")
        worst[key] = err
    print(f"[parity] R-18 T=2 64x96 f32, card vs CPU path on valid rows: "
          f"max_abs_err {worst}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from detectandtrack_tpu_torch.kernels import _build

    card = _card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    for name in ("conv1", "roi_align"):
        _build.load_library(name)
    print(f"[build] conv1 + roi_align built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    results = {}
    phase_conv1(torch, results)
    phase_roi_align(torch, results)
    torch.cuda.empty_cache()
    launches = phase_slice(torch)
    phase_small_parity(torch)

    kernels = [
        {"name": "conv1", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/conv1.cu",
         "replaces": "detectandtrack_tpu/kernels/conv1.py:167",
         "launches": launches["conv1"], **results["conv1"]},
        {"name": "roi_align_multilevel", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/roi_align.cu",
         "replaces": "detectandtrack_tpu/kernels/roi_align.py:477",
         "launches": launches["roi_align"], **results["roi_align"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
