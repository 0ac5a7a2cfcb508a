#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`detectandtrack_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each (any failure ends the run with a nonzero exit):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile both CUDA sources from csrc/ (one nvcc each, in
     parallel, sm_90a);
  3. conv1 kernel against its plain version (F.conv3d) at the main path's
     (2, 8, 800, 1344, 3) t=3 clip and an odd-sized t=1 clip, f32 and bf16;
  4. RoIAlign kernel (K1) against its plain version at the box stage (S=16,
     K=300, P=7) and the keypoint stage (K=20, P=14) over the four FPN
     levels of an 800x1344 clip, f32 and bf16, with realistic tubes plus
     degenerate, sub-pixel, out-of-map and 6:1 rois;
  5. K3 (RoIAlign over (roi, slab) pairs): its path, the five entry points
     of kernels/roi_align_ops.py once each at tube-pooling shape with the
     launch counter read; then the kernel against its plain version through
     roi_align_3d (one 8x200x336x256 P2 stack, R=300 realistic tubes, P=7)
     and roi_align_batched (random slabs, the special rois), f32 and bf16;
  6. RoIAlign backward kernel against its plain version (index_add_), on
     the four FPN levels of an 800x1344 clip with S=8: box (K=512, P=7) and
     keypoint (K=64, P=14) stages in K1's layout, and K3's layout on the P2
     stack, f32 and bf16; conv1's autograd Function against the plain
     conv's autograd, f32 with TF32 off;
  7. the inference slice at full width: the 3D R-50 T=8 keypoint model in
     bf16 with seeded random weights answers 4 requests of B=2 clips of
     8x800x1344 (3 through detect_with_proposals(run_rpn=True) with
     realistic tubes, 1 through the model's own RPN), the launch counters
     are checked, and every clip is tracked; then a small f32 model is held
     against the port's CPU path;
  8. the training slice at full width: the same model and config in bf16
     takes 1 warm-up and 3 timed SGD steps on one seeded 8x800x1344 clip
     with seeded GT; losses finite, launch counters (conv1 = steps,
     RoIAlign forward = backward = 2 x steps), FPN and res3+ gradients
     nonzero, parameters moved; then one f32 step of the small R-18 model
     is held against the port's CPU path (losses and every gradient).
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
TRAIN_SMOKE_LR = 1e-4      # SOLVER.BASE_LR of the full-width training phase
GRAD_REL_TOL = 1e-3         # card vs CPU gradients, of each one's max |g|
GRAD_FLOOR = 1e-6           # ... or this much, whichever is larger
SMALL_OPTS = [              # tests/test_golden.py's model: R-18, T=2, f32
    "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
    "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
    "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
    "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
    "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
    "TEST.SHAPE_BUCKETS", "[[64, 96]]", "KRCNN.NUM_STACKED_CONVS", 2,
    "KRCNN.CONV_HEAD_DIM", 32]
# tests/test_golden_hard.py's training settings on that model.
TRAIN_OPTS = SMALL_OPTS + [
    "RPN.PRE_NMS_TOP_N_TRAIN", 100, "RPN.POST_NMS_TOP_N_TRAIN", 32,
    "RPN.BATCH_SIZE_PER_IM", 32, "FAST_RCNN.BATCH_SIZE_PER_IM", 32,
    "TRAIN.IMS_PER_BATCH", 2, "TRAIN.MAX_GT_PER_IM", 10,
    "SOLVER.BASE_LR", 0.004, "SOLVER.STEPS", "[0]",
    "SOLVER.WARM_UP_ITERS", 10, "SOLVER.CLIP_GRAD_NORM", 10.0]


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


SPECIAL_ROIS = [
    [100.0, 100.0, 100.0, 100.0],       # degenerate (zero extent)
    [400.2, 300.1, 400.7, 300.6],       # sub-pixel
    [-300.0, -200.0, -20.0, -10.0],     # wholly outside the map
    [1200.0, 700.0, 1700.0, 1000.0],    # partly outside
    [10.0, 300.0, 610.0, 400.0],        # 6:1, wider than tall
    [500.0, 50.0, 560.0, 410.0],        # 1:6, taller than wide
]


def _roi_cases(torch, k, b=2):
    """(S=8b, K, 4) slab rois from realistic tubes with special rois mixed
    in, and their (S, K) levels."""
    from bench import make_realistic_tubes
    from detectandtrack_tpu_torch.kernels.roi_align import assign_fpn_levels
    t, h, w = 8, 800, 1344
    tubes = torch.as_tensor(make_realistic_tubes(b, k, t, h, w, seed=k))
    rois = tubes.reshape(b, k, t, 4).permute(0, 2, 1, 3).reshape(b * t, k, 4)
    rois = rois.clone()
    special = torch.tensor(SPECIAL_ROIS)
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


def phase_k3(torch, results):
    """K3's path, then K3 against its plain version."""
    from bench import make_realistic_tubes
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels import roi_align_ops as ops
    from detectandtrack_tpu_torch.kernels.roi_align import assign_fpn_levels
    gen = torch.Generator(device="cuda").manual_seed(4)
    t, r, p = 8, 300, 7
    strides = [4, 8, 16, 32]
    pyr32 = [torch.randn((t, 800 // s, 1344 // s, 256), device="cuda",
                         generator=gen) for s in strides]
    tubes = torch.as_tensor(make_realistic_tubes(1, r, t, 800, 1344,
                                                 seed=5)[0]).cuda()
    center = tubes.reshape(r, t, 4)[:, t // 2].contiguous()
    levels = assign_fpn_levels(center, 2, 5)
    slabs = torch.randint(0, t, (r,), device="cuda", generator=gen,
                          dtype=torch.int32)

    # The path: each entry point once, on bf16 maps, counted.
    pyr = [m.to(torch.bfloat16) for m in pyr32]
    ra.roi_align_pairs.launches = 0
    outs = [ops.roi_align(pyr[0][0], center, p, 2, 0.25),
            ops.roi_align_3d(pyr[0], tubes, p, 2, 0.25),
            ops.roi_align_batched(pyr[0], center, slabs, p, 2, 0.25),
            ops.roi_align_multilevel([m[0] for m in pyr], strides, center,
                                     levels, p, 2),
            ops.roi_align_multilevel_batched(pyr, strides, center, levels,
                                             slabs, p, 2)]
    torch.cuda.synchronize()
    launches = ra.roi_align_pairs.launches
    want = [(r, p, p, 256), (r, t, p, p, 256)] + [(r, p, p, 256)] * 3
    if launches != 5 or [tuple(o.shape) for o in outs] != want or not all(
            torch.isfinite(o.float()).all() for o in outs):
        raise RuntimeError(f"k3 path: {launches} launches for 5 entry-point "
                           f"calls, shapes {[tuple(o.shape) for o in outs]}")
    del outs, pyr
    print(f"[k3] path: roi_align, roi_align_3d, roi_align_batched, "
          f"roi_align_multilevel, roi_align_multilevel_batched at R={r}, "
          f"T={t}, 800x1344 bf16: {launches} launches", flush=True)

    # Against the plain version: roi_align_3d at tube-pooling shape, and
    # roi_align_batched on the special rois with random slabs.
    flat = (tubes.reshape(r * t, 4) * 0.25).contiguous()
    frame = torch.arange(t, dtype=torch.int32, device="cuda").repeat(r)
    special = torch.cat([torch.tensor(SPECIAL_ROIS, device="cuda"), center])
    sp_slabs = torch.randint(0, t, (len(special),), device="cuda",
                             generator=gen, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        stack = pyr32[0].to(dtype)
        cases = (
            (f"roi_align_3d P2 8x200x336x256 R={r} P={p}",
             lambda: ops.roi_align_3d(stack, tubes, p, 2, 0.25),
             lambda: ra.roi_align_pairs_reference(
                 [stack], [1], flat, frame, None, p, 2).reshape(
                     r, t, p, p, 256)),
            (f"roi_align_batched special+R={r} random slabs",
             lambda: ops.roi_align_batched(stack, special, sp_slabs, p, 2,
                                           0.25),
             lambda: ra.roi_align_pairs_reference(
                 [stack], [1], special * 0.25, sp_slabs, None, p, 2)))
        for label, kern, plain in cases:
            name = f"k3 {label} {str(dtype)[6:]}"
            err, tol = _check(name, kern(), plain(), dtype, torch)
            ms = _time_ms(torch, kern)
            plain_ms = _time_ms(torch, plain, iters=3, warmup=1)
            print(f"[k3] {name}: max_abs_err={err:.3g} (tol {tol:.3g}) "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            if label.startswith("roi_align_3d") and dtype == torch.bfloat16:
                results["roi_align_k3"] = dict(max_abs_err=err, ms=ms,
                                               plain_ms=plain_ms,
                                               launches=launches)
        del stack


def phase_backward(torch, results):
    """The RoIAlign backward kernel and conv1's autograd Function against
    their plain versions."""
    from bench import make_realistic_tubes
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels.conv1 import (conv1_autograd,
                                                        conv1_reference)
    gen = torch.Generator(device="cuda").manual_seed(5)
    strides = [4, 8, 16, 32]
    shapes = [(8, 800 // s, 1344 // s, 256) for s in strides]
    tubes = torch.as_tensor(make_realistic_tubes(1, 300, 8, 800, 1344,
                                                 seed=6)[0]).cuda()
    cases = []
    for stage, k, p in (("box", 512, 7), ("keypoint", 64, 14)):
        rois, levels = _roi_cases(torch, k, b=1)
        cases.append((f"{stage} S=8 K={k} P={p}", shapes, strides,
                      rois.reshape(-1, 4), ra.slab_of_rows(8, k, "cuda"),
                      levels.reshape(-1), p))
    cases.append(("k3 layout P2 8x200x336x256 R=300 P=7", shapes[:1], [1],
                  (tubes.reshape(-1, 4) * 0.25).contiguous(),
                  torch.arange(8, dtype=torch.int32,
                               device="cuda").repeat(300), None, 7))
    for label, shp, st, rois, slabs, levels, p in cases:
        for dtype in (torch.float32, torch.bfloat16):
            grad = torch.randn((rois.shape[0], p, p, 256), device="cuda",
                               generator=gen).to(dtype)

            def kern():
                return ra.roi_align_backward(shp, dtype, st, rois, slabs,
                                             levels, grad, p, 2)

            def plain():
                return ra.roi_align_backward_reference(
                    shp, dtype, st, rois, slabs, levels, grad, p, 2)

            name = f"roi_align_backward {label} {str(dtype)[6:]}"
            errs = [_check(f"{name} level {i}", g, r, dtype, torch)
                    for i, (g, r) in enumerate(zip(kern(), plain()))]
            err = max(e for e, _ in errs)
            ms = _time_ms(torch, kern)
            plain_ms = _time_ms(torch, plain, iters=3, warmup=1)
            print(f"[backward] {name}: max_abs_err={err:.3g} (tol "
                  f"{min(t for _, t in errs):.3g}) kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms", flush=True)
            if label.startswith("box") and dtype == torch.bfloat16:
                results["roi_align_backward"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms)
            del grad
        torch.cuda.empty_cache()

    x = torch.randn((1, 8, 400, 672, 3), device="cuda", generator=gen)
    k7 = torch.randn((3, 7, 7, 3, 64), device="cuda", generator=gen) * 0.02
    g = torch.randn((1, 8, 200, 336, 64), device="cuda", generator=gen)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ks = [k7.clone().requires_grad_() for _ in range(2)]
    got = torch.autograd.grad(conv1_autograd(xs[0], ks[0], 3, torch.float32),
                              [xs[0], ks[0]], g)
    ref = torch.autograd.grad(conv1_reference(xs[1], ks[1], 3,
                                              torch.float32), [xs[1], ks[1]],
                              g)
    torch.cuda.synchronize()
    errs = []
    for what, a, b in zip(("dx", "dk7"), got, ref):
        err = (a - b).abs().max().item()
        tol = F32_TOL * max(1.0, b.abs().max().item())
        if not err <= tol:
            raise RuntimeError(f"conv1 Function {what}: err {err} > {tol}")
        errs.append(f"{what} {err:.3g} (tol {tol:.3g})")
    print(f"[backward] conv1 Function grads vs plain autograd, (1,8,400,672,3)"
          f" t=3 f32: {', '.join(errs)}", flush=True)


def _train_batch(torch, b, t, h, w, g, n_valid, seed):
    """A seeded batch in the train-step contract: realistic GT tubes, 15
    keypoints per frame inside them, `n_valid` valid GT rows per clip."""
    from bench import make_realistic_tubes
    rng = np.random.default_rng(seed)
    tubes = make_realistic_tubes(b, g, t, h, w, seed=seed)
    box = tubes.reshape(b, g, t, 1, 4)
    u = rng.uniform(size=(b, g, t, 15, 2))
    kps = np.stack([box[..., 0] + u[..., 0] * (box[..., 2] - box[..., 0]),
                    box[..., 1] + u[..., 1] * (box[..., 3] - box[..., 1]),
                    rng.integers(0, 3, size=(b, g, t, 15))], axis=-1)
    valid = np.zeros((b, g), bool)
    valid[:, :n_valid] = True
    return {"clips": torch.from_numpy(rng.standard_normal(
                size=(b, t, h, w, 3), dtype=np.float32)),
            "gt_boxes": torch.from_numpy(tubes),
            "gt_keypoints": torch.from_numpy(kps.astype(np.float32)),
            "gt_valid": torch.from_numpy(valid)}


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

    cfg = load_cfg(opts=SMALL_OPTS)
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


def phase_train(torch):
    """Full-width training steps of the main config through the kernels."""
    from detectandtrack_tpu.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels.conv1 import conv1
    from detectandtrack_tpu_torch.models.detector import build_model

    # With random weights (no pretrained backbone, identity frozen-BN
    # affines) the unclipped config's own BASE_LR 0.005 blows the losses up
    # within three steps (seen at a 64x96 bucket in f32); a smaller LR
    # keeps every loss finite and changes nothing else on the path.
    cfg = load_cfg(os.path.join(REPO, BOX_CFG),
                   opts=["SOLVER.BASE_LR", TRAIN_SMOKE_LR])
    b, t, (h, w) = (cfg.TRAIN.IMS_PER_BATCH, cfg.VIDEO.NUM_FRAMES,
                    cfg.TEST.SHAPE_BUCKETS[0])
    model = build_model(cfg, device="cuda", seed=0, train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    batch = {k: v.cuda() for k, v in _train_batch(
        torch, b, t, h, w, cfg.TRAIN.MAX_GT_PER_IM, 5, seed=7).items()}
    state, _ = step(state, batch)                 # warm-up
    torch.cuda.synchronize()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    torch.cuda.reset_peak_memory_stats()
    conv1.launches = 0
    ra.roi_align_multilevel.launches = 0
    ra.roi_align_backward.launches = 0
    n_steps, secs, losses = 3, [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = {"conv1": conv1.launches,
                "roi_align": ra.roi_align_multilevel.launches,
                "roi_align_backward": ra.roi_align_backward.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"conv1": n_steps, "roi_align": 2 * n_steps,
            "roi_align_backward": 2 * n_steps}
    if launches != want:
        raise RuntimeError(f"train: launch counters {launches}, expected "
                           f"{want} for {n_steps} steps")
    bad = [k for d in losses for k, v in d.items() if not np.isfinite(v)]
    if bad or set(losses[0]) != {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                                 "loss_bbox", "loss_kps", "loss_total"}:
        raise RuntimeError(f"train: loss terms {losses}")
    grads = {k: p.grad for k, p in state.params.items() if p.grad is not None}
    for prefix in ("fpn.", "backbone.res3_", "backbone.res4_",
                   "backbone.res5_", "box_head.", "kps_head.", "rpn_head."):
        keys = [k for k in grads if k.startswith(prefix)]
        if not keys or not any(bool(grads[k].any()) for k in keys):
            raise RuntimeError(f"train: no nonzero gradient under {prefix}")
    frozen = [k for k in state.params
              if k.startswith(("backbone.conv1.", "backbone.res2_"))]
    if any(k in grads for k in frozen) or any(
            not torch.equal(before[k], state.params[k]) for k in frozen):
        raise RuntimeError("train: the frozen stages took an update")
    moved = sum(not torch.equal(before[k], p)
                for k, p in state.params.items())
    if moved < len(state.params) // 2:
        raise RuntimeError(f"train: only {moved} parameters moved")
    print(f"[train] {BOX_CFG} {cfg.MODEL.COMPUTE_DTYPE}, BASE_LR "
          f"{cfg.SOLVER.BASE_LR}, B={b} {t}x{h}x{w}: "
          f"{n_steps} steps after 1 warm-up, step s "
          f"{[round(v, 4) for v in secs]} (median "
          f"{sorted(secs)[len(secs) // 2]:.4f}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}; {moved}/"
          f"{len(state.params)} parameters moved; losses of the last step "
          f"{ {k: round(v, 4) for k, v in losses[-1].items()} }", flush=True)
    del model, state, step, grads, before
    torch.cuda.empty_cache()
    return launches


def phase_train_parity(torch):
    """One f32 step of the small model on the card (conv1 kernel, K1
    forward and backward kernels) against the port's CPU path, with the
    same weights, batch and draws."""
    from detectandtrack_tpu.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.models.detector import build_model

    cfg = load_cfg(opts=TRAIN_OPTS)
    batch = _train_batch(torch, 2, 2, 64, 96, 10, 3, seed=8)
    runs = []
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev, seed=0, train=True)
        state = create_train_state(cfg, model)
        state, metrics = make_train_step(model, cfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {k: p.grad.cpu() for k, p in state.params.items()}))
    (cpu_loss, cpu_grad), (gpu_loss, gpu_grad) = runs
    loss_err = {k: abs(gpu_loss[k] - v) for k, v in cpu_loss.items()}
    if set(gpu_loss) != set(cpu_loss) or not all(
            e <= 1e-4 * max(1.0, abs(cpu_loss[k]))
            for k, e in loss_err.items()):
        raise RuntimeError(f"train parity: losses card {gpu_loss} vs CPU "
                           f"{cpu_loss}")
    worst = (0.0, "")
    for k, g in cpu_grad.items():
        # Relative to the gradient's largest entry, above a floor for the
        # ones that are zero up to rounding (the heatmap deconv's bias).
        rel = ((gpu_grad[k] - g).abs().max().item()
               / max(g.abs().max().item(), GRAD_FLOOR / GRAD_REL_TOL))
        worst = max(worst, (rel, k))
    if not worst[0] <= GRAD_REL_TOL:
        raise RuntimeError(f"train parity: gradient {worst[1]} differs by "
                           f"{worst[0]:.3g} of its max > {GRAD_REL_TOL}")
    print(f"[train-parity] R-18 T=2 64x96 f32, one step, card vs CPU path: "
          f"loss max_abs_err {max(loss_err.values()):.3g} (tol 1e-4); "
          f"{len(cpu_grad)} gradients, worst {worst[1]} at {worst[0]:.3g} of "
          f"its max (tol {GRAD_REL_TOL}, floor {GRAD_FLOOR})", flush=True)


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
    _build.build(["conv1", "roi_align"])
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
    phase_k3(torch, results)
    phase_backward(torch, results)
    torch.cuda.empty_cache()
    inference = phase_slice(torch)
    phase_small_parity(torch)
    torch.cuda.empty_cache()
    launches = phase_train(torch)
    phase_train_parity(torch)
    print(f"[launches] inference slice {inference}; training slice "
          f"{launches}; k3 path {results['roi_align_k3']['launches']}",
          flush=True)

    ra = "detectandtrack_tpu/kernels/roi_align.py"
    k3 = dict(results["roi_align_k3"])
    kernels = [
        {"name": "conv1", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/conv1.cu",
         "replaces": "detectandtrack_tpu/kernels/conv1.py:167",
         "launches": launches["conv1"], **results["conv1"]},
        {"name": "roi_align_multilevel", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/roi_align.cu",
         "replaces": f"{ra}:477",
         "launches": launches["roi_align"], **results["roi_align"]},
        {"name": "roi_align", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/roi_align.cu",
         "replaces": f"{ra}:254", "launches": k3.pop("launches"), **k3},
        {"name": "roi_align_backward", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/roi_align.cu",
         "replaces": f"{ra}:566",
         "launches": launches["roi_align_backward"],
         **results["roi_align_backward"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
