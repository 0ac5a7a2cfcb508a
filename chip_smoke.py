#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`detectandtrack_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each (any failure ends the run with a nonzero exit):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the three native sources from csrc/ (one compiler
     each, in parallel: conv1.cu and roi_align.cu with nvcc for sm_90a,
     the tracker's hungarian.cpp with g++);
  3. conv1 against its plain version (pad + F.conv3d) at the main path's
     (2, 8, 800, 1344, 3) clip at t=3 and t=1 and an odd-sized t=1 clip:
     bf16 through the tensor-core kernel, f32 through the CUDA-core kernel;
     at full size also the CUDA-core kernel on bf16 and one F.conv3d call
     (cuDNN), the bound and the kernel's share of it;
  4. RoIAlign kernel (K1) against its plain version at the box stage (S=16,
     K=300, P=7) and the keypoint stage (K=20, P=14) over the four FPN
     levels of an 800x1344 clip, f32 and bf16, with realistic tubes plus
     degenerate, sub-pixel, out-of-map and 6:1 rois; its bound from the
     distinct map cells those rois touch; K3 on the same rois equal to it
     bit for bit;
  5. K3 (RoIAlign over (roi, slab) pairs): its path, the five entry points
     of kernels/roi_align_ops.py once each at tube-pooling shape with the
     launch counter read; then the kernel against its plain version through
     roi_align_3d (one 8x200x336x256 P2 stack, R=300 realistic tubes, P=7)
     and roi_align_batched (random slabs, the special rois), f32 and bf16;
  6. RoIAlign backward kernel against its plain version (index_add_), on
     the four FPN levels of an 800x1344 clip with S=8: box (K=512, P=7) and
     keypoint (K=64, P=14) stages in K1's layout, and K3's layout on the P2
     stack, f32 and bf16, each with its bound; at the box stage also its
     prep kernel (keys, footprints) equal to the plain rule, two calls
     equal bit for bit, and a call whose output block is handed back from
     a freed NaN-filled one (every cell written); conv1's autograd Function
     against the plain conv's autograd, f32 with TF32 off;
  7. the inference slice at full width: the 3D R-50 T=8 keypoint model in
     bf16 with seeded random weights answers 4 requests of B=2 clips of
     8x800x1344 (3 through detect_with_proposals(run_rpn=True) with
     realistic tubes, 1 through the model's own RPN), the launch counters
     are checked, and every clip is tracked;
  8. the training slice at full width: the same model and config in bf16
     takes 1 warm-up and 3 timed SGD steps on one seeded 8x800x1344 clip
     with seeded GT; losses finite, launch counters (conv1 = steps,
     RoIAlign forward = backward = 2 x steps), FPN and res3+ gradients
     nonzero, parameters moved;
  9. [surface] the rest of the model surface: the kernels against their
     plain versions at the shapes its paths give them, read from the
     configs (conv1 at t=1 on 800x1344; K1 on C4's one 1024-wide
     stride-16 res4 level, P=14, at inference (S=2, K=300) and in
     training (S=2, K=512), the backward at that training shape; K1 on
     the mask stage, P=14); then at full width, bf16, seeded weights, 1
     warm-up and 2 requests of B=2 clips each through C4, dilated C5,
     FPN+masks, soft-NMS + box voting (3D R-50 T=8), center-frame
     keypoints (3D R-18 T=3), RPN-only, and the main config's flip TTA
     (`detect_tta`), and 1 warm-up and 2 training steps each of the mask
     and the C4 configs, each path with the checks of 7 and 8;
 10. parity: small f32 models on the card against the port's CPU path on
     the same weights and inputs: inference of the golden R-18 T=2 model
     and of every new branch (R-18 bodies, 64x96), then one training step
     each of the golden model and of the mask, C4, center-frame and
     RPN-only branches (losses and every gradient).
Then it prints the kernels' JSON line (launches summed over the
full-width paths; conv1's f32 kernel counted over the parity phases, K3 on
its own path, the RoIAlign backward's prep kernel beside its gather; each
with its time, its plain version's, its bound and the
one PyTorch call that computes the same function, where there is one),
the nvidia-smi card line and, last, {"ok": true, "device": {...}}. It exits
nonzero without a CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BF16_REL_TOL = 2.0 ** -6    # bf16 outputs: 4 ulps at the largest |ref| >= 1
F32_TOL = 1e-4              # f32 outputs of magnitude ~1
# One H100 SXM (published dense peaks): bf16 tensor-core and f32 CUDA-core
# peaks, HBM bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
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
C4_CFG = "configs/video/2d_R50_C4_kps.yaml"
MASK_CFG = "configs/video/2d_R50_FPN_mask_kps.yaml"
CENTER_CFG = "configs/video/3d_R18_T3_center_kps.yaml"
RPN_ONLY_CFG = "configs/video/rpn_only_proposals.yaml"
SURFACE_CFGS = [            # (config, flip TTA) of the [surface] phase
    (C4_CFG, False),
    ("configs/video/2d_R50_dilatedC5_kps.yaml", False),
    (MASK_CFG, False),
    ("configs/video/3d_R50_T8_softnms_vote.yaml", False),
    (CENTER_CFG, False),
    (RPN_ONLY_CFG, False),
    (BOX_CFG, True),
]
SURFACE_TRAIN_CFGS = [MASK_CFG, C4_CFG]
# The [surface] phase's small f32 models: R-18 bodies at 64x96, narrow
# heads, small budgets (tests/test_torch_configs.py's sizes).
SURFACE_SMALL_OPTS = [
    "MODEL.CONV_BODY", "resnet18", "RESNETS.WIDTH_PER_GROUP", 8,
    "MODEL.COMPUTE_DTYPE", "float32", "TEST.SHAPE_BUCKETS", "[[64, 96]]",
    "RPN.PRE_NMS_TOP_N_TEST", 128, "RPN.POST_NMS_TOP_N_TEST", 32,
    "TEST.DETECTIONS_PER_IM", 12, "TEST.SCORE_THRESH", 0.0,
    "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 16,
    "FAST_RCNN.MLP_HEAD_DIM", 64, "MRCNN.DIM_REDUCED", 16,
    "RPN.PRE_NMS_TOP_N_TRAIN", 100, "RPN.POST_NMS_TOP_N_TRAIN", 32,
    "RPN.BATCH_SIZE_PER_IM", 32, "FAST_RCNN.BATCH_SIZE_PER_IM", 32,
    "KRCNN.TRAIN_MAX_ROIS_PER_IM", 16, "MRCNN.TRAIN_MAX_ROIS_PER_IM", 16,
    "SOLVER.CLIP_GRAD_NORM", 10.0, "SOLVER.BASE_LR", 0.004]
# Small f32 inference held card vs CPU: (label, config, opts, flip TTA,
# keypoints held end to end everywhere).
PARITY_CASES = [("R-18 T=2 golden", None, SMALL_OPTS, False, True)] + [
    (os.path.basename(path)[:-5] + (" detect_tta" if tta else "") + " R-18",
     path, SURFACE_SMALL_OPTS, tta, False) for path, tta in SURFACE_CFGS]
# Two conv libraries' f32 backward differ by up to 1.9e-2 of a gradient's
# largest entry on these random models: oneDNN vs torch's own convs, both
# on the CPU (the golden model's res4_0 projection), and cuDNN vs both on
# the 3-frame R-18 (conv1, through the t=3 res2 convs' input gradient:
# 1.1e-2), where torch's own convs on the card and the CPU agree to 2e-6.
CROSS_LIBRARY_GRAD_TOL = 2e-2
# Small f32 training steps held card vs CPU: (label, config, opts, the
# gradient bound with cuDNN).
PARITY_TRAIN_CASES = [("R-18 T=2 golden", None, TRAIN_OPTS, GRAD_REL_TOL)] + [
    (os.path.basename(path)[:-5] + " R-18", path, SURFACE_SMALL_OPTS, tol)
    for path, tol in ((MASK_CFG, GRAD_REL_TOL), (C4_CFG, GRAD_REL_TOL),
                      (CENTER_CFG, CROSS_LIBRARY_GRAD_TOL),
                      (RPN_ONLY_CFG, GRAD_REL_TOL))]


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


def _bound(n_bytes, flops, peak_flops):
    """The least time (ms) the card could take, and what sets it."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def _conv1_bound(shape, t, dtype):
    """conv1's bound: x and k7 read once, the output written once; 2 FLOP
    per multiply-add, on the tensor cores in bf16, the CUDA cores in f32."""
    b, nt, h, w, _ = shape
    size = 2 if str(dtype).endswith("bfloat16") else 4
    outs = b * nt * ((h + 1) // 2) * ((w + 1) // 2) * 64
    n_bytes = (b * nt * h * w * 3 + t * 49 * 3 * 64 + outs) * size
    peak = PEAK_BF16_FLOPS if size == 2 else PEAK_F32_FLOPS
    return _bound(n_bytes, 2 * outs * t * 49 * 3, peak)


def phase_conv1(torch, results):
    """conv1 against its plain version: the main path's clip at t=3 and
    t=1 and an odd-sized t=1 clip, bf16 (the tensor-core kernel) and f32
    (the CUDA-core kernel); at the full-size shapes also the CUDA-core
    kernel on bf16 and one F.conv3d call (cuDNN) on the padded input, with
    the bound and the kernel's share of it."""
    import torch.nn.functional as F
    from detectandtrack_tpu_torch.kernels.conv1 import (conv1, conv1_cuda_core,
                                                        conv1_reference)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [((2, 8, 800, 1344, 3), 3), ((2, 1, 800, 1344, 3), 1),
             ((1, 3, 97, 131, 3), 1)]
    for shape, t in cases:
        x = torch.randn(shape, device="cuda", generator=gen)
        k7 = torch.randn((t, 7, 7, 3, 64), device="cuda", generator=gen) * (
            2.0 / (t * 49 * 64)) ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            if t == 1 and shape[2] == 800 and dtype == torch.float32:
                continue
            xd, kd = x.to(dtype), k7.to(dtype)
            got = conv1(xd, kd, t, dtype)
            ref = conv1_reference(xd, kd, t, dtype)
            route = "tensor-core" if dtype == torch.bfloat16 else "CUDA-core"
            name = f"conv1 {shape} t={t} {str(dtype)[6:]} ({route} kernel)"
            err, tol = _check(name, got, ref, dtype, torch)
            del got, ref
            ms = _time_ms(torch, lambda: conv1(xd, kd, t, dtype))
            plain_ms = _time_ms(torch, lambda: conv1_reference(xd, kd, t,
                                                               dtype))
            line = (f"[conv1] {name}: max_abs_err={err:.3g} (tol {tol:.3g}) "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if shape[2] == 800:
                xp = F.pad(xd.permute(0, 4, 1, 2, 3),
                           (3, 3, 3, 3, (t - 1) // 2, t // 2)).contiguous()
                wt = kd.permute(4, 3, 0, 1, 2).contiguous()
                library_ms = _time_ms(torch, lambda: F.conv3d(
                    xp, wt, stride=(1, 2, 2)))
                del xp
                bound_ms, bound_by = _conv1_bound(shape, t, dtype)
                line += (f", F.conv3d {library_ms:.3f} ms; bound "
                         f"{bound_ms:.3f} ms ({bound_by}), "
                         f"{100 * bound_ms / ms:.1f}% of it")
                if dtype == torch.bfloat16:
                    cc_ms = _time_ms(torch, lambda: conv1_cuda_core(
                        xd, kd, t, dtype))
                    line += f"; CUDA-core kernel on bf16 {cc_ms:.3f} ms"
                if t == 3:
                    key = "conv1" if dtype == torch.bfloat16 else "conv1_f32"
                    results[key] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by,
                                        library_ms=library_ms)
            print(line, flush=True)
            del xd
        del x


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
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
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


def _roi_align_bound(torch, shapes, strides, rois, slabs, levels, p,
                     dtype):
    """K1's / K3's bound, from this run's rois: the distinct map cells
    their samples' bilinear corners need (nonzero weight), each read once,
    the rois and levels, and the output written once; 2 FLOP per corner of
    each sample, on the CUDA cores."""
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    taps = ra._taps(shapes, strides, rois.cpu().float(), slabs.cpu(),
                    levels.cpu(), p, 2)
    cells = torch.unique(torch.cat([idx[w != 0] for idx, w in taps]))
    n, c = rois.shape[0], shapes[0][3]
    size = 2 if dtype == torch.bfloat16 else 4
    n_bytes = (cells.numel() + n * p * p) * c * size + n * 5 * 4
    return _bound(n_bytes, n * p * p * c * 4 * 4 * 2, PEAK_F32_FLOPS)


def phase_roi_align(torch, results):
    """K1 against its plain version at the box and keypoint stages, with
    its bound; K3 on the same rois (as (roi, slab) pairs) equal to K1 bit
    for bit."""
    from detectandtrack_tpu_torch.kernels.roi_align import (
        roi_align_multilevel, roi_align_multilevel_reference, roi_align_pairs,
        slab_of_rows)
    gen = torch.Generator(device="cuda").manual_seed(2)
    strides = [4, 8, 16, 32]
    maps32 = [torch.randn((16, 800 // s, 1344 // s, 256), device="cuda",
                          generator=gen) for s in strides]
    shapes = [tuple(m.shape) for m in maps32]
    for stage, k, p in (("box", 300, 7), ("keypoint", 20, 14)):
        rois, levels = _roi_cases(torch, k)
        slabs = slab_of_rows(16, k, "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            maps = [m.to(dtype) for m in maps32]
            got = roi_align_multilevel(maps, strides, rois, levels, p, 2)
            ref = roi_align_multilevel_reference(maps, strides, rois, levels,
                                                 p, 2)
            name = f"roi_align {stage} S=16 K={k} P={p} {str(dtype)[6:]}"
            err, tol = _check(name, got, ref, dtype, torch)
            k3 = roi_align_pairs(maps, strides, rois.reshape(-1, 4), slabs,
                                 levels.reshape(-1), p, 2)
            if not torch.equal(k3.reshape(got.shape), got):
                raise RuntimeError(f"{name}: K3 differs from K1 on the same "
                                   "rois")
            del got, ref, k3
            ms = _time_ms(torch, lambda: roi_align_multilevel(
                maps, strides, rois, levels, p, 2))
            plain_ms = _time_ms(torch, lambda: roi_align_multilevel_reference(
                maps, strides, rois, levels, p, 2), iters=3, warmup=1)
            bound_ms, bound_by = _roi_align_bound(
                torch, shapes, strides, rois.reshape(-1, 4), slabs,
                levels.reshape(-1), p, dtype)
            print(f"[roi_align] {name}: max_abs_err={err:.3g} (tol {tol:.3g})"
                  f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
                  f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}%"
                  f" of it; K3 equal to K1 bit for bit", flush=True)
            if stage == "box" and dtype == torch.bfloat16:
                results["roi_align"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del maps


def phase_k3(torch, results):
    """K3's path, then K3 against its plain version."""
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
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
                bound_ms, bound_by = _roi_align_bound(
                    torch, [tuple(stack.shape)], [1], flat, frame,
                    torch.zeros_like(frame), p, dtype)
                print(f"[k3] {name}: bound {bound_ms:.4f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of it", flush=True)
                results["roi_align_k3"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    launches=launches)
        del stack


def _backward_bound(grad, shapes, dtype):
    """The RoIAlign backward's bound: grad read once, the level maps
    written once in `dtype`, the pairs' rois, slabs and levels read once;
    2 FLOP per corner tap (16 taps per grad element at s=2) on the CUDA
    cores."""
    out_size = 2 if str(dtype).endswith("bfloat16") else 4
    n_bytes = (grad.numel() * grad.element_size()
               + sum(a * b * c * d for a, b, c, d in shapes) * out_size
               + grad.shape[0] * 24)
    return _bound(n_bytes, grad.numel() * 32, PEAK_F32_FLOPS)


def _backward_prep_check(torch, results, label, shapes, strides, rois, slabs,
                         levels, p):
    """The backward's prep kernel (keys and footprints) against its plain
    version on the card's tensors, exactly (the same f32 operations), with
    its time and bound: the rois, slabs and levels read and the keys and
    footprints written once; ~10 FLOP per sample position."""
    from detectandtrack_tpu_torch.kernels import roi_align as ra

    def kern():
        return ra.backward_prep(shapes, strides, rois, slabs, levels, p, 2)

    def plain():
        return (ra.backward_keys(shapes[0][0], len(shapes), slabs, levels),
                ra.backward_footprint(shapes, strides, rois, levels, p, 2))

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max((a.long() - b.long()).abs().max().item()
              for a, b in zip(got, want))
    if err != 0:
        raise RuntimeError(f"roi_align_backward prep {label}: keys or "
                           f"footprints differ from the plain rule by {err}")
    ms = _time_ms(torch, kern)
    plain_ms = _time_ms(torch, plain)
    n = rois.shape[0]
    bound_ms, bound_by = _bound(n * (24 + 20), n * 2 * p * 2 * 10,
                                PEAK_F32_FLOPS)
    empty = int((got[1] == 0).all(1).sum())
    print(f"[backward] prep {label}: keys and footprints equal to the plain "
          f"rule ({empty} of {n} pairs without a valid sample), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms "
          f"({bound_by})", flush=True)
    results["roi_align_backward_prep"] = dict(
        max_abs_err=float(err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)


def _backward_repeat_check(torch, name, kern, plain, shapes, dtype):
    """Two calls agree bit for bit, and the second, whose output block
    torch.empty hands back from a NaN-filled block of its size freed just
    before (so a cell the kernel never wrote would show), is finite and
    within tolerance of the plain version."""
    first = kern()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    size = sum(a * b * c * d for a, b, c, d in shapes)
    poison = torch.full((size,), float("nan"), dtype=dtype, device="cuda")
    ptr = poison.data_ptr()
    del poison
    second = kern()
    if second[0].data_ptr() != ptr:
        raise RuntimeError(f"{name}: the allocator did not hand back the "
                           "poisoned block; the check would prove nothing")
    for i, (a, b, r) in enumerate(zip(first, second, plain())):
        if not torch.isfinite(b.float()).all():
            raise RuntimeError(f"{name} level {i}: a cell was never written "
                               "(NaN from the poisoned block)")
        _check(f"{name} level {i} on poisoned memory", b, r, dtype, torch)
        if not torch.equal(a, b):
            raise RuntimeError(f"{name} level {i}: two calls differ")
    print(f"[backward] {name}: two calls equal bit for bit; on a poisoned "
          "(NaN-filled) output block every cell written and within "
          "tolerance", flush=True)


def phase_backward(torch, results):
    """The RoIAlign backward kernel and conv1's autograd Function against
    their plain versions."""
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
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
        if label.startswith("box"):
            _backward_prep_check(torch, results, label, shp, st, rois, slabs,
                                 levels, p)
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
            bound_ms, bound_by = _backward_bound(grad, shp, dtype)
            print(f"[backward] {name}: max_abs_err={err:.3g} (tol "
                  f"{min(t for _, t in errs):.3g}) kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of it", flush=True)
            if label.startswith("box"):
                _backward_repeat_check(torch, name, kern, plain, shp, dtype)
                if dtype == torch.bfloat16:
                    results["roi_align_backward"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None)
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


def _train_batch(torch, cfg, b, h, w, g, n_valid, seed):
    """A seeded batch in the train-step contract for `cfg`, as tensors:
    realistic GT tubes, 15 keypoints per frame inside them, `n_valid` valid
    GT rows per clip; with MODEL.MASK_ON, a disc bitmap per GT box and
    frame, 80% of frames annotated (utils/synthetic.train_batch)."""
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
    from detectandtrack_tpu_torch.utils.synthetic import train_batch
    tubes = make_realistic_tubes(b, g, _frames(cfg), h, w, seed=seed)
    batch = train_batch(np.random.default_rng(seed), tubes, [n_valid] * b,
                        (h, w),
                        cfg.MRCNN.RESOLUTION if cfg.MODEL.MASK_ON else 0)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _track(frames_per_clip):
    """Link each clip's frames; → (track ids, detections matched to a
    track of an earlier frame)."""
    from detectandtrack_tpu_torch.tracking.tracker import Tracker, TrackerConfig
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


def _frames(cfg) -> int:
    return cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1


def _heads(model):
    """The RoI heads `model` pools for: one K1 launch each per pass."""
    return [h for h in ("box_head", "kps_head", "mask_head")
            if hasattr(model, h)]


def _reset_counters():
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels.conv1 import conv1
    conv1.launches = conv1.launches_tc = conv1.launches_cc = 0
    ra.roi_align_multilevel.launches = 0
    ra.roi_align_backward.launches = ra.backward_prep.launches = 0


def _read_counters():
    """The launches since `_reset_counters`: conv1's tensor-core (bf16) and
    CUDA-core (f32) kernels, K1, the RoIAlign backward's gather and prep."""
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels.conv1 import conv1
    return {"conv1": conv1.launches_tc, "conv1_f32": conv1.launches_cc,
            "roi_align": ra.roi_align_multilevel.launches,
            "roi_align_backward": ra.roi_align_backward.launches,
            "roi_align_backward_prep": ra.backward_prep.launches}


def _check_outputs(name, out, shapes, torch):
    if set(out) != set(shapes):
        raise RuntimeError(f"{name}: outputs {sorted(out)}, expected "
                           f"{sorted(shapes)}")
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise RuntimeError(f"{name}: {key} {tuple(out[key].shape)} != "
                               f"{shape}")
        if out[key].is_floating_point() and not torch.isfinite(
                out[key]).all():
            raise RuntimeError(f"{name}: {key} has non-finite values")


def _serve(torch, tag, model, detect, warmup, requests, passes=1):
    """`detect(*request)` once on `warmup` (cuDNN plans), then timed on each
    of `requests` with the launch counters reset. Checked: conv1 launched
    once per pass, K1 once per pass and pooled head (the mask head on the
    first pass only), no backward; every output finite and of the static
    shape `detect_output_shapes` gives; some detection valid →
    (outputs, launches)."""
    from detectandtrack_tpu_torch.engine.inference import detect_output_shapes
    detect(*warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    outs, secs = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(detect(*req))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    heads = _heads(model)
    per_request = {"conv1": passes, "conv1_f32": 0, "roi_align_backward": 0,
                   "roi_align_backward_prep": 0,
                   "roi_align": passes * len(heads) - (passes - 1) * int(
                       "mask_head" in heads)}
    want = {k: len(requests) * v for k, v in per_request.items()}
    if launches != want:
        raise RuntimeError(f"{tag}: launch counters {launches}, expected "
                           f"{want} for {len(requests)} requests")
    clips = requests[0][0]
    shapes = detect_output_shapes(model, clips.shape[0])
    for out in outs:
        _check_outputs(tag, out, shapes, torch)
    n_valid = sum(int(out["valid"].sum()) for out in outs)
    if n_valid == 0:
        raise RuntimeError(f"{tag}: no valid detection")
    b, t, h, w = clips.shape[:4]
    print(f"[{tag}] {model.cfg.MODEL.COMPUTE_DTYPE}, {len(requests)} "
          f"requests of B={b} {t}x{h}x{w} after 1 warm-up: per-request s "
          f"{[round(s, 4) for s in secs]} (median "
          f"{statistics.median(secs):.4f}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}; {n_valid} valid "
          f"detections", flush=True)
    return outs, launches


def phase_slice(torch):
    """The main inference path: 4 full-width requests, 3 on realistic
    tubes through the RPN's NMS and 1 through the model's own RPN, then
    every clip tracked."""
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.inference import (
        clip_slice, detections_to_frames, make_detect_fn)
    from detectandtrack_tpu_torch.models.detector import build_model

    cfg = load_cfg(os.path.join(REPO, BOX_CFG))
    b, t, (h, w) = 2, cfg.VIDEO.NUM_FRAMES, cfg.TEST.SHAPE_BUCKETS[0]
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] model {BOX_CFG} {cfg.MODEL.COMPUTE_DTYPE}, {n_params} "
          f"params, built in {time.perf_counter() - t0:.1f} s", flush=True)
    detect = make_detect_fn(model)
    detect_p = make_detect_fn(model, with_proposals=True, run_rpn=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tubes = torch.as_tensor(make_realistic_tubes(
        b, cfg.RPN.POST_NMS_TOP_N_TEST, t, h, w)).cuda()
    requests = [(torch.randn((b, t, h, w, 3), device="cuda", generator=gen),
                 tubes if i < 3 else None) for i in range(4)]

    def run(clips, tb):
        return detect_p(clips, tb) if tb is not None else detect(clips)

    outs, launches = _serve(torch, "slice", model, run, requests[0],
                            requests)
    frames = [detections_to_frames(clip_slice(out, i), t, 1.0)
              for out in outs for i in range(b)]
    n_tracks, linked = _track(frames)
    if linked == 0:
        raise RuntimeError("slice: no detection linked across frames")
    print(f"[slice] tracked: {n_tracks} track ids, {linked} detections "
          "linked", flush=True)
    del model, detect, detect_p, requests, outs
    torch.cuda.empty_cache()
    return launches


def _train_steps(torch, tag, cfg, n_steps, seed):
    """Full-width training steps of `cfg` through the kernels: 1 warm-up,
    then `n_steps` timed with the launch counters reset. Checked: the
    model's loss terms, all finite; conv1 launched once and K1's forward
    and backward once per pooled head per step; a nonzero gradient in
    every trained part; the frozen stages untouched; at least half the
    parameters moved → launches."""
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.models.detector import build_model

    b, t, (h, w) = (cfg.TRAIN.IMS_PER_BATCH, _frames(cfg),
                    cfg.TEST.SHAPE_BUCKETS[0])
    model = build_model(cfg, device="cuda", seed=0, train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    batch = {k: v.cuda() for k, v in _train_batch(
        torch, cfg, b, h, w, cfg.TRAIN.MAX_GT_PER_IM, 5, seed).items()}
    state, _ = step(state, batch)                 # warm-up
    torch.cuda.synchronize()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    secs, losses = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    heads = _heads(model)
    want = {"conv1": n_steps, "conv1_f32": 0,
            "roi_align": len(heads) * n_steps,
            "roi_align_backward": len(heads) * n_steps,
            "roi_align_backward_prep": len(heads) * n_steps}
    if launches != want:
        raise RuntimeError(f"{tag}: launch counters {launches}, expected "
                           f"{want} for {n_steps} steps")
    head_terms = {"box_head": {"loss_cls", "loss_bbox"},
                  "kps_head": {"loss_kps"}, "mask_head": {"loss_mask"}}
    terms = set.union({"loss_rpn_cls", "loss_rpn_bbox", "loss_total"},
                      *(head_terms[head] for head in heads))
    bad = [k for d in losses for k, v in d.items() if not np.isfinite(v)]
    if bad or set(losses[0]) != terms:
        raise RuntimeError(f"{tag}: loss terms {losses}, expected {terms}")
    grads = {k: p.grad for k, p in state.params.items() if p.grad is not None}
    trained = ["rpn_head.", "backbone.res3_", "backbone.res4_"] + [
        f"{head}." for head in heads] + (
            ["fpn.", "backbone.res5_"] if cfg.FPN.FPN_ON else [])
    for prefix in trained:
        if not any(bool(g.any()) for k, g in grads.items()
                   if k.startswith(prefix)):
            raise RuntimeError(f"{tag}: no nonzero gradient under {prefix}")
    frozen = [k for k in state.params
              if k.startswith(("backbone.conv1.", "backbone.res2_"))]
    if any(k in grads for k in frozen) or any(
            not torch.equal(before[k], state.params[k]) for k in frozen):
        raise RuntimeError(f"{tag}: the frozen stages took an update")
    moved = sum(not torch.equal(before[k], p)
                for k, p in state.params.items())
    if moved < len(state.params) // 2:
        raise RuntimeError(f"{tag}: only {moved} parameters moved")
    print(f"[{tag}] {cfg.MODEL.COMPUTE_DTYPE}, BASE_LR {cfg.SOLVER.BASE_LR}, "
          f"B={b} {t}x{h}x{w}: {n_steps} steps after 1 warm-up, step s "
          f"{[round(v, 4) for v in secs]} (median "
          f"{statistics.median(secs):.4f}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}; {moved}/"
          f"{len(state.params)} parameters moved; losses of the last step "
          f"{ {k: round(v, 4) for k, v in losses[-1].items()} }", flush=True)
    del model, state, step, grads, before, batch
    torch.cuda.empty_cache()
    return launches


def phase_train_parity(torch):
    """One f32 step of each small model on the card (conv1 kernel, K1
    forward and backward kernels) against the port's CPU path, with the
    same weights, batch and draws (PARITY_TRAIN_CASES): the golden R-18 T=2
    model, and the mask, C4, center-frame keypoint and RPN-only branches
    on R-18 bodies. Each runs twice: with the conv libraries the paths run
    (cuDNN on the card, oneDNN on the CPU), and with torch's own convs on
    both devices, which holds the port's code without the two libraries'
    different f32 rounding. Losses 1e-4; every gradient GRAD_REL_TOL of
    its largest entry, or the case's own bound across the libraries."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.models.detector import build_model

    def one_step(cfg, batch, dev):
        model = build_model(cfg, device=dev, seed=0, train=True)
        state = create_train_state(cfg, model)
        state, metrics = make_train_step(model, cfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        return ({k: float(v) for k, v in metrics.items()},
                # No gradient (C4's unused res5) counts as zero.
                {k: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).cpu()
                 for k, p in state.params.items()})

    for label, path, opts, cudnn_tol in PARITY_TRAIN_CASES:
        cfg = load_cfg(path and os.path.join(REPO, path), opts=opts)
        batch = _train_batch(torch, cfg, 2, 64, 96, 10, 3, seed=8)
        for convs, tol in (("cuDNN vs oneDNN", cudnn_tol),
                           ("torch's convs on both", GRAD_REL_TOL)):
            libs = convs == "cuDNN vs oneDNN"
            torch.backends.mkldnn.enabled = torch.backends.cudnn.enabled = libs
            try:
                cpu_loss, cpu_grad = one_step(cfg, batch, "cpu")
                gpu_loss, gpu_grad = one_step(cfg, batch, "cuda")
            finally:
                torch.backends.mkldnn.enabled = True
                torch.backends.cudnn.enabled = True
            loss_err = {k: abs(gpu_loss[k] - v) for k, v in cpu_loss.items()}
            if set(gpu_loss) != set(cpu_loss) or not all(
                    e <= 1e-4 * max(1.0, abs(cpu_loss[k]))
                    for k, e in loss_err.items()):
                raise RuntimeError(f"train parity {label} {convs}: losses "
                                   f"card {gpu_loss} vs CPU {cpu_loss}")
            worst = (0.0, "")
            for k, g in cpu_grad.items():
                # Relative to the gradient's largest entry, above a floor
                # for the ones that are zero up to rounding (the heatmap
                # deconv's bias).
                rel = ((gpu_grad[k] - g).abs().max().item()
                       / max(g.abs().max().item(), GRAD_FLOOR / GRAD_REL_TOL))
                worst = max(worst, (rel, k))
            if not worst[0] <= tol:
                raise RuntimeError(f"train parity {label} {convs}: gradient "
                                   f"{worst[1]} differs by {worst[0]:.3g} of "
                                   f"its max > {tol}")
            print(f"[train-parity] {label} 64x96 f32, one step, card vs "
                  f"CPU path ({convs}): losses {sorted(cpu_loss)} "
                  f"max_abs_err {max(loss_err.values()):.3g} (tol 1e-4); "
                  f"{len(cpu_grad)} gradients, worst {worst[1]} at "
                  f"{worst[0]:.3g} of its max (tol {tol}, floor "
                  f"{GRAD_FLOOR})", flush=True)


def _kernel_vs_plain(torch, tag, name, dtype, kern, plain):
    """Hold one kernel call against its plain version and time both →
    (max_abs_err, ms, plain_ms). A kernel returning a list is the
    backward's per-level maps."""
    got, ref = kern(), plain()
    if not isinstance(got, list):
        got, ref = [got], [ref]
    errs = [_check(f"{name} level {i}", g, r, dtype, torch)
            for i, (g, r) in enumerate(zip(got, ref))]
    err, tol = max(e for e, _ in errs), min(t for _, t in errs)
    del got, ref
    ms = _time_ms(torch, kern)
    plain_ms = _time_ms(torch, plain, iters=3, warmup=1)
    print(f"[{tag}] {name}: max_abs_err={err:.3g} (tol {tol:.3g}) kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return err, ms, plain_ms


def phase_surface_kernels(torch):
    """The kernels against their plain versions at the shapes the
    surface's paths give them, on 800x1344 clips, f32 and bf16: conv1 at
    t=1; K1 on C4's one res4 level at inference (B=2 requests, the RPN's
    post-NMS count) and in training (IMS_PER_BATCH images, the Fast R-CNN
    sample count), with the backward at that training shape; K1 at the
    mask stage (the final detections on the FPN levels)."""
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels.conv1 import conv1, conv1_reference
    from detectandtrack_tpu_torch.models.detector import build_model
    c4 = load_cfg(os.path.join(REPO, C4_CFG))
    mk = load_cfg(os.path.join(REPO, MASK_CFG))
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, (h, w) = 2, c4.TEST.SHAPE_BUCKETS[0]
    stride = c4.RPN.STRIDE
    c4_dim = build_model(c4, device="meta").roi_dim          # res4's width
    p_box = c4.FAST_RCNN.ROI_XFORM_RESOLUTION
    s_tr = c4.TRAIN.IMS_PER_BATCH * _frames(c4)
    k_inf, k_tr = c4.RPN.POST_NMS_TOP_N_TEST, c4.FAST_RCNN.BATCH_SIZE_PER_IM

    def rois_of(s, k, seed):
        rois = torch.as_tensor(make_realistic_tubes(s, k, 1, h, w,
                                                    seed=seed)).clone()
        rois[:, :len(SPECIAL_ROIS)] = torch.tensor(SPECIAL_ROIS)
        return rois.cuda().contiguous()

    x = torch.randn((b, 1, h, w, 3), device="cuda", generator=gen)
    k7 = torch.randn((1, 7, 7, 3, 64), device="cuda", generator=gen) * (
        2.0 / (49 * 64)) ** 0.5
    c4_map = torch.randn((max(b, s_tr), h // stride, w // stride, c4_dim),
                         device="cuda", generator=gen)
    inf_rois, tr_rois = rois_of(b, k_inf, 9), rois_of(s_tr, k_tr, 11)
    inf_levels = torch.zeros((b, k_inf), dtype=torch.int32, device="cuda")
    tr_levels = torch.zeros((s_tr, k_tr), dtype=torch.int32, device="cuda")
    strides = [4, 8, 16, 32]
    fpn = [torch.randn((b, h // s, w // s, mk.FPN.DIM), device="cuda",
                       generator=gen) for s in strides]
    k_mask, p_mask = mk.TEST.DETECTIONS_PER_IM, mk.MRCNN.ROI_XFORM_RESOLUTION
    m_rois = rois_of(b, k_mask, 10)
    m_levels = ra.assign_fpn_levels(m_rois, 2, 5)
    bwd_shapes = [(s_tr,) + tuple(c4_map.shape[1:])]
    bwd_slabs = ra.slab_of_rows(s_tr, k_tr, "cuda")
    c4_tag = f"{h // stride}x{w // stride}x{c4_dim}"
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        inf_map = [c4_map[:b].to(dtype)]
        tr_map = [c4_map[:s_tr].to(dtype)]
        mp = [m.to(dtype) for m in fpn]
        grad = torch.randn((s_tr * k_tr, p_box, p_box, c4_dim), device="cuda",
                           generator=gen).to(dtype)
        cases = [
            (f"conv1 (2, 1, {h}, {w}, 3) t=1 {dt}",
             lambda: conv1(x, k7, 1, dtype),
             lambda: conv1_reference(x, k7, 1, dtype)),
            (f"roi_align C4 inference S={b} {c4_tag} K={k_inf} P={p_box} "
             f"{dt}",
             lambda: ra.roi_align_multilevel(inf_map, [stride], inf_rois,
                                             inf_levels, p_box, 2),
             lambda: ra.roi_align_multilevel_reference(
                 inf_map, [stride], inf_rois, inf_levels, p_box, 2)),
            (f"roi_align C4 training box stage S={s_tr} {c4_tag} K={k_tr} "
             f"P={p_box} {dt}",
             lambda: ra.roi_align_multilevel(tr_map, [stride], tr_rois,
                                             tr_levels, p_box, 2),
             lambda: ra.roi_align_multilevel_reference(
                 tr_map, [stride], tr_rois, tr_levels, p_box, 2)),
            (f"roi_align mask stage S={b} K={k_mask} P={p_mask} {dt}",
             lambda: ra.roi_align_multilevel(mp, strides, m_rois, m_levels,
                                             p_mask, 2),
             lambda: ra.roi_align_multilevel_reference(
                 mp, strides, m_rois, m_levels, p_mask, 2)),
            (f"roi_align_backward C4 training box stage S={s_tr} {c4_tag} "
             f"K={k_tr} P={p_box} {dt}",
             lambda: ra.roi_align_backward(
                 bwd_shapes, dtype, [stride], tr_rois.reshape(-1, 4),
                 bwd_slabs, tr_levels.reshape(-1), grad, p_box, 2),
             lambda: ra.roi_align_backward_reference(
                 bwd_shapes, dtype, [stride], tr_rois.reshape(-1, 4),
                 bwd_slabs, tr_levels.reshape(-1), grad, p_box, 2)),
        ]
        for name, kern, plain in cases:
            _, ms, _ = _kernel_vs_plain(torch, "surface-kernels", name, dtype,
                                        kern, plain)
            if name.startswith("roi_align_backward"):
                bound_ms, bound_by = _backward_bound(grad, bwd_shapes, dtype)
                print(f"[surface-kernels] {name}: bound {bound_ms:.4f} ms "
                      f"({bound_by}), {100 * bound_ms / ms:.1f}% of it",
                      flush=True)
        del inf_map, tr_map, mp, grad
        torch.cuda.empty_cache()


def phase_surface(torch):
    """Every new path at full width, bf16, seeded weights: 1 warm-up and 2
    requests of B=2 clips through each inference path, 1 warm-up and 2
    steps of each training path → the launches summed over the paths."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.inference import make_detect_fn
    from detectandtrack_tpu_torch.models.detector import build_model

    total = {"conv1": 0, "conv1_f32": 0, "roi_align": 0,
             "roi_align_backward": 0, "roi_align_backward_prep": 0}
    b, n_req = 2, 2
    for path, tta in SURFACE_CFGS:
        cfg = load_cfg(os.path.join(REPO, path))
        name = os.path.basename(path)[:-5] + (" detect_tta" if tta else "")
        t, (h, w) = _frames(cfg), cfg.TEST.SHAPE_BUCKETS[0]
        model = build_model(cfg, device="cuda", seed=0)
        gen = torch.Generator(device="cuda").manual_seed(12)
        clips = [(torch.randn((b, t, h, w, 3), device="cuda", generator=gen),)
                 for _ in range(n_req + 1)]
        _, launches = _serve(torch, f"surface {name}", model,
                             make_detect_fn(model, flip_tta=tta), clips[0],
                             clips[1:], passes=2 if tta else 1)
        for k, v in launches.items():
            total[k] += v
        del model, clips
        torch.cuda.empty_cache()
    for path in SURFACE_TRAIN_CFGS:
        cfg = load_cfg(os.path.join(REPO, path),
                       opts=["SOLVER.BASE_LR", TRAIN_SMOKE_LR])
        launches = _train_steps(
            torch, f"surface train {os.path.basename(path)[:-5]}", cfg, 2,
            seed=10)
        for k, v in launches.items():
            total[k] += v
    return total


def _kps_held(torch, heatmaps, hm_err, ref_boxes, got_boxes, t, tol):
    """Which keypoints (B, D, T, K) a heatmap error of at most `hm_err` and
    the decode box's own difference cannot move by more than `tol`, and the
    top-two gap of each one's heatmap. A keypoint is held where its peak
    leads the runner-up bin by more than 2·hm_err (no argmax swap) and, on
    each axis, the decode box's difference plus the bound on the parabola
    refinement's change, 3·hm_err / (|curvature| - 4·hm_err) bins, is
    within `tol`. Rows past the keypoint budget are padding and held."""
    b, m, tk, s, _, k = heatmaps.shape
    d = ref_boxes.shape[1]
    hm = heatmaps.permute(0, 1, 2, 5, 3, 4).reshape(b, m, tk, k, s * s)
    top = hm.topk(2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    idx = hm.argmax(-1)
    py, px = idx // s, idx % s

    def at(dy, dx):
        cell = (py + dy).clamp(0, s - 1) * s + (px + dx).clamp(0, s - 1)
        return hm.gather(-1, cell[..., None])[..., 0]

    peak = at(0, 0)
    frames = slice(t // 2, t // 2 + 1) if tk != t else slice(None)
    box = ref_boxes.reshape(b, d, t, 4)[:, :m, frames]       # (B, M, Tk, 4)
    box_diff = (got_boxes - ref_boxes).abs().reshape(b, d, t, 4)[
        :, :m, frames].amax(-1)[..., None]
    held = gap > 2 * hm_err
    for curv, side in ((at(0, -1) - 2 * peak + at(0, 1),
                        box[..., 2] - box[..., 0]),
                       (at(-1, 0) - 2 * peak + at(1, 0),
                        box[..., 3] - box[..., 1])):
        room = curv.abs() - 4 * hm_err
        move = 3 * hm_err / room.clamp(min=1e-6) * (
            side.clamp(min=1.0)[..., None] / s)
        held &= (room > 1e-6) & (box_diff + move <= tol)
    held, gap = held.expand(b, m, t, k), gap.expand(b, m, t, k)
    pad = (0, 0, 0, 0, 0, d - m)
    return (torch.nn.functional.pad(held, pad, value=True),
            torch.nn.functional.pad(gap, pad, value=float("inf")))


def phase_parity(torch):
    """Each small f32 model on the card against the port's CPU path on the
    same weights and clip (PARITY_CASES): the golden R-18 T=2 model and
    every new branch. Held: the valid masks equal; on valid rows scores
    1e-4, boxes 1e-2, mask probabilities 1e-4; keypoint heatmaps 1e-4 of
    their largest entry; the keypoint decode of the CPU's heatmaps on both
    devices 1e-2 (with flip TTA, the KPS_AUG pair's heatmaps and decode
    too); the keypoints end to end 1e-2, on the golden model
    everywhere, elsewhere where the measured heatmap error cannot move them
    (`_kps_held`: random heatmaps are nearly flat, so a rounding difference
    can swap an argmax); the excused ones are reported."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.inference import (detect_outputs,
                                                            make_kps_aug_fns)
    from detectandtrack_tpu_torch.models.detector import build_model

    kp_tol = 1e-2
    for i, (label, path, opts, tta, hold_all) in enumerate(PARITY_CASES):
        cfg = load_cfg(path and os.path.join(REPO, path), opts=opts)
        clip = torch.as_tensor(np.random.default_rng(42 + i).normal(
            size=(1, _frames(cfg), 64, 96, 3)).astype(np.float32))
        models, raws = {}, []
        for dev in ("cpu", "cuda"):
            model = models[dev] = build_model(cfg, device=dev, seed=0)
            with torch.inference_mode():
                raw = (model.detect_tta if tta else model)(clip.to(dev))
            raws.append({k: v.cpu() for k, v in raw.items()
                         if torch.is_tensor(v)})
        raw_ref, raw_got = raws
        ref, got = detect_outputs(raw_ref), detect_outputs(raw_got)
        valid = ref["valid"]
        if not torch.equal(got["valid"], valid) or not valid.any():
            raise RuntimeError(f"parity {label}: valid masks differ or are "
                               "empty")
        errs = {}

        def held(key, err, tol):
            if not err <= tol:
                raise RuntimeError(f"parity {label}: {key} err {err} > {tol}")
            errs[key] = err

        for key, tol in (("scores", 1e-4), ("boxes", 1e-2), ("masks", 1e-4)):
            if key in ref:
                held(key, (got[key][valid] - ref[key][valid]).abs().max()
                     .item(), tol)
        note = ""
        if "heatmaps" in raw_ref:
            hm = raw_ref["heatmaps"]
            hm_err = (raw_got["heatmaps"] - hm).abs().max().item()
            held("heatmaps (of max)", hm_err / hm.abs().max().item(), 1e-4)
            with torch.inference_mode():
                dec = [models[dev].decode_keypoints_from_heatmaps(
                    hm.to(dev), raw_ref["boxes"].to(dev)).cpu()
                       for dev in ("cpu", "cuda")]
            held("decode", (dec[1][valid] - dec[0][valid]).abs().max()
                 .item(), kp_tol)
            kp_err = (got["keypoints"] - ref["keypoints"]).abs().amax(-1)
            rows = valid[:, :, None, None].expand_as(kp_err)
            hold, gap = _kps_held(torch, hm, hm_err, raw_ref["boxes"],
                                  raw_got["boxes"], model.num_frames, kp_tol)
            hold = rows if hold_all else rows & hold
            if hold.any():
                held("keypoints end to end", kp_err[hold].max().item(),
                     kp_tol)
            excused = rows & ~hold
            if tta:
                # The KPS_AUG pair at the CPU's boxes: one scale with its
                # mirrored pass, then two stacked scales averaged and
                # decoded on the device.
                fns = {dev: make_kps_aug_fns(models[dev], flip=True)
                       for dev in ("cpu", "cuda")}
                with torch.inference_mode():
                    aug = [fns[dev][0](clip.to(dev), raw_ref["boxes"].to(
                        dev)).cpu() for dev in ("cpu", "cuda")]
                    stack = torch.stack([aug[0], hm])
                    dec = [fns[dev][1](stack.to(dev), raw_ref["boxes"].to(
                        dev)).cpu() for dev in ("cpu", "cuda")]
                held("kps_aug heatmaps (of max)", (aug[1] - aug[0]).abs()
                     .max().item() / aug[0].abs().max().item(), 1e-4)
                held("kps_aug decode", (dec[1][valid] - dec[0][valid]).abs()
                     .max().item(), kp_tol)
            note = (f"; keypoints held {int(hold.sum())}/{int(rows.sum())}"
                    f", excused {int(excused.sum())}")
            if excused.any():
                j = torch.where(excused, kp_err, -1.0).argmax()
                note += (f" (worst excused moved {kp_err.flatten()[j]:.4g} "
                         f"px at a top-two gap {gap.flatten()[j]:.3g}, "
                         f"heatmap err {hm_err:.3g})")
        print(f"[parity] {label} 64x96 f32, card vs CPU path on valid rows: "
              f"max_abs_err {errs}{note}", flush=True)


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
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.kernels import _build

    card = _card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    sources = ["conv1", "roi_align", "hungarian"]
    _build.build(sources)
    for name in sources:
        _build.load_library(name)
    print(f"[build] {', '.join(sources)} built in "
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
    # With random weights (no pretrained backbone, identity frozen-BN
    # affines) the unclipped config's own BASE_LR 0.005 blows the losses up
    # within three steps; TRAIN_SMOKE_LR keeps every loss finite and
    # changes nothing else on the path.
    training = _train_steps(torch, "train", load_cfg(
        os.path.join(REPO, BOX_CFG), opts=["SOLVER.BASE_LR", TRAIN_SMOKE_LR]),
        3, seed=7)
    phase_surface_kernels(torch)
    surface = phase_surface(torch)
    # The f32 models of the parity phases run conv1's CUDA-core kernel.
    _reset_counters()
    phase_parity(torch)
    phase_train_parity(torch)
    parity = _read_counters()
    if parity["conv1_f32"] == 0:
        raise RuntimeError(f"parity: launch counters {parity}: conv1's f32 "
                           "kernel never ran")
    launches = {k: inference[k] + training[k] + surface[k]
                for k in training}
    print(f"[launches] inference slice {inference}; training slice "
          f"{training}; surface paths {surface}; parity phases {parity}; "
          f"k3 path {results['roi_align_k3']['launches']}; sum of the "
          f"full-width paths {launches}", flush=True)

    ra = "detectandtrack_tpu/kernels/roi_align.py"
    k3 = dict(results["roi_align_k3"])
    kernels = [
        {"name": "conv1", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/conv1.cu",
         "replaces": "detectandtrack_tpu/kernels/conv1.py:167",
         "launches": launches["conv1"], **results["conv1"]},
        {"name": "conv1_f32", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/conv1.cu",
         "replaces": "detectandtrack_tpu/kernels/conv1.py:167",
         "launches": parity["conv1_f32"], **results["conv1_f32"]},
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
        {"name": "roi_align_backward_prep", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/roi_align.cu",
         "replaces": f"{ra}:566",
         "launches": launches["roi_align_backward_prep"],
         **results["roi_align_backward_prep"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
