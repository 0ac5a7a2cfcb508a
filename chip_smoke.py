#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`detectandtrack_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each (any failure ends the run with a nonzero exit):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the native sources from csrc/ (one compiler each, in
     parallel: conv1.cu, roi_align.cu, diag_roialign.cu, nms.cu and
     affine.cu with nvcc for sm_90a, the tracker's hungarian.cpp with
     g++);
  3. conv1 against its plain version (pad + F.conv3d) at the main path's
     (2, 8, 800, 1344, 3) clip at t=3 and t=1 and an odd-sized t=1 clip:
     bf16 through the bf16 tensor-core kernel, f32 through the 3-pass TF32
     kernel; at full size also one F.conv3d call (cuDNN, TF32 off), the
     bound and the kernel's share of it;
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
  6b. [diag] the diagnostic kernel (the port of tools/diag_roialign.py's
     mini-kernel) on its path, the port's tools/diag_roialign.py at
     n=4800, p=7 and p=14, launch counters read per variant; then each
     variant (full, noswitch, nodma, nodot) against its plain version at
     those shapes with its time, µs per pair and bound;
  6c. [tools] the port's tools/bench_roialign.py and tools/bench_conv.py
     once each at 3 iterations (no profiler runs here: capture_trace is
     run by hand, as its own command);
  6d. [affine] the conv epilogue kernel (kernels/affine.py) against its
     plain version, bit for bit, at the sites of the main path at B=2
     (conv1's and res2's affine + ReLU, res2_0's last conv with the
     projection's affine, the stages' last convs with their shortcuts,
     an FPN lateral with the upsampled top-down add, a posthoc conv's
     bias, the RPN's 3 logits, a keypoint-head conv), bf16 and f32, each
     with its time, its bound, the plain version's time and, as
     `library_ms`, the PyTorch op chain the sites ran before;
  7. the inference slice at full width: the 3D R-50 T=8 keypoint model in
     bf16 with seeded random weights answers 4 requests of B=2 clips of
     8x800x1344 (3 through detect_with_proposals(run_rpn=True) with
     realistic tubes, 1 through the model's own RPN), the launch counters
     are checked, and every clip is tracked;
  7b. [bench] the port's bench (detectandtrack_tpu_torch/bench.py) in this
     process at its default full width, R-50 T=8 800x1344, B=4 for infer
     and B=1 for train and stream, BENCH_ITERS=10 and
     BENCH_STREAM_FRAMES=64 (the defaults, uncut): each mode's JSON line
     printed with the card
     line and checked (value finite and positive, MFU in (0, 100], loss
     finite, 2 x 64 frames streamed, launch counters of its calls); the
     FLOP count of one B=1 infer call on the kernel path equal to that of
     the same call with the plain conv1 and RoIAlign; then `launch --mode
     bench` (infer, BENCH_ITERS=2) as a subprocess: exit 0, one line;
  8. the training slice at full width: the same model and config in bf16
     takes 1 warm-up and 3 timed SGD steps on one seeded 8x800x1344 clip
     with seeded GT; losses finite, launch counters (conv1 = steps,
     RoIAlign forward = backward = 2 x steps), FPN and res3+ gradients
     nonzero, parameters moved;
  8b. [dataset] the dataset-level path through the port's CLI, bf16,
     seeded weights: a generated hard synthetic set at 720x1280 (3 videos
     of 13 frames, 1 of 5) under configs/video/track_3d_R50_hungarian.yaml
     (3D R-50 T=8, bucket 800x1344): --mode test at batch 2 (7 windows, 4
     batches, the last padded), track, eval, stream, and test with
     TEST.PROPOSAL_FILES (GT boxes); then 3 frames at 480x640 through the
     multi-scale flip TTA + KPS_AUG config (three scales, three buckets).
     Checked: launch counters derived from windows and batches, every
     frame once, finite outputs and metrics, stream track ids equal to
     test + track, eval of the written tracks equal to track's metrics;
     printed: wall time, frames/s, per-batch model time, peak memory;
  8c. [finetune] the fine-tuning path through the port's CLI, bf16, in a
     fresh out_smoke/finetune: a Detectron .pkl of the seeded 2D R-50 FPN
     model (configs/video/2d_R50_FPN_kps.yaml) imported into the main 3D
     config (--mode import-weights: nothing missing or unused, the t=3
     kernels mean-inflated, K2 with the inflated conv1 equal to K2 with
     the 2D kernel on a time-constant clip's frames 1-6); --mode train
     from it on [dataset]'s 720x1280 set (B=1, BASE_LR 1e-4, clip 10, 4
     steps, a checkpoint every 2), run again to 6 (resumes from step 4,
     takes 2 steps), the final weights through one --mode test batch;
     then the synthetic smoke config trained 150 steps through the CLI
     (tools/smoke_learn.py), tested and tracked, held to the JAX CLI's
     scores on the same recipe. Checked: launch counters = steps x the
     per-step counts of 8, checkpoints, finite losses every step;
     printed: host and CUDA-event step times, their ratio, peak memory;
  8d. [multigpu] data parallelism (parallel/mesh.py), each multi-rank run
     a torchrun child (this script with --child) under a timeout; the one
     card allows two ranks over gloo and NCCL at world size 1: (a) two
     ranks, one step of the golden f32 model (all-reduced gradients vs
     the mean of the rows' gradients on the card, parameters equal across
     ranks), then 1 warm-up and 2 steps of the main config at full width,
     one clip per rank (launches = steps x the per-step counts of 8, step
     time, peak memory, the gloo all-reduce of one step's gradients);
     (b) --mode train under torchrun at world size 1 (NCCL) vs the same
     run alone; (c) --mode test and --mode stream on two ranks vs one
     process at --batch-size 1 (launches per rank, detections, track ids);
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
  9b. [surface-ops] the ops the port took last from the JAX package
     (flip_boxes, bbox_iou_pairwise, flip_heatmaps, batched_nms_fixed,
     soft_nms_scan, heatmaps_to_keypoints_numpy) on CUDA against the CPU;
     soft_nms_fixed against the sequential soft_nms_scan on CUDA on the
     CPU test's soft-NMS cases; then tools/parity_check.py end to end on
     the card: [finetune]'s .pkl imported into the main config, [dataset]'s
     720x1280 set streamed and scored, the tool's detections rewritten in
     Detectron's form and diffed by a second run (the same detections and
     metrics, keypoint delta 0, IoU 1 on every box with a +1-convention
     area); launch counters = windows per run;
 10. parity: small f32 models on the card against the port's CPU path on
     the same weights and inputs: inference of the golden R-18 T=2 model
     and of every new branch (R-18 bodies, 64x96), then one training step
     each of the golden model and of the mask, C4, center-frame and
     RPN-only branches (losses and every gradient).
Then it prints the kernels' JSON line (launches summed over the
full-width paths, the [bench], [dataset], [finetune], [multigpu] and
[surface-ops] runs among them (not the bench subprocess's), the torchrun children's counts included;
conv1's f32 kernel counted over the parity phases, K3 on its own path,
the RoIAlign backward's prep kernel beside its gather, the NMS kernels
and the conv epilogue summed over the serving and training paths that
check them ([slice], [graphs], [train], [surface]), the diagnostic
kernel per variant at p=7 with its tool's launches; each with its time,
its plain version's, its bound and the one PyTorch call that computes
the same function, where there is one),
the nvidia-smi card line and, last, {"ok": true, "device": {...}}. It exits
nonzero without a CUDA device.
"""

import contextlib
import json
import os
import statistics
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
RELU_TIE_TOL = 1e-4         # a ReLU input the devices may decide apart,
                            # of its tensor's max |x|
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
    """conv1 against its plain version: the main path's clip at t=3 and
    t=1 and an odd-sized t=1 clip, bf16 (the tensor-core kernel) and f32
    (the 3-pass TF32 kernel); at the full-size shapes also one F.conv3d
    call (cuDNN) on the padded input, with the bound and the kernel's share
    of it."""
    import torch.nn.functional as F
    from detectandtrack_tpu_torch.kernels.conv1 import conv1, conv1_reference
    from detectandtrack_tpu_torch.utils import roofline
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [((2, 8, 800, 1344, 3), 3), ((2, 1, 800, 1344, 3), 1),
             ((1, 3, 97, 131, 3), 1)]
    for shape, t in cases:
        x = torch.randn(shape, device="cuda", generator=gen)
        k7 = torch.randn((t, 7, 7, 3, 64), device="cuda", generator=gen) * (
            2.0 / (t * 49 * 64)) ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            xd, kd = x.to(dtype), k7.to(dtype)
            got = conv1(xd, kd, t, dtype)
            ref = conv1_reference(xd, kd, t, dtype)
            route = "tensor-core" if dtype == torch.bfloat16 else "3-pass TF32"
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
                bound_ms, bound_by = roofline.bound(
                    roofline.conv1_work(shape, t, dtype))
                line += (f", F.conv3d {library_ms:.3f} ms; bound "
                         f"{bound_ms:.3f} ms ({bound_by}), "
                         f"{100 * bound_ms / ms:.1f}% of it")
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


def phase_roi_align(torch, results):
    """K1 against its plain version at the box and keypoint stages, with
    its bound; K3 on the same rois (as (roi, slab) pairs) equal to K1 bit
    for bit."""
    from detectandtrack_tpu_torch.kernels.roi_align import (
        roi_align_multilevel, roi_align_multilevel_reference, roi_align_pairs,
        slab_of_rows)
    from detectandtrack_tpu_torch.utils import roofline
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
            bound_ms, bound_by = roofline.bound(roofline.roi_align_work(
                shapes, strides, rois.reshape(-1, 4), slabs,
                levels.reshape(-1), p, dtype))
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
    from detectandtrack_tpu_torch.utils import roofline
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
                bound_ms, bound_by = roofline.bound(roofline.roi_align_work(
                    [tuple(stack.shape)], [1], flat, frame,
                    torch.zeros_like(frame), p, dtype))
                print(f"[k3] {name}: bound {bound_ms:.4f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of it", flush=True)
                results["roi_align_k3"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    launches=launches)
        del stack


def _backward_prep_check(torch, results, label, shapes, strides, rois, slabs,
                         levels, p):
    """The backward's prep kernel (keys and footprints) against its plain
    version on the card's tensors, exactly (the same f32 operations), with
    its time and bound: the rois, slabs and levels read and the keys and
    footprints written once; ~10 FLOP per sample position."""
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.utils import roofline

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
    bound_ms, bound_by = roofline.bound(roofline.backward_prep_work(n, p))
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
    from detectandtrack_tpu_torch.utils import roofline
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
            bound_ms, bound_by = roofline.bound(roofline.backward_work(
                grad, shp, dtype))
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


DIAG_N = 4800               # the diagnostic tool's own pairs


def _soft_rounds(torch, scores, dmat, overlaps, alive):
    """The confirmation rounds these inputs need (the last confirms
    nothing: the data-dependent trip count of soft_nms_confirm's loop),
    and their touched work, round by round → (rounds, decays, compares,
    multiplies): the decays the rounds multiply in (j newly confirmed, i an
    alive overlapper still unconfirmed: dmat[j, i] read once each); the
    outrank tests of each unconfirmed alive box against its unconfirmed
    alive overlappers; for each (chunk, box still unconfirmed) that a newly
    confirmed overlapper changes, the chunk's PROD_CHUNK multiplications,
    and for each such box its prov's (chunks + 1)."""
    from detectandtrack_tpu_torch.kernels.nms import (PROD_CHUNK,
                                                      soft_nms_round)
    n = scores.shape[-1]
    nc = -(-n // PROD_CHUNK)
    confirmed = torch.zeros_like(alive)
    rounds = decays = compares = multiplies = 0
    while True:
        rounds += 1
        ua = ~confirmed & alive
        compares += int((ua[..., :, None] & overlaps & ua[..., None, :]).sum())
        _, newly = soft_nms_round(scores, dmat, overlaps, alive, confirmed)
        if not bool(newly.any()):
            return rounds, decays, compares, multiplies
        confirmed = confirmed | newly
        touched = (newly[..., :, None] & overlaps
                   & (~confirmed & alive)[..., None, :])
        decays += int(touched.sum())
        hit = torch.nn.functional.pad(touched, (0, 0, 0, nc * PROD_CHUNK - n))
        hit = hit.reshape(hit.shape[:-2] + (nc, PROD_CHUNK, n)).any(-2)
        multiplies += (int(hit.sum()) * PROD_CHUNK
                       + int(hit.any(-2).sum()) * (nc + 1))


def phase_nms(torch, results):
    """The NMS loop kernels against their plain versions at the main
    path's shapes, all bit for bit: nms_keep from the sorted boxes on the
    RPN's 5 x B = 10 lanes of N=1000, the final NMS's B=2 lanes of N=300
    and the training step's 5 lanes of N=2000 (IoU 0.7, 0.5, 0.7), random
    boxes and a long suppression chain; soft_nms_confirm on the soft-NMS
    config's B=2 lanes of N=300, linear and gaussian, random boxes and a
    chain. Each with its time (CUDA events around 10 eager calls, the
    kernels line's `ms` as for every kernel; and one call's device time
    inside a CUDA graph of 20, its `graph_ms`), its plain version's and its
    bound; soft-NMS also with its rounds and time a round. At the RPN's
    shape also the torch passes that nms_keep's mask kernel replaced
    (bbox_overlaps, threshold, triangle), timed alike, and the rise of
    nms_fixed's peak memory, which must stay below one (L, N, N) bool
    tensor."""
    from detectandtrack_tpu_torch.kernels import nms as kn
    from detectandtrack_tpu_torch.ops.boxes import bbox_overlaps
    from detectandtrack_tpu_torch.ops.nms import nms_fixed
    from detectandtrack_tpu_torch.tools.nms_ab import (
        KEEP_SHAPES, SOFT_LANES, SOFT_N, graph_ms, greedy_lanes,
        keep_inputs, soft_inputs)
    from detectandtrack_tpu_torch.utils import roofline

    for label, lanes, n, thresh in KEEP_SHAPES:
        for chain in (False, True):
            boxes, scores = greedy_lanes(lanes, n, chain, seed=n)
            b, valid = keep_inputs(boxes, scores)
            got = kn.nms_keep(b, valid, thresh)
            ref = kn.nms_keep_reference(b, valid, thresh)
            name = (f"nms_keep {label} {lanes} lanes N={n} "
                    f"{'chain' if chain else 'random'}")
            if not torch.equal(got, ref):
                bad = (got != ref).nonzero()[:5].tolist()
                raise RuntimeError(f"{name}: differs from its plain version "
                                   f"at {bad}")
            kept = int(ref.sum())
            del got, ref
            ms = _time_ms(torch, lambda: kn.nms_keep(b, valid, thresh))
            dev_ms = graph_ms(lambda: kn.nms_keep(b, valid, thresh))
            plain_ms = _time_ms(torch, lambda: kn.nms_keep_reference(
                b, valid, thresh), iters=2, warmup=1)
            bound_ms, bound_by = roofline.bound(roofline.nms_keep_work(
                lanes, n))
            print(f"[nms] {name}: equal bit for bit, {kept} kept; kernel "
                  f"{ms:.4f} ms eager, {dev_ms:.4f} ms in a graph, plain "
                  f"{plain_ms:.3f} ms; bound {bound_ms:.5f} ms "
                  f"({bound_by}), {100 * bound_ms / ms:.2f}% of it eager, "
                  f"{100 * bound_ms / dev_ms:.2f}% in a graph", flush=True)
            if label != "RPN" or chain:
                continue
            results["nms_keep"] = dict(
                max_abs_err=0.0, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            rank = torch.arange(n, device=b.device)
            tri = rank[:, None] < rank[None, :]

            def passes():
                return (bbox_overlaps(b, b) > thresh) & tri

            print(f"[nms] the torch passes nms_keep replaced (bbox_overlaps, "
                  f"threshold, triangle) {label} {lanes} lanes N={n}: "
                  f"{_time_ms(torch, passes):.4f} ms eager, "
                  f"{graph_ms(passes):.4f} ms in a graph", flush=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            nms_fixed(boxes, scores, thresh, n)
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            print(f"[nms] nms_fixed {label} {lanes} lanes N={n}: peak "
                  f"memory rises {rise} bytes (an (L, N, N) bool tensor: "
                  f"{lanes * n * n})", flush=True)
            if rise >= lanes * n * n:
                raise RuntimeError(f"nms_fixed at {lanes} x {n} allocates "
                                   f"{rise} bytes: an (L, N, N) tensor")
    neg_inf = -1e10
    for method in ("linear", "gaussian"):
        for chain in (False, True):
            boxes, scores = greedy_lanes(SOFT_LANES, SOFT_N, chain, seed=31)
            args = soft_inputs(boxes, scores, method)
            got = kn.soft_nms_confirm(*args, neg_inf)
            ref = kn.soft_nms_confirm_reference(*args, neg_inf)
            name = (f"soft_nms_confirm {method} {SOFT_LANES} lanes "
                    f"N={SOFT_N} {'chain' if chain else 'random'}")
            if not torch.equal(got, ref):
                err = (got - ref).abs().max().item()
                raise RuntimeError(f"{name}: not bit for bit with its plain "
                                   f"version (max_abs_err {err})")
            rounds, decays, compares, multiplies = _soft_rounds(torch, *args)
            ms = _time_ms(torch, lambda: kn.soft_nms_confirm(*args, neg_inf))
            dev_ms = graph_ms(lambda: kn.soft_nms_confirm(*args, neg_inf))
            plain_ms = _time_ms(torch, lambda: kn.soft_nms_confirm_reference(
                *args, neg_inf), iters=1, warmup=0)
            bound_ms, bound_by = roofline.bound(
                roofline.soft_nms_confirm_work(SOFT_LANES, SOFT_N, decays,
                                               compares, multiplies))
            print(f"[nms] {name}: equal bit for bit, {rounds} rounds, "
                  f"{decays} decays read; kernel {ms:.4f} ms eager, "
                  f"{dev_ms:.4f} ms in a graph "
                  f"({1e3 * dev_ms / rounds:.2f} us a round), plain "
                  f"{plain_ms:.3f} ms; bound {bound_ms:.5f} ms "
                  f"({bound_by}), {100 * bound_ms / ms:.2f}% of it eager, "
                  f"{100 * bound_ms / dev_ms:.2f}% in a graph", flush=True)
            if method == "linear" and not chain:
                results["soft_nms_confirm"] = dict(
                    max_abs_err=0.0, ms=ms, graph_ms=dev_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=None)


# [affine]'s sites of the main path at B=2 clips of 8x800x1344: (label, y's
# shape, scale?, shortcut: None / "plain" / "affine" / "up", ReLU?).
AFFINE_SITES = [
    ("conv1 affine+relu", (2, 8, 400, 672, 64), True, None, True),
    ("res2 a affine+relu", (2, 8, 200, 336, 64), True, None, True),
    ("res2_0 c + proj affine +relu", (2, 8, 200, 336, 256), True, "affine",
     True),
    ("res2 c + shortcut +relu", (2, 8, 200, 336, 256), True, "plain", True),
    ("res3 c + shortcut +relu", (2, 8, 100, 168, 512), True, "plain", True),
    ("res4 c + shortcut +relu", (2, 8, 50, 84, 1024), True, "plain", True),
    ("res5 c + shortcut +relu", (2, 8, 25, 42, 2048), True, "plain", True),
    ("FPN lateral P2 bias + top-down", (2, 8, 200, 336, 256), False, "up",
     False),
    ("FPN posthoc P2 bias", (2, 8, 200, 336, 256), False, None, False),
    ("RPN logits P2 bias", (2, 1, 200, 336, 3), False, None, False),
    ("keypoint conv bias+relu", (2 * 20 * 8, 1, 14, 14, 512), False, None,
     True),
]


def phase_affine(torch, results):
    """The conv epilogue kernel against its plain version at AFFINE_SITES,
    bf16 and f32, bit for bit; each with the kernel's time (CUDA events
    around 10 calls, which overwrite y in place as the sites do), its
    bound, the plain version's time and, as `library_ms`, the op chain the
    sites ran before (the per-channel broadcasts, the add, the ReLU and,
    for the lateral, the upsampled copy), timed alike."""
    import torch.nn.functional as F
    from detectandtrack_tpu_torch.kernels import affine as ka
    from detectandtrack_tpu_torch.models.fpn import upsample_nearest_2x
    from detectandtrack_tpu_torch.utils import roofline
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, shape, has_scale, sc, relu in AFFINE_SITES:
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            y = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            s = torch.rand(c, device="cuda", generator=gen) + 0.5
            b = torch.randn(c, device="cuda", generator=gen)
            s = s if has_scale else None
            r = rs = rb = None
            if sc in ("plain", "affine"):
                r = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            if sc == "up":
                r = torch.randn(shape[:2] + (shape[2] // 2, shape[3] // 2,
                                             c), device="cuda",
                                generator=gen).to(dtype)
            if sc == "affine":
                rs = torch.rand(c, device="cuda", generator=gen) + 0.5
                rb = torch.randn(c, device="cuda", generator=gen)
            args = (s, b, r, rs, rb, relu)
            want = ka.affine_epilogue_reference(y.clone(), *args)
            got = ka.affine_epilogue(y, *args)
            name = f"{label} {tuple(shape)} {str(dtype)[6:]}"
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                raise RuntimeError(f"{name}: differs from its plain version "
                                   f"(max |diff| {err})")
            del want

            def chain():
                v = y * s.to(dtype) + b.to(dtype) if s is not None else (
                    y + b.to(dtype))
                if sc == "up":
                    v = v + upsample_nearest_2x(r)
                elif sc == "plain":
                    v = v + r
                elif sc == "affine":
                    v = v + (r * rs.to(dtype) + rb.to(dtype))
                return F.relu(v) if relu else v

            ms = _time_ms(torch, lambda: ka.affine_epilogue(y, *args))
            plain_ms = _time_ms(torch, lambda: ka.affine_epilogue_reference(
                y, *args), iters=3, warmup=1)
            library_ms = _time_ms(torch, chain)
            bound_ms, bound_by = roofline.bound(roofline.affine_work(
                y.numel(), c, dtype, 0 if r is None else r.numel(),
                scale=s is not None, shortcut_affine=rs is not None))
            print(f"[affine] {name}: equal bit for bit; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, op chain {library_ms:.3f} ms; "
                  f"bound {bound_ms:.3f} ms ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of it", flush=True)
            if sc == "plain" and c == 256 and dtype == torch.bfloat16:
                results["affine_epilogue"] = dict(
                    max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)
            del y, r


def phase_diag(torch, results):
    """The diagnostic kernel (kernels/diag_roialign.py) on its path, the
    tool tools/diag_roialign.py: its main() at n=4800, p=7 and p=14, with
    the per-variant launch counters reset just before and read just after
    (each must be > 0). Then each variant at those shapes against its plain
    version (full and noswitch within the bf16 tolerance, nodma and nodot
    bit for bit), CUDA-event time, µs per pair and bound → launches."""
    from detectandtrack_tpu_torch.kernels import diag_roialign as dr
    from detectandtrack_tpu_torch.tools import diag_roialign as tool
    from detectandtrack_tpu_torch.utils import roofline
    dr.diag_pool.launches = dict.fromkeys(dr.VARIANTS, 0)
    for p in (7, 14):
        tool.main([str(DIAG_N), str(p), "--iters", "5", "--warmup", "1"])
    torch.cuda.synchronize()
    launches = dict(dr.diag_pool.launches)
    if not all(launches[v] > 0 for v in dr.VARIANTS):
        raise RuntimeError(f"diag: launch counters {launches} after the "
                           "tool's run")
    feats, rois, levels = tool.make_inputs(DIAG_N)
    for p in (7, 14):
        for variant in dr.VARIANTS:
            def kern():
                return dr.diag_pool(feats, rois, levels, p, variant)

            def plain():
                return dr.diag_pool_reference(feats, rois, levels, p, variant)

            name = f"diag {variant} n={DIAG_N} p={p}"
            got, ref = kern(), plain()
            if variant in ("full", "noswitch"):
                err, tol = _check(name, got, ref, torch.bfloat16, torch)
            else:
                torch.cuda.synchronize()
                err, tol = (got.float() - ref.float()).abs().max().item(), 0.0
                if not torch.equal(got, ref):
                    raise RuntimeError(f"{name}: differs from the plain "
                                       f"version by {err} (must be exact)")
            del got, ref
            ms = _time_ms(torch, kern)
            plain_ms = _time_ms(torch, plain, iters=2, warmup=1)
            bound_ms, bound_by = roofline.bound(roofline.diag_work(
                dr.patch_cells(rois, levels, len(feats), variant), DIAG_N, p,
                feats[0].shape[3], variant))
            print(f"[diag] {name}: max_abs_err={err:.3g} (tol {tol:.3g}) "
                  f"kernel {ms:.3f} ms = {1e3 * ms / DIAG_N:.3f} us/pair, "
                  f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
                  f"({bound_by}), {100 * bound_ms / ms:.1f}% of it; "
                  f"launches on the tool's path {launches[variant]}",
                  flush=True)
            if p == 7:
                results[f"diag_{variant}"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    del feats, rois, levels
    torch.cuda.empty_cache()
    return launches


def phase_tools(torch):
    """The kernel tools' paths on the card, once each at few iterations:
    tools/bench_roialign.py (K1 at the realistic roi mix) and
    tools/bench_conv.py (keypoint-head conv, conv1 and res2)."""
    from detectandtrack_tpu_torch.tools import bench_conv, bench_roialign
    rows = bench_roialign.main(["3"]) + bench_conv.main(["all", "3"])
    bad = [r for r in rows if not (r["ms"] > 0)]
    if bad:
        raise RuntimeError(f"tools: rows without a time {bad}")
    torch.cuda.empty_cache()
    print(f"[tools] bench_roialign and bench_conv ran: {len(rows)} rows",
          flush=True)


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
    from detectandtrack_tpu_torch.kernels.affine import affine_epilogue
    from detectandtrack_tpu_torch.kernels import nms as kn
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels.conv1 import conv1
    conv1.launches = conv1.launches_tc = conv1.launches_f32 = 0
    ra.roi_align_multilevel.launches = 0
    ra.roi_align_backward.launches = ra.backward_prep.launches = 0
    kn.nms_keep.launches = kn.soft_nms_confirm.launches = 0
    affine_epilogue.launches = 0


def _nms_counters():
    """The NMS kernels' launches since `_reset_counters` (kept apart from
    `_read_counters`, whose keys every path's expected counts name)."""
    from detectandtrack_tpu_torch.kernels import nms as kn
    return {"nms_keep": kn.nms_keep.launches,
            "soft_nms_confirm": kn.soft_nms_confirm.launches}


# The NMS kernels' launches on the serving and training paths that check
# them ([slice], [graphs], [train], [surface]): the kernels line's counts.
NMS_LAUNCHES = {"nms_keep": 0, "soft_nms_confirm": 0}


def _nms_per_call(model, passes=1, train=False):
    """The NMS kernels one call of `model` launches: the RPN's greedy NMS
    once per pass, then (not in training, not RPN-only) the final NMS,
    soft-NMS under TEST.SOFT_NMS_ENABLED."""
    cfg = model.cfg
    final = not train and not cfg.MODEL.RPN_ONLY
    soft = final and cfg.TEST.SOFT_NMS_ENABLED
    return {"nms_keep": passes + int(final and not soft),
            "soft_nms_confirm": int(soft)}


def _check_nms(tag, model, calls, passes=1, train=False):
    got = _nms_counters()
    want = {k: calls * v for k, v in _nms_per_call(model, passes,
                                                   train).items()}
    if got != want:
        raise RuntimeError(f"{tag}: NMS kernel launches {got}, expected "
                           f"{want} for {calls} calls")
    for k, v in got.items():
        NMS_LAUNCHES[k] += v
    return got


# The conv epilogue kernel's launches on the serving and training paths that
# check them ([slice], [graphs], [train], [surface]): the kernels line's
# count, without [affine]'s own calls.
EPILOGUE_LAUNCHES = [0]


def _epilogue_per_call(model, passes=1, train=False):
    """The conv epilogue passes (`affine_epilogue` launches) one call of
    `model` makes, counted from its modules: one for each conv with a bias
    or a frozen-BN affine that runs where no gradient is needed (a block's
    projection rides on its last conv's pass). A detect pass runs conv1,
    the blocks of the stages `features` reads (C4: up to res4), the FPN,
    the RPN head on each level, the box and keypoint heads; the mask head
    runs on the first pass only. A training step needs gradients from the
    first conv whose parameters train on, so only conv1 and the frozen
    blocks that lead the body take the pass (none under the norm clip,
    which makes every parameter need a gradient)."""
    import itertools
    from detectandtrack_tpu_torch.models.backbone import (Conv1, Conv3d,
                                                          ConvAffine)

    def sites(module):
        return sum((isinstance(m, (Conv1, ConvAffine))
                    and not name.endswith("proj"))
                   or (isinstance(m, Conv3d) and m.bias is not None)
                   for name, m in module.named_modules())

    cfg, bb = model.cfg, model.backbone
    stages = bb.stage_names[:4 if cfg.FPN.FPN_ON else 3]
    body = [bb.conv1] + [getattr(bb, n) for names in stages for n in names]
    if train:
        return sum(map(sites, itertools.takewhile(
            lambda m: not any(p.requires_grad for p in m.parameters()),
            body)))
    levels = (cfg.FPN.RPN_MAX_LEVEL - cfg.FPN.RPN_MIN_LEVEL + 1
              if cfg.FPN.FPN_ON else 1)
    per_pass = sum(map(sites, body)) + levels * sites(model.rpn_head) + sum(
        sites(getattr(model, m)) for m in ("fpn", "box_head", "kps_head")
        if hasattr(model, m))
    mask = sites(model.mask_head) if hasattr(model, "mask_head") else 0
    return passes * per_pass + mask


def _check_epilogue(tag, model, calls, passes=1, train=False):
    """The conv epilogue kernel's launches since `_reset_counters` against
    `_epilogue_per_call` → the count."""
    from detectandtrack_tpu_torch.kernels.affine import affine_epilogue
    got = affine_epilogue.launches
    want = calls * _epilogue_per_call(model, passes, train)
    if got != want:
        raise RuntimeError(f"{tag}: conv epilogue launches {got}, expected "
                           f"{want} for {calls} calls")
    EPILOGUE_LAUNCHES[0] += got
    return got


def _read_counters():
    """The launches since `_reset_counters`: conv1's bf16 and f32 (3-pass
    TF32) kernels, K1, the RoIAlign backward's gather and prep."""
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.kernels.conv1 import conv1
    return {"conv1": conv1.launches_tc, "conv1_f32": conv1.launches_f32,
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
    nms = _check_nms(tag, model, len(requests), passes)
    epilogues = _check_epilogue(tag, model, len(requests), passes)
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
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}, NMS kernels "
          f"{nms}, conv epilogues {epilogues}; {n_valid} valid detections",
          flush=True)
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


GRAPH_TIMED = 4      # [graphs]: requests per mode in each of two turns


# Graphed against eager outputs: where not bit for bit, within the golden
# tolerances (tests/test_golden.py: scores 1e-4, boxes and keypoints 1e-2;
# mask probabilities 1e-4, bf16 features 2^-6 of their largest |value|).
GRAPH_TOLS = {"scores": 1e-4, "boxes": 1e-2, "keypoints": 1e-2,
              "masks": 1e-4}


def _outputs_match(torch, tag, got, want):
    """Graphed outputs against eager ones on the same model and inputs:
    the valid masks equal, every other key bit for bit or within
    GRAPH_TOLS → {key: max |difference|} of the keys that are not bit for
    bit."""
    if set(got) != set(want) or not torch.equal(got["valid"], want["valid"]):
        raise RuntimeError(f"{tag}: graphed keys {sorted(got)} or valid mask "
                           f"differ from the eager ones")
    diff = {}
    for k in want:
        if torch.equal(got[k], want[k]):
            continue
        err = (got[k].float() - want[k].float()).abs().max().item()
        tol = GRAPH_TOLS.get(k, BF16_REL_TOL * max(
            1.0, want[k].float().abs().max().item()))
        if not err <= tol:
            raise RuntimeError(f"{tag}: graphed {k} differs from eager by "
                               f"{err} > {tol}")
        diff[k] = err
    return diff


@contextlib.contextmanager
def _eager_entry_points():
    """The port's entry points uncaptured, as before CUDA graphs: a CUDA
    model's functions from `make_detect_fn`/`make_kps_aug_fns` eager."""
    from detectandtrack_tpu_torch.engine import inference as tinf
    saved = tinf._on_device
    tinf._on_device = lambda model, fn, name: fn
    try:
        yield
    finally:
        tinf._on_device = saved


def _sync_free(torch, tag, fn, *args):
    """One eager call under `set_sync_debug_mode("error")`: any host sync
    inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*args)
    except RuntimeError as err:
        raise RuntimeError(f"{tag}: a host sync in an eager call: {err}") \
            from err
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_graphs(torch):
    """The captured entry points against the eager ones, in this process:
    (1) the main config at B=2 8x800x1344: an eager call under
    `set_sync_debug_mode("error")`; the graphed outputs of two requests
    (graph replays) equal the eager outputs of the same model and inputs
    bit for bit; kernel launches of eager calls and replays counted alike;
    request time (host clock to `synchronize()`), eager and graphed in
    turns (eager, graphed, graphed, eager), the graphed request's
    CUDA-event span (the card's work, one program) and the idle share it
    implies; peak memory of each; (2) the bench's infer path
    (`with_proposals`, `run_rpn`, B=4): the same equality and sync checks,
    and the bench's double-buffered clips/s (`bench._timed`, 10 calls)
    eager and graphed in turns; (3) the bench's stream p50 with the entry
    points eager ([bench] runs it graphed) → the launches of (1). The
    eager path itself is not bit for bit from call to call (keypoints
    move by an ulp); with cuDNN's deterministic engines it is, and so are
    the replays."""
    import io

    import detectandtrack_tpu_torch.bench as bench
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.graphs import GraphedFunction
    from detectandtrack_tpu_torch.engine.inference import (make_detect_fn,
                                                            read_back)
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.utils.env import card_line
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes

    wall0 = time.perf_counter()
    card = card_line()
    cfg = load_cfg(os.path.join(REPO, BOX_CFG))
    b, t, (h, w) = 2, cfg.VIDEO.NUM_FRAMES, cfg.TEST.SHAPE_BUCKETS[0]
    model = build_model(cfg, device="cuda", seed=0)
    detect = make_detect_fn(model)
    if not isinstance(detect, GraphedFunction):
        raise RuntimeError("[graphs] make_detect_fn of a CUDA model is not "
                           "graphed")
    gen = torch.Generator(device="cuda").manual_seed(21)
    clips = [torch.randn((b, t, h, w, 3), device="cuda", generator=gen)
             for _ in range(2)]
    detect.eager(clips[0])                    # cuDNN plans, device constants
    _sync_free(torch, "[graphs] main path", detect.eager, clips[1])

    def request(fn, c, log):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn(c)
        end.record()
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, start.elapsed_time(end) / 1e3))

    times = {"eager": [], "graphed": []}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for i in range(GRAPH_TIMED):
        request(detect.eager, clips[i % 2], times["eager"])
    peak_eager = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    detect(clips[0])                          # warm-up and capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _reset_counters()
    diff, eager_diff = {}, {}
    for c in clips:
        want = detect.eager(c)
        for k, v in _outputs_match(torch, "[graphs] main path", detect(c),
                                   want).items():
            diff[k] = max(v, diff.get(k, 0.0))
        for k, v in _outputs_match(torch, "[graphs] main path, eager twice",
                                   detect.eager(c), want).items():
            eager_diff[k] = max(v, eager_diff.get(k, 0.0))
    launches, nms = _read_counters(), _check_nms("[graphs] main path",
                                                model, 6)
    epilogues = _check_epilogue("[graphs] main path", model, 6)
    per_call = {"conv1": 1, "conv1_f32": 0, "roi_align": len(_heads(model)),
                "roi_align_backward": 0, "roi_align_backward_prep": 0}
    if launches != {k: 6 * v for k, v in per_call.items()} or \
            detect.replays != 2:
        raise RuntimeError(f"[graphs] 4 eager calls and 2 replays: launches "
                           f"{launches}, {detect.replays} replays")
    # cuDNN restricted to its deterministic engines: the eager path repeats
    # itself bit for bit, and the replay must equal it bit for bit.
    with _cudnn_deterministic(torch):
        det = make_detect_fn(model)
        det(clips[0])                         # warm-up and capture
        for c in clips:
            want = det.eager(c)
            for got in (det(c), det.eager(c)):
                diff_d = _outputs_match(
                    torch, "[graphs] main path, deterministic cuDNN", got,
                    want)
                if diff_d:
                    raise RuntimeError(f"[graphs] with cuDNN's deterministic "
                                       f"engines, a replay or a repeated "
                                       f"eager call differs: {diff_d}")
        del det, want, got
    torch.cuda.reset_peak_memory_stats()
    for mode in ("graphed", "graphed", "eager"):
        fn = detect if mode == "graphed" else detect.eager
        for i in range(GRAPH_TIMED):
            request(fn, clips[i % 2], times[mode])
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    med = {m: (statistics.median(x for x, _ in v),
               statistics.median(y for _, y in v)) for m, v in times.items()}
    busy = med["graphed"][1]
    print(f"[graphs] main path {BOX_CFG} bf16 B={b} {t}x{h}x{w} ({card}): "
          f"graphed outputs vs eager on 2 requests: bit for bit but "
          f"{diff or 'none'} (max |difference|; the same eager call twice: "
          f"bit for bit but {eager_diff or 'none'}; with cuDNN's "
          f"deterministic engines, replays and repeated eager calls equal "
          f"bit for bit); no host sync in an "
          f"eager call under set_sync_debug_mode(\"error"
          f"\"); launches of 4 eager calls + 2 replays {launches}, NMS "
          f"kernels {nms}, conv epilogues {epilogues}; request s (median of {2 * GRAPH_TIMED}): eager "
          f"{med['eager'][0]:.4f}, graphed {med['graphed'][0]:.4f} "
          f"({med['eager'][0] / med['graphed'][0]:.2f}x); graphed request's "
          f"CUDA-event span {busy:.4f} s, so the card idles >= "
          f"{100 * (1 - busy / med['eager'][0]):.1f}% of an eager request "
          f"and {100 * max(0.0, 1 - busy / med['graphed'][0]):.1f}% of a "
          f"graphed one; first graphed call (eager warm-up + capture) "
          f"{capture_s:.2f} s; peak memory eager {peak_eager / 2 ** 30:.2f} "
          f"GiB allocated, graphed {held / 2 ** 30:.2f} GiB reserved after "
          f"empty_cache (parameters, graph pool, static buffers)", flush=True)
    out = launches
    del model, detect, clips
    torch.cuda.empty_cache()

    # (2) the bench's infer path at B=4.
    bcfg = bench.infer_cfg()
    model = build_model(bcfg, device="cuda", seed=0)
    nb, bt = 4, bcfg.VIDEO.NUM_FRAMES
    clips = torch.randn((nb, bt, h, w, 3), device="cuda", generator=gen)
    tubes = torch.as_tensor(make_realistic_tubes(
        nb, bcfg.RPN.POST_NMS_TOP_N_TEST, bt, h, w)).cuda()
    detect = make_detect_fn(model, with_proposals=True, run_rpn=True)
    detect.eager(clips, tubes)
    _sync_free(torch, "[graphs] bench path", detect.eager, clips, tubes)
    detect(clips, tubes)                      # warm-up and capture
    want = detect.eager(clips, tubes)
    bdiff = _outputs_match(torch, "[graphs] bench path", detect(clips, tubes),
                           want)
    beager = _outputs_match(torch, "[graphs] bench path, eager twice",
                            detect.eager(clips, tubes), want)
    del want

    def fetch(o):
        read_back({k: o[k] for k in bench._OUTS if k in o})

    iters = int(BENCH_ENV["BENCH_ITERS"])
    rates = {"eager": [], "graphed": []}
    for mode in ("graphed", "eager", "eager", "graphed"):
        fn = detect if mode == "graphed" else detect.eager
        dt = bench._timed(fn, (clips, tubes), iters, fetch)
        rates[mode].append(nb * iters / dt)
    print(f"[graphs] bench infer path (with_proposals, run_rpn) B={nb} "
          f"{bt}x{h}x{w} ({card}): graphed outputs vs eager: bit for bit "
          f"but {bdiff or 'none'} (eager twice: bit for bit but "
          f"{beager or 'none'}); no host sync in an eager call; "
          f"double-buffered clips/s "
          f"({iters} calls, bench._timed) eager "
          f"{[round(r, 3) for r in rates['eager']]}, graphed "
          f"{[round(r, 3) for r in rates['graphed']]}", flush=True)
    del model, detect, clips, tubes
    torch.cuda.empty_cache()

    # (3) the bench's stream with the entry points eager ([bench] runs it
    # graphed in this call).
    buf = io.StringIO()
    with _bench_env(BENCH_ENV), contextlib.redirect_stdout(buf), \
            _eager_entry_points():
        bench.bench_stream("cuda")
    line = _bench_line("[graphs] stream eager", buf.getvalue())
    torch.cuda.empty_cache()
    print(f"[graphs] bench stream B=1 2x{BENCH_ENV['BENCH_STREAM_FRAMES']} "
          f"frames, entry points eager ({card}): p50 {line['value']} ms, "
          f"p95 {line['p95_ms']} ms, {line['fps_end_to_end']} frames/s "
          f"([bench] stream below: graphed); phase wall "
          f"{time.perf_counter() - wall0:.1f} s", flush=True)
    return out


BENCH_ENV = {"BENCH_ITERS": "10",         # the bench's defaults, uncut: the
             "BENCH_STREAM_FRAMES": "64"}  # three modes take about 70 s
BENCH_TIMEOUT = 600         # s for the `launch --mode bench` subprocess


@contextlib.contextmanager
def _bench_env(values):
    """The BENCH_* environment of the port's bench: its defaults but
    `values`; restored after."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(values)
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


@contextlib.contextmanager
def _plain_kernels():
    """conv1 and K1 replaced by their plain versions (on CUDA tensors too),
    counted by the same FLOP rule as the kernels' entry points."""
    from detectandtrack_tpu_torch.kernels import conv1 as c1
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.utils.flops import counted
    saved = c1.conv1, ra.roi_align_multilevel
    c1.conv1 = counted(c1.conv1.work)(c1.conv1_reference)
    ra.roi_align_multilevel = counted(ra.roi_align_multilevel.work)(
        ra.roi_align_multilevel_reference)
    try:
        yield
    finally:
        c1.conv1, ra.roi_align_multilevel = saved


def _bench_line(tag, text):
    lines = [line for line in text.splitlines() if line.startswith("{")]
    if len(lines) != 1:
        raise RuntimeError(f"{tag}: {len(lines)} JSON lines, expected 1: "
                           f"{text[-2000:]}")
    line = json.loads(lines[0])
    if "error" in line:
        raise RuntimeError(f"{tag}: {line['error']}")
    return line


def phase_bench(torch):
    """The port's bench (`detectandtrack_tpu_torch/bench.py`) in-process at
    its default full width (R-50, T=8, 800x1344; infer B=4, train and
    stream B=1) and BENCH_ENV, each mode's line checked: value
    finite and positive, MFU in (0, 100], the loss finite, every streamed
    frame, the launch counters those of the mode's calls. Inside infer,
    the FLOP count of one B=1 call on the kernel path equals the count of
    the same call with the plain conv1 and RoIAlign (whose launches are
    left out). Then `launch --mode bench` (infer, 2 iterations) as a
    subprocess: exit 0 and one line → launches of the in-process runs."""
    import io
    import subprocess

    import detectandtrack_tpu_torch.bench as bench
    from detectandtrack_tpu_torch.utils.env import card_line

    counted_flops = bench.count_flops
    checked = []
    excluded = {}

    def count_and_check(fn, *args):
        flops = counted_flops(fn, *args)
        if not checked:                    # the realistic call, once
            one = [a[:1] for a in args]
            before = _read_counters()
            kern = counted_flops(fn, *one)
            mid = _read_counters()
            with _plain_kernels():
                plain = counted_flops(fn, *one)
            after = _read_counters()
            if mid == before or after != mid:
                raise RuntimeError(f"[bench] FLOP check: launches {before} "
                                   f"-> {mid} (kernel path) -> {after} "
                                   "(plain path)")
            if kern != plain:
                raise RuntimeError(f"[bench] FLOP count of one B=1 infer "
                                   f"call: kernel path {kern!r}, plain "
                                   f"conv1 and RoIAlign {plain!r}")
            _add(excluded, {k: mid[k] - before[k] for k in mid})
            checked.append(kern)
        return flops

    iters = int(BENCH_ENV["BENCH_ITERS"])
    frames = int(BENCH_ENV["BENCH_STREAM_FRAMES"])
    t = 8
    calls = {"infer": 2 * (iters + 2),    # count, warm-up, iters; x2 paths
             "train": iters + 2,          # count, warm-up, iters
             "stream": 2 * _windows(frames, t)}
    total = {}
    bench.count_flops = count_and_check
    try:
        with _bench_env(BENCH_ENV):
            for mode, fn in (("infer", bench.bench_infer),
                             ("train", bench.bench_train),
                             ("stream", bench.bench_stream)):
                torch.cuda.synchronize()
                _reset_counters()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    fn("cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _read_counters()
                if mode == "infer":
                    launches = {k: v - excluded[k]
                                for k, v in launches.items()}
                line = _bench_line(f"[bench] {mode}", buf.getvalue())
                if mode == "infer":
                    print(f"[bench] FLOP count of one B=1 infer call: "
                          f"{checked[0]!r} on the kernel path, equal to the "
                          f"plain conv1 and RoIAlign path's; kernel launches "
                          f"of that check, left out: {excluded}", flush=True)
                n = calls[mode]
                want = {"conv1": n, "conv1_f32": 0, "roi_align": 2 * n,
                        "roi_align_backward": 2 * n if mode == "train"
                        else 0,
                        "roi_align_backward_prep": 2 * n if mode == "train"
                        else 0}
                if launches != want:
                    raise RuntimeError(f"[bench] {mode}: launch counters "
                                       f"{launches}, expected {want}")
                value = line["value"]
                if not (isinstance(value, (int, float))
                        and np.isfinite(value) and value > 0):
                    raise RuntimeError(f"[bench] {mode}: value {value!r}")
                for key in ("mfu_pct", "mfu_pct_degenerate"):
                    if mode != "stream" and key in line and not (
                            line[key] is not None and 0 < line[key] <= 100):
                        raise RuntimeError(f"[bench] {mode}: {key} "
                                           f"{line[key]!r} outside (0, 100]")
                if mode == "train" and not np.isfinite(line["loss_total"]):
                    raise RuntimeError(f"[bench] train: loss_total "
                                       f"{line['loss_total']!r}")
                if mode == "stream" and line["frames"] != 2 * frames:
                    raise RuntimeError(f"[bench] stream: {line['frames']} "
                                       f"frames, expected {2 * frames}")
                _add(total, launches)
                print(f"[bench] {mode} ({line['card']}), {wall:.1f} s in "
                      f"all, launches {launches}: {json.dumps(line)}",
                      flush=True)
                del buf
                torch.cuda.empty_cache()
    finally:
        bench.count_flops = counted_flops
    if not checked:
        raise RuntimeError("[bench] the FLOP check never ran")

    argv = [sys.executable, "-m", "detectandtrack_tpu_torch.cli.launch",
            "--mode", "bench"]
    with _bench_env({"BENCH_MODE": "infer", "BENCH_ITERS": "2"}):
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=REPO, capture_output=True,
                              text=True, timeout=BENCH_TIMEOUT,
                              env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise RuntimeError(f"[bench] launch --mode bench: exit "
                           f"{proc.returncode}: {proc.stderr[-3000:]}")
    line = _bench_line("[bench] launch --mode bench", proc.stdout)
    print(f"[bench] launch --mode bench (BENCH_ITERS=2, {card_line()}): "
          f"exit 0 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(line)}", flush=True)
    return total


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
    _check_nms(tag, model, n_steps, train=True)
    epilogues = _check_epilogue(tag, model, n_steps, train=True)
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
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}, conv epilogues "
          f"{epilogues}; {moved}/"
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
    different f32 rounding. A ReLU's gradient jumps where its input
    crosses zero, so an input within rounding of zero makes a step's
    gradients differ by a whole term (tools/parity_ties.py: one ulp of
    noise on conv1's output flips up to two of the golden step's ReLU
    decisions, at 2e-8 to 5e-7 of their tensor's max, and moves a gradient
    by up to 1.9e-2 of its max). So the CPU step takes each ReLU's
    decision (x > 0) from the card's step, call by call, and every
    decision where the CPU's own input disagrees must sit within
    RELU_TIE_TOL of its tensor's max |x|. Losses 1e-4; every gradient
    GRAD_REL_TOL of its largest entry, or the case's own bound across the
    libraries."""
    import torch.nn.functional as F
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.models.detector import build_model

    relu = F.relu

    class ReluAs(torch.autograd.Function):
        """ReLU with its decision given: x where `keep`, else 0, and the
        gradient where `keep`."""

        @staticmethod
        def forward(ctx, x, keep):
            ctx.save_for_backward(keep)
            return torch.where(keep, x, torch.zeros_like(x))

        @staticmethod
        def backward(ctx, grad):
            keep, = ctx.saved_tensors
            return torch.where(keep, grad, torch.zeros_like(grad)), None

    def one_step(cfg, batch, dev, decisions=None):
        """→ (losses, gradients, the ReLU decisions, ties). Without
        `decisions` each F.relu runs as it is and its decision is kept;
        with them each call takes its decision from the list, and a call
        where its own decision differs adds (elements that differ, their
        largest |x| over the tensor's max |x|) to the ties."""
        kept, ties = [], []

        def step_relu(x, inplace=False):
            if decisions is None:
                kept.append((x > 0).cpu())
                return relu(x, inplace)
            keep = decisions[len(kept)].to(x.device)
            kept.append(keep)
            if keep.shape != x.shape:
                raise RuntimeError(f"train parity: ReLU {len(kept)} takes "
                                   f"{tuple(x.shape)} on the CPU, "
                                   f"{tuple(keep.shape)} on the card")
            differ = (x > 0) != keep
            if bool(differ.any()):
                ties.append((int(differ.sum()), (
                    x[differ].abs().max() / x.abs().max()).item()))
            return ReluAs.apply(x, keep)

        model = build_model(cfg, device=dev, seed=0, train=True)
        state = create_train_state(cfg, model)
        F.relu = step_relu
        try:
            state, metrics = make_train_step(model, cfg)(
                state, {k: v.to(dev) for k, v in batch.items()})
        finally:
            F.relu = relu
        if decisions is not None and len(kept) != len(decisions):
            raise RuntimeError(f"train parity: {len(kept)} ReLU calls on "
                               f"the CPU, {len(decisions)} on the card")
        return ({k: float(v) for k, v in metrics.items()},
                # No gradient (C4's unused res5) counts as zero.
                {k: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).cpu()
                 for k, p in state.params.items()}, kept, ties)

    for label, path, opts, cudnn_tol in PARITY_TRAIN_CASES:
        cfg = load_cfg(path and os.path.join(REPO, path), opts=opts)
        batch = _train_batch(torch, cfg, 2, 64, 96, 10, 3, seed=8)
        for convs, tol in (("cuDNN vs oneDNN", cudnn_tol),
                           ("torch's convs on both", GRAD_REL_TOL)):
            libs = convs == "cuDNN vs oneDNN"
            torch.backends.mkldnn.enabled = torch.backends.cudnn.enabled = libs
            try:
                gpu_loss, gpu_grad, decisions, _ = one_step(cfg, batch, "cuda")
                cpu_loss, cpu_grad, _, ties = one_step(cfg, batch, "cpu",
                                                       decisions)
            finally:
                torch.backends.mkldnn.enabled = True
                torch.backends.cudnn.enabled = True
            tie = max((r for _, r in ties), default=0.0)
            if not tie <= RELU_TIE_TOL:
                raise RuntimeError(f"train parity {label} {convs}: a ReLU "
                                   f"decides otherwise on the card at "
                                   f"{tie:.3g} of its input's max > "
                                   f"{RELU_TIE_TOL}")
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
                  f"{GRAD_FLOOR}); {len(decisions)} ReLUs, "
                  f"{sum(n for n, _ in ties)} decisions the card's, the "
                  f"largest at {tie:.3g} of its input's max (tol "
                  f"{RELU_TIE_TOL})", flush=True)


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
    from detectandtrack_tpu_torch.utils import roofline
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
                bound_ms, bound_by = roofline.bound(roofline.backward_work(
                    grad, bwd_shapes, dtype))
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


SOFT_NMS_BUDGETS = (8, 52)   # the CPU test's budgets; 52 > N pads


def phase_surface_ops(torch):
    """The ops the port took last from the JAX package, on the card: each
    on CUDA tensors against the same op on the CPU (flips, indices and
    masks equal, IoU and scores 1e-6; the copied numpy heatmap decode
    against the CUDA decode at 1e-4 + 1e-6 of |value|: image coordinates
    reach 1500 px, where an f32 ulp is 1.2e-4); soft_nms_fixed against the
    sequential soft_nms_scan on CUDA on the CPU test's soft-NMS cases (3
    lanes of 40 boxes, both methods, both budgets); then the parity tool
    end to end: [finetune]'s 2D R-50 FPN .pkl imported into the main
    config and [dataset]'s 720x1280 set streamed, once diffing against an
    empty Detectron file (which writes the tool's detections), then
    against those detections rewritten in Detectron's form: the same
    detections and metrics, keypoint delta 0, best IoU 1 on every box the
    diff's +1 convention gives an area → the launches of the two tool
    runs."""
    import io
    import pickle
    import shutil

    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.data.posetrack import get_dataset
    from detectandtrack_tpu_torch.ops import boxes as tboxes
    from detectandtrack_tpu_torch.ops import keypoints as tkps
    from detectandtrack_tpu_torch.ops import nms as tnms
    from detectandtrack_tpu_torch.tools import parity_check
    from detectandtrack_tpu_torch.utils.env import card_line
    from detectandtrack_tpu_torch.utils.synthetic import (SOFT_NMS_CASES,
                                                          soft_nms_case)

    t_phase = time.perf_counter()
    card = card_line()

    def same(tag, got, want, tol=0.0, rtol=0.0):
        diff = (got.cpu().double() - want.double()).abs()
        err = diff.max().item() if got.numel() else 0.0
        if got.shape != want.shape or got.dtype != want.dtype or not bool(
                (diff <= tol + rtol * want.double().abs()).all()):
            raise RuntimeError(f"[surface-ops] {tag}: CUDA vs CPU "
                               f"{tuple(got.shape)} {got.dtype} vs "
                               f"{tuple(want.shape)} {want.dtype}, "
                               f"max_abs_err {err} (tol {tol} + {rtol} of "
                               "|CPU|)")
        return err

    rng = np.random.default_rng(21)
    xy = rng.uniform(0, 1200, (3, 300, 2))
    wh = rng.uniform(4, 300, (3, 300, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32))
    other = boxes + torch.from_numpy(rng.normal(0, 8, boxes.shape).astype(
        np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (3, 300)).astype(np.float32))
    classes = torch.from_numpy(rng.integers(0, 3, (3, 300)))
    valid = torch.from_numpy(rng.uniform(size=(3, 300)) > 0.2)
    heat = torch.from_numpy(rng.normal(size=(20, 15, 56, 56)).astype(
        np.float32))
    rois = boxes[0, :20]
    dev = [x.cuda() for x in (boxes, other, scores, classes, valid, heat,
                              rois)]
    errs = {"flip_boxes": same("flip_boxes", tboxes.flip_boxes(dev[0], 1280),
                               tboxes.flip_boxes(boxes, 1280)),
            "bbox_iou_pairwise": same(
                "bbox_iou_pairwise", tboxes.bbox_iou_pairwise(dev[0], dev[1]),
                tboxes.bbox_iou_pairwise(boxes, other), 1e-6),
            "flip_heatmaps": same("flip_heatmaps",
                                  tkps.flip_heatmaps(dev[5]),
                                  tkps.flip_heatmaps(heat))}
    for name, got, want in (
            ("batched_nms_fixed",
             tnms.batched_nms_fixed(dev[0], dev[2], dev[3], 0.5, 100, dev[4]),
             tnms.batched_nms_fixed(boxes, scores, classes, 0.5, 100, valid)),
            ("soft_nms_scan",
             tnms.soft_nms_scan(dev[0], dev[2], 100, method="gaussian",
                                valid=dev[4]),
             tnms.soft_nms_scan(boxes, scores, 100, method="gaussian",
                                valid=valid))):
        for part, g, w in zip(("indices", "masks", "scores"), got, want):
            errs[f"{name} {part}"] = same(f"{name} {part}", g, w,
                                          1e-6 if part == "scores" else 0.0)
    errs["heatmaps_to_keypoints_numpy"] = same(
        "heatmaps_to_keypoints_numpy vs the CUDA decode",
        tkps.heatmaps_to_keypoints(dev[5], dev[6]),
        torch.from_numpy(tkps.heatmaps_to_keypoints_numpy(heat.numpy(),
                                                          rois.numpy())),
        1e-4, 1e-6)
    print(f"[surface-ops] new ops on CUDA vs the CPU (3 lanes of 300 boxes, "
          f"20x15x56x56 heatmaps; flips, indices and masks equal, IoU and "
          f"scores 1e-6, the numpy decode 1e-4 + 1e-6 of |x|): max_abs_err "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }", flush=True)

    worst, n_cases = 0.0, 0
    for case in SOFT_NMS_CASES:
        case_rng = np.random.default_rng(11)
        lanes = [soft_nms_case(case, case_rng) for _ in range(3)]
        b, sc, v = (torch.from_numpy(np.stack([l[i] for l in lanes])).cuda()
                    for i in range(3))
        for method in ("linear", "gaussian"):
            for max_out in SOFT_NMS_BUDGETS:
                kw = dict(sigma=0.5, iou_thresh=0.3, score_thresh=0.05,
                          method=method, valid=v)
                fixed = tnms.soft_nms_fixed(b, sc, max_out, **kw)
                scan = tnms.soft_nms_scan(b, sc, max_out, **kw)
                tag = f"soft_nms_fixed vs soft_nms_scan {case} {method} " \
                      f"{max_out}"
                if not (torch.equal(fixed[0], scan[0])
                        and torch.equal(fixed[1], scan[1])):
                    raise RuntimeError(f"[surface-ops] {tag}: indices or "
                                       f"masks differ: {fixed[:2]} vs "
                                       f"{scan[:2]}")
                err = (fixed[2] - scan[2]).abs().max().item()
                if not err <= 1e-6:
                    raise RuntimeError(f"[surface-ops] {tag}: scores "
                                       f"max_abs_err {err} > 1e-6")
                worst, n_cases = max(worst, err), n_cases + 1
    print(f"[surface-ops] soft_nms_fixed equals soft_nms_scan on CUDA in "
          f"{n_cases} cases ({', '.join(SOFT_NMS_CASES)}; linear and "
          f"gaussian; budgets {SOFT_NMS_BUDGETS}; 3 lanes of 40 boxes): "
          f"indices and masks equal, scores max_abs_err {worst:.3g} "
          f"(tol 1e-6)", flush=True)

    # The parity tool, end to end on the card.
    shutil.rmtree(PARITY_DIR, ignore_errors=True)
    os.makedirs(PARITY_DIR)
    hard = os.path.join(DATASET_DIR, "data", "synthetic_hard")
    ds = get_dataset("posetrack_synthetic_hard_val",
                     os.path.join(DATASET_DIR, "data"))
    t = load_cfg(os.path.join(REPO, BOX_CFG)).VIDEO.NUM_FRAMES
    n_win = sum(_windows(len(ds.video_frames(vid)), t) for vid in ds.videos())
    n_frames = sum(len(ds.video_frames(vid)) for vid in ds.videos())
    want = {"conv1": n_win, "conv1_f32": 0, "roi_align": 2 * n_win,
            "roi_align_backward": 0, "roi_align_backward_prep": 0}
    empty = os.path.join(PARITY_DIR, "empty_detections.pkl")
    with open(empty, "wb") as f:
        pickle.dump({"all_boxes": [[], []], "all_keyps": [[], []]}, f)
    ref = os.path.join(PARITY_DIR, "detections.pkl")
    argv = ["--pkl", FINETUNE_PKL, "--ann", os.path.join(hard, "val.json"),
            "--frames", hard, "--cfg", os.path.join(REPO, BOX_CFG),
            "--out", os.path.join(PARITY_DIR, "run"), "--device", "cuda"]
    total, printed, walls, dets = {}, [], [], []
    # With cuDNN's default engines two runs' keypoints came apart by
    # rounding on an H100; its deterministic engines make them equal.
    with _cudnn_deterministic(torch):
        for ref_dets in (empty, ref):
            torch.cuda.synchronize()
            _reset_counters()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = parity_check.main(argv + ["--ref-dets", ref_dets])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = _read_counters()
            if launches != want or rc not in (0, 1):
                raise RuntimeError(f"[surface-ops] parity_check: rc {rc}, "
                                   f"launch counters {launches}, expected "
                                   f"{want}")
            _add(total, launches)
            printed.append(parity_check.printed_reports(out.getvalue()))
            with open(os.path.join(PARITY_DIR, "run", "our_dets.pkl"),
                      "rb") as f:
                dets.append(pickle.load(f))
            if ref_dets == empty:
                detectron = parity_check.to_detectron_detections(dets[0])
                with open(ref, "wb") as f:
                    pickle.dump(detectron, f)
    (metrics, _), (metrics2, diff) = printed
    bad = [k for k in ("mAP", "MOTA") if not np.isfinite(metrics[k])]
    changed = [(vid, i, key) for vid in dets[0]
               for i, (a, b) in enumerate(zip(dets[0][vid], dets[1][vid]))
               for key in a if not np.array_equal(a[key], b[key])]
    # The diff scores a box against itself at IoU 1 only where its +1
    # convention gives it an area of at least 1e-9 px² (the diff's floor);
    # random weights may emit boxes without one.
    ref_boxes = np.concatenate(detectron["all_boxes"][1])
    w, h = (ref_boxes[:, 2] - ref_boxes[:, 0] + 1,
            ref_boxes[:, 3] - ref_boxes[:, 1] + 1)
    proper = (w > 0) & (h > 0) & (w * h >= 1e-9)
    want_diff = {"ref_images_compared": n_frames,
                 "mean_best_iou": round(float(proper.mean()), 4),
                 "mean_kp_px_delta": 0.0}
    if bad or changed or metrics2 != metrics or diff != want_diff:
        raise RuntimeError(f"[surface-ops] parity_check: metrics {metrics} "
                           f"then {metrics2}, detections changed between "
                           f"the runs at {changed[:5]}, diff {diff} (want "
                           f"{want_diff})")
    shutil.rmtree(PARITY_DIR, ignore_errors=True)
    os.remove(FINETUNE_PKL)
    print(f"[surface-ops] parity_check on the card: {FINETUNE_2D_CFG} .pkl "
          f"-> {BOX_CFG}, {n_frames} frames of [dataset]'s 720x1280 set "
          f"streamed twice (tool wall {walls[0]:.1f} s and {walls[1]:.1f} "
          f"s): mAP {metrics['mAP']:.2f}, MOTA {metrics['MOTA']:.2f}, "
          f"equal detections in both runs; diff against its own detections "
          f"in Detectron's form {diff}: {len(proper)} boxes, "
          f"{int((~proper).sum())} of them without a +1-convention area of "
          f"1e-9 px², every other at IoU 1; "
          f"launches {total}", flush=True)
    print(f"[surface-ops] phase wall {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)
    return total


@contextlib.contextmanager
def _cudnn_deterministic(torch):
    """cuDNN restricted to its deterministic engines inside the `with`."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


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


DATASET_CFG = "configs/video/track_3d_R50_hungarian.yaml"
TTA_CFG = "configs/video/2d_R101_FPN_kps_multiscale_tta.yaml"
DATASET_DIR = os.path.join(REPO, "out_smoke")       # gitignored (/out*/)
DATASET_HW = (720, 1280)     # PoseTrack's common frame size
TTA_HW = (480, 640)          # routes the TTA config's 3 scales to 3 buckets
# Random weights score below the tracking config's 0.5 filter; 0.05 (the
# detection threshold) links them, so the stream-vs-two-pass check sees
# real track ids. Nothing else of the config changes.
DATASET_OPTS = ["TRACKING.CONF_FILTER_INITIAL_DETS", "0.05"]
TTA_OPTS: list = []


def _merge_sets(out_dir, parts, name):
    """Merge generated set files into one `name` (image ids offset)."""
    merged = None
    for part in parts:
        with open(os.path.join(out_dir, part)) as f:
            doc = json.load(f)
        if merged is None:
            merged = doc
            continue
        off = max(im["id"] for im in merged["images"])
        for im in doc["images"]:
            im["id"] += off
        for an in doc["annotations"]:
            an["image_id"] += off
        merged["images"] += doc["images"]
        merged["annotations"] += doc["annotations"]
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(merged, f)


def _hard_set(data):
    """The hard synthetic set at DATASET_HW under `data`: three videos of
    13 frames and one of 5, as posetrack_synthetic_hard_val."""
    from detectandtrack_tpu_torch.data.synthetic import (
        generate_synthetic_posetrack)
    hard = os.path.join(data, "synthetic_hard")
    generate_synthetic_posetrack(hard, num_videos=3, frames_per_video=13,
                                 image_hw=DATASET_HW, seed=0, hard=True,
                                 json_name="long.json")
    generate_synthetic_posetrack(hard, num_videos=1, frames_per_video=5,
                                 image_hw=DATASET_HW, seed=1, hard=True,
                                 json_name="short.json", video_prefix="short")
    _merge_sets(hard, ["long.json", "short.json"], "val.json")


def _windows(n_frames, span):
    """run_inference's tiling: non-overlapping windows, an end-aligned
    tail, one padded window for a video shorter than the span."""
    if n_frames < span:
        return 1
    return len(range(0, n_frames - span + 1, span)) + int(
        (n_frames - span) % span != 0)


class _Instrumented:
    """Wraps the port's `run_inference` (its wall time), `load_clip` (the
    host's decode, resize and normalise of each clip), `make_detect_fn`
    and `make_kps_aug_fns` (CUDA events around every model call) and
    `StreamingTrackingSink` (every (video, ordinal) it receives) for the
    CLI runs inside the `with` block; restores them after."""

    def __init__(self, torch):
        self.torch = torch
        self.events, self.walls, self.sunk, self.loads = [], [], [], []

    def __enter__(self):
        from detectandtrack_tpu_torch.engine import inference as tinf
        from detectandtrack_tpu_torch.tracking import engine as teng
        self.saved = [(tinf, "run_inference", tinf.run_inference),
                      (tinf, "make_detect_fn", tinf.make_detect_fn),
                      (tinf, "make_kps_aug_fns", tinf.make_kps_aug_fns),
                      (teng, "StreamingTrackingSink",
                       teng.StreamingTrackingSink),
                      (tinf, "load_clip", tinf.load_clip)]
        torch, inst = self.torch, self

        def timed(fn, kind):
            def call(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                inst.events.append((kind, start, end))
                return out
            return call

        def run_inference(*args, **kw):
            t0 = time.perf_counter()
            out = self.saved[0][2](*args, **kw)
            torch.cuda.synchronize()
            inst.walls.append(time.perf_counter() - t0)
            return out

        def make_detect_fn(*args, **kw):
            return timed(self.saved[1][2](*args, **kw), "detect")

        def make_kps_aug_fns(*args, **kw):
            hm, dec = self.saved[2][2](*args, **kw)
            return timed(hm, "kps_aug heatmaps"), timed(dec, "kps_aug decode")

        def load_clip(*args, **kw):
            t0 = time.perf_counter()
            out = self.saved[4][2](*args, **kw)
            inst.loads.append(time.perf_counter() - t0)
            return out

        class Sink(self.saved[3][2]):
            def __call__(self, vid, ordinal, total, frame):
                inst.sunk.append((vid, ordinal, total))
                return super().__call__(vid, ordinal, total, frame)

        tinf.run_inference = run_inference
        tinf.make_detect_fn = make_detect_fn
        tinf.make_kps_aug_fns = make_kps_aug_fns
        teng.StreamingTrackingSink = Sink
        tinf.load_clip = load_clip
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def batch_ms(self, kind="detect"):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for k, s, e in self.events if k == kind]


def _cli_run(torch, tag, mode, cfg_path, out, opts, batch, want=None):
    """One port CLI call `--mode mode` on the card; with `want`, the launch
    counters of the run must equal it → (launches, wall s, peak GiB)."""
    return _cli_counted(torch, [
        "--mode", mode, "--cfg", os.path.join(REPO, cfg_path), "--out", out,
        "--batch-size", str(batch)] + opts, want, f"[dataset] {tag}")[1:]


def _check_dataset_dets(tag, dets, ds, d):
    """Every frame of every video once, finite boxes, scores, keypoints of
    the static per-frame shapes; some detection valid → the valid count."""
    from detectandtrack_tpu_torch.utils.io import load_object
    dets = load_object(dets)
    if sorted(dets) != ds.videos():
        raise RuntimeError(f"{tag}: videos {sorted(dets)}")
    n_valid = 0
    for vid, frames in dets.items():
        if len(frames) != len(ds.video_frames(vid)):
            raise RuntimeError(f"{tag}: {vid} has {len(frames)} frames of "
                               f"{len(ds.video_frames(vid))}")
        for fr in frames:
            shapes = {"boxes": (d, 4), "scores": (d,), "keypoints": (d, 15, 3)}
            for key, shape in shapes.items():
                if fr[key].shape != shape or not np.isfinite(fr[key]).all():
                    raise RuntimeError(f"{tag}: {vid} {key} {fr[key].shape} "
                                       "not finite or of the wrong shape")
            n_valid += int(fr["valid"].sum())
    if n_valid == 0:
        raise RuntimeError(f"{tag}: no valid detection")
    return n_valid


def _json_load(path):
    with open(path) as f:
        return json.load(f)


def _finite_metrics(tag, path, keys):
    metrics = _json_load(path)
    bad = [k for k in keys if not np.isfinite(metrics.get(k, float("nan")))]
    if bad:
        raise RuntimeError(f"{tag}: {path} metrics {bad} missing or not "
                           f"finite: {metrics}")
    return {k: metrics[k] for k in keys}


def phase_dataset(torch):
    """The dataset-level path through the port's CLI at full width, bf16,
    seeded random weights: a hard synthetic PoseTrack set at 720x1280
    (three videos of 13 frames, one of 5) under the main tracking config
    (3D R-50 T=8, bucket 800x1344): --mode test at batch 2 (7 windows, 4
    batches, the last padded), track, eval, then stream; the same set
    through TEST.PROPOSAL_FILES (GT boxes as proposals); and a 480x640 set
    through the multi-scale flip TTA + KPS_AUG config (three scales, three
    buckets). Checked: launch counters derived from the windows and
    batches, every frame once, finite outputs and metrics, the stream's
    track ids equal test + track's, eval of the written tracks equal to
    track's metrics → the launches summed over the four model runs."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.data.posetrack import get_dataset
    from detectandtrack_tpu_torch.data.synthetic import (
        generate_synthetic_posetrack)
    from detectandtrack_tpu_torch.tracking.engine import (
        read_posetrack_results)
    from detectandtrack_tpu_torch.utils.io import save_object

    from detectandtrack_tpu_torch.utils.env import card_line
    t_phase = time.perf_counter()
    card = card_line()
    data = os.path.join(DATASET_DIR, "data")
    _hard_set(data)
    opts = DATASET_OPTS + ["DATA.ROOT", data,
                           "TEST.DATASETS", "[posetrack_synthetic_hard_val]"]
    cfg = load_cfg(os.path.join(REPO, DATASET_CFG), opts=opts)
    ds = get_dataset("posetrack_synthetic_hard_val", data)
    t, b, d = cfg.VIDEO.NUM_FRAMES, 2, cfg.TEST.DETECTIONS_PER_IM
    n_frames = sum(len(ds.video_frames(v)) for v in ds.videos())
    n_win = sum(_windows(len(ds.video_frames(v)), t) for v in ds.videos())
    n_batch = -(-n_win // b)
    if (n_win, n_batch, n_frames) != (7, 4, 44):
        raise RuntimeError(f"[dataset] set: {n_win} windows, {n_batch} "
                           f"batches, {n_frames} frames")
    # Per batch: conv1 once, K1 at the box and the keypoint stage.
    want = {"conv1": n_batch, "conv1_f32": 0, "roi_align": 2 * n_batch,
            "roi_align_backward": 0, "roi_align_backward_prep": 0}
    out = {m: os.path.join(DATASET_DIR, m) for m in ("two", "one", "prop",
                                                    "tta")}
    print(f"[dataset] {card}; set: {len(ds.videos())} videos, {n_frames} "
          f"frames at {DATASET_HW[0]}x{DATASET_HW[1]} (hard synthetic), "
          f"{n_win} windows of T={t}, "
          f"{n_batch} batches of B={b}", flush=True)

    with _Instrumented(torch) as ins:
        launches, wall, peak = _cli_run(torch, "test", "test", DATASET_CFG,
                                        out["two"], opts, b, want)
    n_valid = _check_dataset_dets("[dataset] test", os.path.join(
        out["two"], "detections.pkl"), ds, d)
    batch_ms = ins.batch_ms()
    if len(batch_ms) != n_batch:
        raise RuntimeError(f"[dataset] test: {len(batch_ms)} model calls")
    det_m = _finite_metrics("[dataset] test", os.path.join(
        out["two"], "detection_metrics.json"),
        ["box_AP", "box_AP50", "keypoint_AP"])
    run_s = ins.walls[0]
    print(f"[dataset] test (bf16, B={b}): CLI {wall:.2f} s; run_inference "
          f"{run_s:.3f} s = {n_frames / run_s:.2f} frames/s end to end "
          f"(decode included); model per batch ms "
          f"{[round(x, 2) for x in batch_ms]} (median "
          f"{statistics.median(batch_ms):.2f}, sum {sum(batch_ms):.1f}: the "
          f"card busy {100 * sum(batch_ms) / 1e3 / run_s:.1f}% of the run at "
          f"most); host load_clip {len(ins.loads)} clips, "
          f"{sum(ins.loads):.3f} s (median "
          f"{1e3 * statistics.median(ins.loads):.1f} ms a clip of {t} "
          f"frames); peak memory {peak:.2f} GiB; launches {launches}; "
          f"{n_valid} valid detections; {det_m} ({card})", flush=True)

    for mode in ("track", "eval"):
        _cli_run(torch, mode, mode, DATASET_CFG, out["two"], opts, b)
    track_m = _finite_metrics("[dataset] track", os.path.join(
        out["two"], "track_metrics.json"), ["mAP", "MOTA"])
    if _json_load(os.path.join(out["two"], "track_metrics.json")) != (
            _json_load(os.path.join(out["two"], "eval_metrics.json"))):
        raise RuntimeError("[dataset] eval of the written tracks differs "
                           "from track's in-memory metrics")

    with _Instrumented(torch) as ins_s:
        stream_launches, stream_wall, _ = _cli_run(
            torch, "stream", "stream", DATASET_CFG, out["one"], opts, b, want)
    per_frame = {}
    for vid, ordinal, total in ins_s.sunk:
        per_frame[(vid, ordinal)] = per_frame.get((vid, ordinal), 0) + 1
        if total != len(ds.video_frames(vid)):
            raise RuntimeError(f"[dataset] stream: {vid} total {total}")
    if len(per_frame) != n_frames or set(per_frame.values()) != {1}:
        raise RuntimeError("[dataset] stream: frames not sunk exactly once")
    two = read_posetrack_results(os.path.join(out["two"], "tracks"))
    one = read_posetrack_results(os.path.join(out["one"], "tracks"))
    linked = 0
    for vid in two:
        if len(one.get(vid, [])) != len(two[vid]) or any(
                not np.array_equal(a["track_ids"], c["track_ids"])
                or not np.array_equal(a["boxes"], c["boxes"])
                for a, c in zip(one[vid], two[vid])):
            raise RuntimeError(f"[dataset] stream: {vid}'s track ids or boxes "
                               "differ from test + track")
        linked += sum(len(fr["track_ids"]) for fr in two[vid])
    if linked == 0 or set(one) != set(two):
        raise RuntimeError(f"[dataset] stream: {linked} tracked detections")
    if _json_load(os.path.join(out["one"], "track_metrics.json")) != (
            _json_load(os.path.join(out["two"], "track_metrics.json"))):
        raise RuntimeError("[dataset] stream metrics differ from track's")
    print(f"[dataset] track + eval: {track_m}, eval of the written tracks "
          f"equal; stream: CLI {stream_wall:.2f} s, run_inference "
          f"{ins_s.walls[0]:.3f} s ({n_frames / ins_s.walls[0]:.2f} "
          f"frames/s), {len(ins_s.sunk)} frames sunk once each, track ids "
          f"and boxes equal to test + track on {linked} tracked detections; "
          f"launches {stream_launches}", flush=True)

    # TEST.PROPOSAL_FILES: GT boxes (rows sorted by track id) as the tubes;
    # the RPN is skipped, K1 still runs at the box and keypoint stages.
    db = {vid: {i: np.array([p["box"] for p in sorted(
        ds.gt_poses(fr), key=lambda p: p["track_id"])], np.float32).reshape(
            -1, 4) for i, fr in enumerate(ds.video_frames(vid))}
          for vid in ds.videos()}
    prop_path = os.path.join(DATASET_DIR, "proposals.pkl")
    save_object(db, prop_path)
    with _Instrumented(torch) as ins_p:
        prop_launches, _, _ = _cli_run(
            torch, "proposal files", "test", DATASET_CFG, out["prop"],
            opts + ["TEST.PROPOSAL_FILES", f"[{prop_path}]"], b, want)
    n_valid_p = _check_dataset_dets("[dataset] proposal files", os.path.join(
        out["prop"], "detections.pkl"), ds, d)
    print(f"[dataset] TEST.PROPOSAL_FILES (GT boxes): {n_valid_p} valid "
          f"detections, model per batch ms median "
          f"{statistics.median(ins_p.batch_ms()):.2f}; launches "
          f"{prop_launches}", flush=True)

    # Multi-scale flip TTA + KPS_AUG: 480x640 frames route the three scales
    # (800, 600, 1000) to the three buckets.
    tta_data = os.path.join(DATASET_DIR, "tta")
    generate_synthetic_posetrack(os.path.join(tta_data, "synthetic"),
                                 num_videos=1, frames_per_video=3,
                                 image_hw=TTA_HW, seed=2, hard=True,
                                 json_name="val.json")
    tta_opts = TTA_OPTS + ["DATA.ROOT", tta_data,
                           "TEST.DATASETS", "[posetrack_synthetic_val]"]
    tcfg = load_cfg(os.path.join(REPO, TTA_CFG), opts=tta_opts)
    tds = get_dataset("posetrack_synthetic_val", tta_data)
    n_clips = len(tds.video_frames(tds.videos()[0]))          # T=1 windows
    scales = [tcfg.TEST.SCALE] + list(tcfg.TEST.BBOX_AUG_SCALES)
    # Phase 1: each scale pass lands in its own bucket, ceil(n / B) batches
    # of detect_tta each (two feature passes, K1 at the box and keypoint
    # stage of each); phase 2: ceil(n / B) batches of the merged clips, each
    # one feature pass pair and one keypoint K1 pair per scale.
    p1, p2 = len(scales) * -(-n_clips // b), -(-n_clips // b)
    want_tta = {"conv1": 2 * p1 + 2 * len(scales) * p2, "conv1_f32": 0,
                "roi_align": 4 * p1 + 2 * len(scales) * p2,
                "roi_align_backward": 0, "roi_align_backward_prep": 0}
    with _Instrumented(torch) as ins_t:
        tta_launches, tta_wall, tta_peak = _cli_run(
            torch, "multi-scale TTA", "test", TTA_CFG, out["tta"], tta_opts, b,
            want_tta)
    _check_dataset_dets("[dataset] multi-scale TTA", os.path.join(
        out["tta"], "detections.pkl"), tds, tcfg.TEST.DETECTIONS_PER_IM)
    calls = {k: len(ins_t.batch_ms(k)) for k in ("detect", "kps_aug heatmaps",
                                                 "kps_aug decode")}
    if calls != {"detect": p1, "kps_aug heatmaps": len(scales) * p2,
                 "kps_aug decode": p2}:
        raise RuntimeError(f"[dataset] multi-scale TTA: model calls {calls}")
    print(f"[dataset] multi-scale TTA + KPS_AUG ({TTA_CFG}, scales {scales}, "
          f"{n_clips} frames at {TTA_HW[0]}x{TTA_HW[1]}, B={b}): model calls "
          f"{calls}, detect "
          f"ms median {statistics.median(ins_t.batch_ms()):.2f}; CLI "
          f"{tta_wall:.2f} s; peak memory {tta_peak:.2f} GiB; launches "
          f"{tta_launches}", flush=True)
    print(f"[dataset] phase wall {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)
    return {k: launches[k] + stream_launches[k] + prop_launches[k]
            + tta_launches[k] for k in launches}


FINETUNE_DIR = os.path.join(DATASET_DIR, "finetune")
FINETUNE_2D_CFG = "configs/video/2d_R50_FPN_kps.yaml"
FINETUNE_PKL = os.path.join(DATASET_DIR, "r50_fpn_kps_2d.pkl")
PARITY_DIR = os.path.join(DATASET_DIR, "parity")
FINETUNE_STEPS, FINETUNE_RESUMED_STEPS, FINETUNE_PERIOD = 4, 2, 2
# The seeded 2D weights, imported, meet the hard set's GT with losses near
# 1.2e3; unclipped, even BASE_LR 1e-4 takes them to NaN by the fourth step
# (measured on the card). A global-norm clip of 10, as the synthetic
# configs train with, keeps every step finite; it also makes the frozen
# stages' gradients computed (the clip reads them), as JAX's clip does.
FINETUNE_CLIP = 10.0
LEARN_CFG = "configs/video/synthetic_smoke.yaml"
LEARN_STEPS = 150          # the synthetic end-to-end recipe (SKILL.md)
# The JAX package's CLI on the same recipe (150 steps, seed 3), run on a
# CPU, scores mAP 65.78, MOTA -32.60, box AP50 71.60, keypoint AP 57.98:
# at 150 steps the model is half-trained (1000 steps reach mAP 99.7), and
# MOTA still swings by tens of points between runs. The port is held to
# that reference with a margin of about 15 points on the three
# detection-quality metrics; an untrained model scores near 0 on them.
LEARN_FLOORS = {"mAP": 50.0, "box_AP50": 55.0, "keypoint_AP": 40.0}


class _StepTimer:
    """Wraps the port's `make_train_step` for the CLI runs inside the `with`
    block: every step's `state.step`, the host clock at its start and CUDA
    events around it (the CLI's loop runs unchanged: no added sync)."""

    def __init__(self, torch):
        self.torch = torch
        self.steps, self.starts, self.events, self.metrics = [], [], [], []

    def __enter__(self):
        from detectandtrack_tpu_torch.engine import train as ttrain
        self.mod, self.saved = ttrain, ttrain.make_train_step
        torch, inst = self.torch, self

        def make_train_step(model, cfg, mesh=None):
            fn = inst.saved(model, cfg, mesh)

            def step(state, batch, draws=None):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                inst.steps.append(state.step)
                inst.starts.append(time.perf_counter())
                start.record()
                out = fn(state, batch, draws)
                end.record()
                inst.events.append((start, end))
                inst.metrics.append(out[1])
                return out

            return step

        ttrain.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.saved

    def losses(self):
        """Every step's loss terms (read after the runs), with the steps
        whose terms are not all finite."""
        vals = [{k: float(v) for k, v in m.items()} for m in self.metrics]
        bad = [i for i, d in enumerate(vals)
               if not all(np.isfinite(v) for v in d.values())]
        return vals, bad

    def times_ms(self, first, last):
        """(host ms, CUDA-event ms) of steps first..last-1: the host clock
        from a step's start to the next one's, the events around it."""
        self.torch.cuda.synchronize()
        host = [1e3 * (self.starts[i + 1] - self.starts[i])
                for i in range(first, last)]
        dev = [s.elapsed_time(e) for s, e in self.events[first:last]]
        return host, dev


def _cli_counted(torch, argv, want=None, tag="[finetune]"):
    """One port CLI call on the card with the launch counters reset → (its
    return value, launches, wall s, peak GiB); with `want`, the counters
    must equal it."""
    from detectandtrack_tpu_torch.cli.launch import main as cli
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    out = cli(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    if want is not None and launches != want:
        raise RuntimeError(f"{tag} {argv[:2]}: launch counters {launches}, "
                           f"expected {want}")
    return out, launches, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


class _LogLines(list):
    """Collects the messages of the port's loggers inside a `with`."""

    def __enter__(self):
        import logging
        inst = self

        class Handler(logging.Handler):
            def emit(self, record):
                inst.append(record.getMessage())

        self.handler = Handler()
        self.logger = logging.getLogger("detectandtrack_tpu_torch")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def phase_finetune(torch, per_step):
    """The fine-tuning path through the port's CLI, bf16, in a fresh
    directory: a Detectron `.pkl` of the seeded 2D R-50 FPN model, imported
    into the main 3D config (`--mode import-weights`: every leaf mapped,
    the t=3 kernels mean-inflated, K2 with the inflated conv1 equal to K2
    with the 2D kernel on a time-constant clip's frames 1-6); `--mode
    train` from it on the [dataset] generator's 720x1280 hard set (B=1,
    BASE_LR 1e-4, CLIP_GRAD_NORM 10, 4 steps, a checkpoint every 2),
    resumed to 6 (exactly 2
    more steps), the final weights answering one `--mode test` batch; then
    the synthetic smoke config trained 150 steps through the CLI, tested
    and tracked, held to LEARN_FLOORS. Launch counters: steps
    x `per_step` (the [train] phase's; the clip adds no launch: conv1's
    gradient is the plain conv's), windows for the test runs → the
    launches summed over the phase."""
    import shutil

    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.data.posetrack import get_dataset
    from detectandtrack_tpu_torch.kernels.conv1 import conv1
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.tools import smoke_learn
    from detectandtrack_tpu_torch.utils import detectron_import as tdi
    from detectandtrack_tpu_torch.utils.checkpoint import _flatten
    from detectandtrack_tpu_torch.utils.env import card_line
    from detectandtrack_tpu_torch.utils.io import load_object
    from detectandtrack_tpu_torch.utils.params import (
        state_dict_to_jax_params)

    t_phase = time.perf_counter()
    card = card_line()
    shutil.rmtree(FINETUNE_DIR, ignore_errors=True)   # or AUTO_RESUME resumes
    data, run = (os.path.join(FINETUNE_DIR, d) for d in ("data", "run"))
    total: dict = {}

    # 1. The Detectron .pkl of the seeded 2D model.
    cfg2 = load_cfg(os.path.join(REPO, FINETUNE_2D_CFG))
    model2 = build_model(cfg2, device="cuda", seed=0)
    pkl = FINETUNE_PKL                  # kept for [surface-ops]
    os.makedirs(FINETUNE_DIR)
    tdi.save_detectron_pkl(pkl, model2, cfg2)
    flat2 = _flatten(state_dict_to_jax_params(model2.state_dict(), model2))
    k2d = model2.backbone.conv1.conv.weight.detach()
    del model2

    # 2. --mode import-weights into the main 3D config.
    reports = []
    real_import = tdi.import_detectron_weights

    def import_and_keep(*args, **kw):
        out = real_import(*args, **kw)
        reports.append(out[1])
        return out

    tdi.import_detectron_weights = import_and_keep
    try:
        imported, launches, wall_import, _ = _cli_counted(
            torch, ["--mode", "import-weights", "--cfg",
                    os.path.join(REPO, BOX_CFG), "--weights", pkl, "--out",
                    run])
    finally:
        tdi.import_detectron_weights = real_import
    report = reports[0]
    if report["missing"] or report["unused"] or not report["mapped"]:
        raise RuntimeError(f"[finetune] import: missing {report['missing']}, "
                           f"unused {report['unused']}")
    done = {m.split(" ")[0] for m in report["mapped"]} | {
        m.split(":")[0] for m in report["surgery"]}
    convs = [k[len("params/"):] for k in flat2
             if k.split("/")[1] in ("backbone", "fpn", "rpn_head")
             and k.endswith("kernel")]
    if not convs or any(k not in done for k in convs):
        raise RuntimeError("[finetune] import: backbone/FPN/RPN kernels not "
                           f"mapped: {[k for k in convs if k not in done]}")
    inflated = 0
    with np.load(imported) as npz:
        for key in npz.files:
            arr = npz[key]
            if arr.ndim == 5 and arr.shape[0] == 3 and key in flat2:
                want = np.repeat(flat2[key], 3, axis=0) / np.float32(3.0)
                if not np.array_equal(arr, want):
                    raise RuntimeError(f"[finetune] import: {key} is not the "
                                       "mean inflation of the 2D kernel")
                inflated += 1
        k3d = torch.from_numpy(npz["params/backbone/conv1/conv/kernel"])
    if inflated < 2 or tuple(k3d.shape) != (3, 7, 7, 3, 64):
        raise RuntimeError(f"[finetune] import: {inflated} t=3 kernels, "
                           f"conv1 {tuple(k3d.shape)}")
    h, w = load_cfg(os.path.join(REPO, BOX_CFG)).TEST.SHAPE_BUCKETS[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    frame = torch.randn((1, 1, h, w, 3), device="cuda", generator=gen)
    y3 = conv1(frame.expand(1, 8, h, w, 3).contiguous(), k3d.cuda(), 3,
               torch.bfloat16)
    y1 = conv1(frame, k2d, 1, torch.bfloat16)
    err, tol = _check("[finetune] K2 inflated conv1 on frames 1-6",
                      y3[:, 1:7], y1.expand(1, 6, *y1.shape[2:]),
                      torch.bfloat16, torch)
    print(f"[finetune] import-weights {FINETUNE_2D_CFG} .pkl -> {BOX_CFG}: "
          f"{len(report['mapped'])} mapped, {len(report['surgery'])} "
          f"surgeries, 0 missing, 0 unused, {inflated} t=3 kernels mean-"
          f"inflated; K2 with the inflated conv1 on a time-constant "
          f"8x{h}x{w} clip equals K2 with the 2D kernel on frames 1-6: "
          f"max_abs_err={err:.3g} (tol {tol:.3g}); CLI {wall_import:.1f} s",
          flush=True)
    del y3, y1, frame

    # 3. --mode train on the 720x1280 hard set, then resumed.
    _hard_set(data)
    opts = ["--cfg", os.path.join(REPO, BOX_CFG), "--out", run,
            "--weights", imported] + DATASET_OPTS + [
        "DATA.ROOT", data, "TRAIN.DATASETS", "[posetrack_synthetic_hard_val]",
        "TEST.DATASETS", "[posetrack_synthetic_hard_val]",
        "TRAIN.IMS_PER_BATCH", "1", "SOLVER.BASE_LR", str(TRAIN_SMOKE_LR),
        "SOLVER.CLIP_GRAD_NORM", str(FINETUNE_CLIP),
        "TRAIN.CHECKPOINT_PERIOD", str(FINETUNE_PERIOD)]
    n_all = FINETUNE_STEPS + FINETUNE_RESUMED_STEPS
    with _StepTimer(torch) as timer, _LogLines() as logs:
        _, launches, wall_train, peak = _cli_counted(
            torch, ["--mode", "train"] + opts + [
                "SOLVER.MAX_ITER", str(FINETUNE_STEPS)],
            {k: FINETUNE_STEPS * v for k, v in per_step.items()})
        _add(total, launches)
        host, dev = timer.times_ms(1, FINETUNE_STEPS - 1)
        _, launches, wall_resume, _ = _cli_counted(
            torch, ["--mode", "train"] + opts + ["SOLVER.MAX_ITER", str(n_all)],
            {k: FINETUNE_RESUMED_STEPS * v for k, v in per_step.items()})
        _add(total, launches)
    if timer.steps != list(range(n_all)) or not any(
            f"auto-resumed from step {FINETUNE_STEPS}" in m for m in logs):
        raise RuntimeError(f"[finetune] train: steps {timer.steps}, resume "
                           f"not logged: {logs}")
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    want_ckpts = [f"{s}.pt" for s in range(FINETUNE_PERIOD, n_all + 1,
                                           FINETUNE_PERIOD)]
    if ckpts != sorted(want_ckpts):
        raise RuntimeError(f"[finetune] train: checkpoints {ckpts}")
    with open(os.path.join(run, "training_stats.jsonl")) as f:
        stats = [json.loads(line) for line in f]
    bad = [k for st in stats for k, v in st.items()
           if k.startswith("loss_") and not np.isfinite(v)]
    losses, bad_steps = timer.losses()
    if not stats or bad or bad_steps:
        raise RuntimeError(f"[finetune] training stats {stats}; steps "
                           f"{bad_steps} with non-finite losses: {losses}")
    final = os.path.join(run, "model_final.npz")
    with np.load(final) as npz:
        bad = [k for k in npz.files if not np.isfinite(npz[k]).all()]
    if bad:
        raise RuntimeError(f"[finetune] model_final.npz: {len(bad)} arrays "
                           f"not finite, e.g. {bad[:5]}")
    host_ms, dev_ms = statistics.median(host), statistics.median(dev)
    print(f"[finetune] train {BOX_CFG} bf16 B=1 on {DATASET_HW[0]}x"
          f"{DATASET_HW[1]} frames (bucket {h}x{w}), BASE_LR "
          f"{TRAIN_SMOKE_LR}, CLIP_GRAD_NORM {FINETUNE_CLIP}: "
          f"{FINETUNE_STEPS} steps, checkpoints every "
          f"{FINETUNE_PERIOD}, resumed from step {FINETUNE_STEPS} for "
          f"{FINETUNE_RESUMED_STEPS} more (steps {timer.steps}, checkpoints "
          f"{ckpts}); steps 1-{FINETUNE_STEPS - 2}: host ms "
          f"{[round(v, 2) for v in host]} (median {host_ms:.2f}), CUDA-event "
          f"ms {[round(v, 2) for v in dev]} (median {dev_ms:.2f}), card busy "
          f"share {100 * dev_ms / host_ms:.1f}%; CLI {wall_train:.1f} s + "
          f"{wall_resume:.1f} s; peak memory {peak:.2f} GiB; loss_total "
          f"by step {[round(d['loss_total'], 3) for d in losses]} "
          f"({card})", flush=True)

    ds = get_dataset("posetrack_synthetic_hard_val", data)
    vid = ds.videos()[0]
    n_win = _windows(len(ds.video_frames(vid)), 8)
    if n_win > 2:
        raise RuntimeError(f"[finetune] test: {vid} has {n_win} windows")
    _, launches, _, _ = _cli_counted(
        torch, ["--mode", "test", "--batch-size", "2", "--video-range", "0:1",
                "--weights", final] + opts[:4] + opts[6:],
        {"conv1": 1, "conv1_f32": 0, "roi_align": 2, "roi_align_backward": 0,
         "roi_align_backward_prep": 0})
    _add(total, launches)
    dets = load_object(os.path.join(run, "detections.pkl"))
    frames = dets.get(vid, [])
    bad = sorted({k for fr in frames for k in ("boxes", "scores",
                                                "keypoints")
                  if not np.isfinite(fr[k]).all()})
    if list(dets) != [vid] or len(frames) != len(ds.video_frames(vid)) or bad:
        raise RuntimeError(f"[finetune] test of model_final.npz: videos "
                           f"{list(dets)} (want [{vid}]), {len(frames)} "
                           f"frames of {len(ds.video_frames(vid))}, not "
                           f"finite: {bad}")
    print(f"[finetune] model_final.npz answers one --mode test batch "
          f"({n_win} windows of {vid}): {len(frames)} frames, "
          f"{sum(int(fr['valid'].sum()) for fr in frames)} valid detections",
          flush=True)

    # 4. Learn: the synthetic smoke config, 150 steps, test, track.
    learn_dir = os.path.join(FINETUNE_DIR, "learn")
    lcfg = load_cfg(os.path.join(REPO, LEARN_CFG))
    lds_root = os.path.join(learn_dir, "data")
    with _StepTimer(torch) as ltimer:
        torch.cuda.synchronize()
        _reset_counters()
        got = smoke_learn.learn(learn_dir, LEARN_STEPS, lcfg.RNG_SEED, "cuda")
        torch.cuda.synchronize()
        launches = _read_counters()
        lhost, ldev = ltimer.times_ms(1, LEARN_STEPS - 1)
    lds = get_dataset(lcfg.TEST.DATASETS[0], lds_root)
    l_win = sum(_windows(len(lds.video_frames(v)), lcfg.VIDEO.NUM_FRAMES)
                for v in lds.videos())
    l_batch = -(-l_win // 2)
    heads = 2                                   # box and keypoint stages
    want = {"conv1": 0, "conv1_f32": LEARN_STEPS + l_batch,
            "roi_align": heads * (LEARN_STEPS + l_batch),
            "roi_align_backward": heads * LEARN_STEPS,
            "roi_align_backward_prep": heads * LEARN_STEPS}
    if launches != want:
        raise RuntimeError(f"[finetune] learn: launch counters {launches}, "
                           f"expected {want}")
    _add(total, launches)
    lh, ld = statistics.median(lhost), statistics.median(ldev)
    print(f"[finetune] learn (tools/smoke_learn.py): {LEARN_CFG} "
          f"({lcfg.MODEL.COMPUTE_DTYPE}, B={lcfg.TRAIN.IMS_PER_BATCH}, seed "
          f"{lcfg.RNG_SEED}) trained {LEARN_STEPS} steps through --mode train "
          f"in {got['train_s']:.1f} s (step host ms median {lh:.2f}, "
          f"CUDA-event ms median {ld:.2f}, ratio {100 * ld / lh:.1f}%), then "
          f"--mode test ({l_batch} batches) and --mode track: mAP "
          f"{got['mAP']:.2f}, MOTA {got['MOTA']:.2f}, box AP50 "
          f"{got['box_AP50']:.2f}, keypoint AP {got['keypoint_AP']:.2f} "
          f"(floors {LEARN_FLOORS}); launches {launches}", flush=True)
    low = {k: got[k] for k, floor in LEARN_FLOORS.items()
           if not got[k] >= floor}
    if low:
        raise RuntimeError(f"[finetune] learn: {low} below the floors "
                           f"{LEARN_FLOORS}")
    shutil.rmtree(FINETUNE_DIR, ignore_errors=True)
    print(f"[finetune] phase wall {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total} ({card})", flush=True)
    return total


MULTIGPU_DIR = os.path.join(DATASET_DIR, "multigpu")
MULTIGPU_TIMEOUT = 300      # s for each multi-rank launch, its ranks' start
MULTIGPU_STEPS = 2          # timed steps of (a), after 1 warm-up


def _torchrun(nproc, child_args, log, timeout=MULTIGPU_TIMEOUT):
    """`python -m torch.distributed.run --standalone --nproc-per-node
    nproc chip_smoke.py --child ...` in a session of its own, output in
    `log`; the whole session is killed at the timeout. Raises unless every
    rank exits 0 → wall s."""
    import signal
    import subprocess
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), os.path.join(REPO, "chip_smoke.py"),
           "--child"] + child_args
    # Every rank runs on this host: gloo and NCCL connect over loopback.
    env = dict({"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"},
               **os.environ, PYTHONPATH=REPO)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "DAT_DISTRIBUTED"):
        env.pop(var, None)
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise RuntimeError(f"[multigpu] {child_args[0]} ranks still "
                               f"running after {timeout} s (killed); {log}")
    if proc.returncode != 0:
        with open(log) as f:
            tail = f.read()[-6000:]
        raise RuntimeError(f"[multigpu] {child_args[0]}: a rank failed "
                           f"(torchrun exit {proc.returncode}):\n{tail}")
    return time.perf_counter() - t0


def _rank_results(out_dir, nproc):
    return [_json_load(os.path.join(out_dir, f"rank{r}.json"))
            for r in range(nproc)]


def _digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for key in sorted(params):
        h.update(params[key].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _child_train(torch, out_dir):
    """(a) on two ranks of one card (gloo): one f32 step of the golden model
    (its all-reduced gradients saved for the parent), then the main config
    at full width, 1 clip per rank: 1 warm-up and MULTIGPU_STEPS timed
    steps, the launch counters, the peak memory, the gloo all-reduce of
    one step's gradients timed alone, a digest of the parameters."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.parallel import mesh as pmesh

    pmesh.maybe_init_distributed("cuda")
    mesh = pmesh.make_mesh("cuda")
    res = {"rank": mesh.rank, "backend": mesh.backend}

    def setup(cfg, b, h, w, n_valid, seed):
        """Model, state and step of `cfg`, this rank's rows of a seeded
        global batch of `b` clips."""
        model = build_model(cfg, device="cuda", seed=0, train=True)
        state = pmesh.replicate(mesh, create_train_state(cfg, model))
        batch = _train_batch(torch, cfg, b, h, w, cfg.TRAIN.MAX_GT_PER_IM,
                             n_valid, seed)
        batch = pmesh.shard_batch(mesh, {k: v.cuda() for k, v in
                                         batch.items()})
        return state, make_train_step(model, cfg, mesh), batch

    cfg = load_cfg(opts=TRAIN_OPTS)
    state, step, batch = setup(cfg, 2, 64, 96, 3, 8)
    _reset_counters()
    state, _ = step(state, batch)
    res["golden_launches"] = _read_counters()
    torch.save({k: p.grad.cpu() for k, p in state.params.items()
                if p.grad is not None},
               os.path.join(out_dir, f"golden_grads{mesh.rank}.pt"))
    res["golden_digest"] = _digest(state.params)
    del state, step, batch
    torch.cuda.empty_cache()

    # The main config: TRAIN.IMS_PER_BATCH (1) clips per rank.
    cfg = load_cfg(os.path.join(REPO, BOX_CFG),
                   opts=["SOLVER.BASE_LR", TRAIN_SMOKE_LR])
    h, w = cfg.TEST.SHAPE_BUCKETS[0]
    state, step, batch = setup(cfg, cfg.TRAIN.IMS_PER_BATCH * mesh.size, h,
                               w, 5, 7)
    state, _ = step(state, batch)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    secs, losses = [], []
    for _ in range(MULTIGPU_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    res.update(launches=_read_counters(), step_s=secs, losses=losses,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               digest=_digest(state.params))
    grads = [p.grad for p in state.params.values() if p.grad is not None]
    res["allreduce_mb"] = sum(g.numel() * g.element_size()
                              for g in grads) / 2 ** 20
    res["allreduce_ms"] = []
    for _ in range(3):
        torch.cuda.synchronize()
        pmesh.barrier(mesh)
        t0 = time.perf_counter()
        pmesh.pmean(mesh, grads)
        torch.cuda.synchronize()
        res["allreduce_ms"].append(1e3 * (time.perf_counter() - t0))
    torch.distributed.destroy_process_group()
    return res


def _child_cli(torch, runs):
    """The port's CLI on this rank, once per argv list of `runs`, each with
    the launch counters reset before and read after, and its
    `run_inference` and `load_clip` host times. One run lets the CLI start
    and end its process group itself; several share one group, started
    here by the same `maybe_init_distributed`."""
    from detectandtrack_tpu_torch.cli.launch import main as cli
    from detectandtrack_tpu_torch.parallel import mesh as pmesh

    if len(runs) > 1:
        pmesh.maybe_init_distributed("cuda")
    res = {"rank": int(os.environ["RANK"]), "runs": []}
    with _LogLines() as lines, _Instrumented(torch) as ins:
        for argv in runs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            n_walls, n_loads = len(ins.walls), len(ins.loads)
            t0 = time.perf_counter()
            cli(argv)
            torch.cuda.synchronize()
            res["runs"].append({
                "launches": _read_counters(),
                "wall_s": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "run_inference_s": sum(ins.walls[n_walls:]),
                "load_clip_s": sum(ins.loads[n_loads:]),
                "clips_decoded": len(ins.loads) - n_loads})
    res["mesh_lines"] = [m for m in lines if "backend" in m]
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return res


def _child(argv) -> int:
    """A rank of a [multigpu] launch (torchrun's environment): `train
    OUT_DIR` runs `_child_train`, `cli OUT_DIR RUNS_JSON` `_child_cli`;
    the result goes to OUT_DIR/rank<r>.json."""
    import torch
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind, out_dir = argv[0], argv[1]
    res = (_child_train(torch, out_dir) if kind == "train"
           else _child_cli(torch, json.loads(argv[2])))
    with open(os.path.join(out_dir, f"rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _golden_mean_grads(torch):
    """The golden model's per-shard gradients on the card, each row with
    its rank's draws, and their mean: what (a)'s all-reduce must give."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        generator_draws,
                                                        train_forward)
    from detectandtrack_tpu_torch.models.detector import build_model

    cfg = load_cfg(opts=TRAIN_OPTS)
    batch = _train_batch(torch, cfg, 2, 64, 96, cfg.TRAIN.MAX_GT_PER_IM, 3,
                         8)
    model = build_model(cfg, device="cuda", seed=0, train=True)
    trained = {k: p for k, p in create_train_state(cfg, model).params.items()
               if p.requires_grad}
    per_shard = []
    for r in range(2):
        for p in trained.values():
            p.grad = None
        row = {k: v[r:r + 1].cuda() for k, v in batch.items()}
        total, _ = train_forward(
            model, row["clips"], row["gt_boxes"], row["gt_keypoints"],
            row["gt_valid"], generator_draws(cfg.RNG_SEED, 0, r))
        total.backward()
        per_shard.append({k: (p.grad if p.grad is not None
                              else torch.zeros_like(p)).cpu()
                          for k, p in trained.items()})
    return {k: (per_shard[0][k] + per_shard[1][k]) / 2 for k in trained}


def _scale(n, launches):
    return {k: n * v for k, v in launches.items()}


def phase_multigpu(torch, per_step):
    """Data parallelism (`parallel/mesh.py`), every multi-rank run a
    torchrun child with a timeout. The one card allows two ranks over gloo
    (NCCL refuses two ranks on one device) and NCCL at world size 1:
    (a) two ranks, gloo: one step of the golden f32 model, each rank's
    all-reduced gradient equal to the mean of the two rows' gradients
    computed here with the same per-rank draws (GRAD_REL_TOL of each
    gradient's max), parameters equal across the ranks bit for bit; then
    the main config at full width, bf16, one 8x800x1344 clip per rank,
    1 warm-up and 2 timed steps: losses finite, launches = steps x
    `per_step` on each rank, parameters equal across the ranks; step time,
    peak memory and the gloo all-reduce of one step's gradients printed;
    (b) `--mode train` of the main config under torchrun at world size 1
    (NCCL) for 2 steps on [dataset]'s 720x1280 set: reports nccl, and its
    final weights equal the same CLI run's without torchrun within the
    bf16 tolerance; (c) `--mode test` and `--mode stream` under torchrun,
    two ranks (gloo), 1 clip per rank, on [dataset]'s set and config:
    launches per rank from the windows and global batches, every frame
    once, detections equal the one-process `--batch-size 1` run's (the
    same per-clip shapes on the same card: valid counts per frame equal,
    boxes and scores within the bf16 tolerance), the stream's track ids
    equal test + track → the launches summed over every run."""
    import shutil

    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.data.posetrack import get_dataset
    from detectandtrack_tpu_torch.tracking.engine import (
        read_posetrack_results)
    from detectandtrack_tpu_torch.utils.checkpoint import load_weights_npz
    from detectandtrack_tpu_torch.utils.env import card_line
    from detectandtrack_tpu_torch.utils.io import load_object
    from detectandtrack_tpu_torch.models.detector import build_model

    t_phase = time.perf_counter()
    card = card_line()
    shutil.rmtree(MULTIGPU_DIR, ignore_errors=True)
    os.makedirs(MULTIGPU_DIR)
    torch.cuda.empty_cache()
    total: dict = {}

    # (a) Two ranks on the card over gloo.
    out_a = os.path.join(MULTIGPU_DIR, "a")
    os.makedirs(out_a)
    wall = _torchrun(2, ["train", out_a], os.path.join(out_a, "log.txt"))
    ranks = _rank_results(out_a, 2)
    want = _golden_mean_grads(torch)
    worst = (0.0, "")
    for r in range(2):
        got = torch.load(os.path.join(out_a, f"golden_grads{r}.pt"))
        if set(got) != set(want):
            raise RuntimeError(f"[multigpu] (a) rank {r}: gradients of "
                               f"{sorted(set(got) ^ set(want))[:4]}")
        for k, g in want.items():
            rel = ((got[k] - g).abs().max().item()
                   / max(g.abs().max().item(), GRAD_FLOOR / GRAD_REL_TOL))
            worst = max(worst, (rel, k))
    if not worst[0] <= GRAD_REL_TOL:
        raise RuntimeError(f"[multigpu] (a) golden: all-reduced gradient "
                           f"{worst[1]} differs from the mean of the rows' "
                           f"by {worst[0]:.3g} of its max")
    want_launches = _scale(MULTIGPU_STEPS, per_step)
    golden_want = {"conv1": 0, "conv1_f32": 1, "roi_align": 2,
                   "roi_align_backward": 2, "roi_align_backward_prep": 2}
    for res in ranks:
        if res["backend"] != "gloo":
            raise RuntimeError(f"[multigpu] (a) backend {res['backend']}")
        if res["golden_launches"] != golden_want:
            raise RuntimeError(f"[multigpu] (a) golden launches "
                               f"{res['golden_launches']}")
        if res["launches"] != want_launches:
            raise RuntimeError(f"[multigpu] (a) rank {res['rank']}: "
                               f"launches {res['launches']}, expected "
                               f"{want_launches}")
        bad = [k for d in res["losses"] for k, v in d.items()
               if not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"[multigpu] (a) losses {res['losses']}")
        _add(total, res["golden_launches"])
        _add(total, res["launches"])
    for key in ("golden_digest", "digest"):
        if ranks[0][key] != ranks[1][key]:
            raise RuntimeError(f"[multigpu] (a) parameters differ across "
                               f"the ranks after the steps ({key})")
    print(f"[multigpu] (a) 2 ranks on one card, gloo: golden R-18 T=2 f32 "
          f"step, all-reduced gradients vs the mean of the rows' on the "
          f"card: worst {worst[1]} at {worst[0]:.3g} of its max (tol "
          f"{GRAD_REL_TOL}); parameters equal across the ranks", flush=True)
    for res in ranks:
        print(f"[multigpu] (a) rank {res['rank']}: {BOX_CFG} bf16, 1 clip "
              f"8x800x1344 per rank (global batch 2), {MULTIGPU_STEPS} steps "
              f"after 1 warm-up, step s {[round(s, 4) for s in res['step_s']]}"
              f" (median {statistics.median(res['step_s']):.4f}); peak "
              f"memory {res['peak_gib']:.2f} GiB; gloo all-reduce of one "
              f"step's gradients ({res['allreduce_mb']:.1f} MiB, two ranks "
              f"on one card, through the host; not an NCCL figure) ms "
              f"{[round(x, 1) for x in res['allreduce_ms']]}; launches "
              f"{res['launches']}; losses of the last step "
              f"{ {k: round(v, 4) for k, v in res['losses'][-1].items()} } "
              f"({card})", flush=True)
    print(f"[multigpu] (a) parameters equal across the ranks after the "
          f"steps; torchrun wall {wall:.1f} s", flush=True)

    # (b) NCCL at world size 1: the CLI's train under torchrun, and alone.
    data = os.path.join(DATASET_DIR, "data")
    train_opts = ["SOLVER.BASE_LR", str(TRAIN_SMOKE_LR), "SOLVER.MAX_ITER",
                  "2", "TRAIN.CHECKPOINT_PERIOD", "2", "DATA.ROOT", data,
                  "TRAIN.DATASETS", "[posetrack_synthetic_hard_val]"]
    out_b = os.path.join(MULTIGPU_DIR, "b")
    os.makedirs(out_b)

    def train_argv(out):
        return ["--mode", "train", "--cfg", os.path.join(REPO, BOX_CFG),
                "--device", "cuda", "--out", out] + train_opts

    wall = _torchrun(1, ["cli", out_b, json.dumps(
        [train_argv(os.path.join(out_b, "torchrun"))])],
        os.path.join(out_b, "log.txt"))
    (res,) = _rank_results(out_b, 1)
    if not any("rank 0 of 1, backend nccl" in m for m in res["mesh_lines"]):
        raise RuntimeError(f"[multigpu] (b) not on nccl: "
                           f"{res['mesh_lines']}")
    want_launches = _scale(2, per_step)
    if res["runs"][0]["launches"] != want_launches:
        raise RuntimeError(f"[multigpu] (b) launches {res['runs']}")
    _add(total, res["runs"][0]["launches"])
    _, launches, alone_wall, _ = _cli_counted(
        torch, train_argv(os.path.join(out_b, "alone")), want_launches,
        "[multigpu] (b)")
    _add(total, launches)
    cfg = load_cfg(os.path.join(REPO, BOX_CFG))
    finals = []
    for run in ("torchrun", "alone"):
        model = build_model(cfg, device="meta")
        model = model.to_empty(device="cpu")
        load_weights_npz(os.path.join(out_b, run, "model_final.npz"), model)
        finals.append(dict(model.named_parameters()))
    start = build_model(cfg, device="cpu", seed=cfg.RNG_SEED)
    worst, moved = 0.0, 0
    for k, p in finals[1].items():
        tol = BF16_REL_TOL * max(1.0, p.abs().max().item())
        err = (finals[0][k] - p).abs().max().item()
        worst = max(worst, err / tol)
        moved += not torch.equal(p, dict(start.named_parameters())[k])
    if worst > 1.0 or moved < len(finals[1]) // 2:
        raise RuntimeError(f"[multigpu] (b) final weights: worst "
                           f"{worst:.3g} of the bf16 tolerance, {moved} "
                           "parameters moved")
    del finals, start, model
    print(f"[multigpu] (b) torchrun --nproc-per-node 1 --mode train, "
          f"{BOX_CFG} bf16, 2 steps on {DATASET_HW[0]}x{DATASET_HW[1]}: "
          f"{res['mesh_lines'][0]}; final weights equal the run without "
          f"torchrun (worst {worst:.3g} of the bf16 tolerance, {moved} "
          f"parameters moved); walls: torchrun {wall:.1f} s (CLI "
          f"{res['runs'][0]['wall_s']:.1f} s), alone {alone_wall:.1f} s; "
          f"launches {res['runs'][0]['launches']} ({card})", flush=True)
    shutil.rmtree(out_b, ignore_errors=True)

    # (c) Sharded test and stream, two ranks over gloo, 1 clip per rank.
    ds = get_dataset("posetrack_synthetic_hard_val", data)
    opts = DATASET_OPTS + ["DATA.ROOT", data,
                           "TEST.DATASETS", "[posetrack_synthetic_hard_val]"]
    dcfg = load_cfg(os.path.join(REPO, DATASET_CFG), opts=opts)
    t, d = dcfg.VIDEO.NUM_FRAMES, dcfg.TEST.DETECTIONS_PER_IM
    n_win = sum(_windows(len(ds.video_frames(v)), t) for v in ds.videos())
    out_c = os.path.join(MULTIGPU_DIR, "c")
    os.makedirs(out_c)

    def infer_argv(mode, out, batch):
        return ["--mode", mode, "--cfg", os.path.join(REPO, DATASET_CFG),
                "--device", "cuda", "--out", out, "--batch-size",
                str(batch)] + opts

    wall = _torchrun(2, ["cli", out_c, json.dumps([
        infer_argv("test", os.path.join(out_c, "test"), 2),
        infer_argv("stream", os.path.join(out_c, "stream"), 2)])],
        os.path.join(out_c, "log.txt"))
    ranks = _rank_results(out_c, 2)
    per_rank = -(-n_win // 2)           # global batches, one clip a rank
    want_launches = {"conv1": per_rank, "conv1_f32": 0,
                     "roi_align": 2 * per_rank, "roi_align_backward": 0,
                     "roi_align_backward_prep": 0}
    for res in ranks:
        if not any(f"rank {res['rank']} of 2, backend gloo" in m
                   for m in res["mesh_lines"]):
            raise RuntimeError(f"[multigpu] (c) {res['mesh_lines']}")
        for run in res["runs"]:
            if run["launches"] != want_launches:
                raise RuntimeError(f"[multigpu] (c) rank {res['rank']}: "
                                   f"launches {run['launches']}, expected "
                                   f"{want_launches} ({n_win} windows)")
            _add(total, run["launches"])
    one = os.path.join(out_c, "one")
    with _Instrumented(torch) as ins:
        launches, one_wall, _ = _cli_run(
            torch, "test B=1", "test", DATASET_CFG, one, opts, 1,
            {"conv1": n_win, "conv1_f32": 0, "roi_align": 2 * n_win,
             "roi_align_backward": 0, "roi_align_backward_prep": 0})
    _add(total, launches)
    got_path = os.path.join(out_c, "test", "detections.pkl")
    n_valid = _check_dataset_dets("[multigpu] (c) test", got_path, ds, d)
    got, want = load_object(got_path), load_object(os.path.join(
        one, "detections.pkl"))
    worst = 0.0
    for vid, frames in want.items():
        for g, w in zip(got[vid], frames):
            if int(g["valid"].sum()) != int(w["valid"].sum()):
                raise RuntimeError(f"[multigpu] (c) {vid}: valid counts "
                                   "differ from the one-process run's")
            for key in ("boxes", "scores"):
                tol = BF16_REL_TOL * max(1.0, float(np.abs(w[key]).max()))
                worst = max(worst, float(np.abs(g[key] - w[key]).max()) / tol)
    if worst > 1.0:
        raise RuntimeError(f"[multigpu] (c) detections differ from the "
                           f"one-process run's by {worst:.3g} of the bf16 "
                           "tolerance")
    _cli_run(torch, "track", "track", DATASET_CFG,
             os.path.join(out_c, "test"), opts, 1)
    two = read_posetrack_results(os.path.join(out_c, "test", "tracks"))
    streamed = read_posetrack_results(os.path.join(out_c, "stream",
                                                   "tracks"))
    if set(two) != set(streamed) or any(
            len(two[v]) != len(streamed[v]) or any(
                not np.array_equal(a["track_ids"], b["track_ids"])
                for a, b in zip(two[v], streamed[v])) for v in two):
        raise RuntimeError("[multigpu] (c) the sharded stream's track ids "
                           "differ from the sharded test + track")
    print(f"[multigpu] (c) torchrun --nproc-per-node 2 (gloo), "
          f"{DATASET_CFG} bf16, global batch 2 (1 clip per rank): test and "
          f"stream, {n_win} windows = {per_rank} batches per rank, launches "
          f"per rank and run {want_launches}; every frame once, {n_valid} "
          f"valid detections, equal to the one-process --batch-size 1 run "
          f"(worst {worst:.3g} of the bf16 tolerance); stream track ids "
          f"equal test + track; walls: torchrun {wall:.1f} s (rank 0: test "
          f"{ranks[0]['runs'][0]['wall_s']:.1f} s, stream "
          f"{ranks[0]['runs'][1]['wall_s']:.1f} s), one process "
          f"{one_wall:.1f} s ({card})", flush=True)
    for res in ranks:
        print(f"[multigpu] (c) rank {res['rank']}: run_inference s (test, "
              f"stream; the model's broadcast from rank 0 included) "
              f"{[round(r['run_inference_s'], 3) for r in res['runs']]}, "
              f"load_clip {[r['clips_decoded'] for r in res['runs']]} clips "
              f"in {[round(r['load_clip_s'], 3) for r in res['runs']]} s; "
              f"peak memory {[round(r['peak_gib'], 2) for r in res['runs']]}"
              f" GiB; one process, --batch-size 1: run_inference "
              f"{ins.walls[0]:.3f} s, load_clip {len(ins.loads)} clips in "
              f"{sum(ins.loads):.3f} s ({card})", flush=True)
    shutil.rmtree(MULTIGPU_DIR, ignore_errors=True)
    print(f"[multigpu] phase wall {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total} ({card})", flush=True)
    return total


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
    from detectandtrack_tpu_torch.utils.env import card_line

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    sources = ["conv1", "roi_align", "diag_roialign", "nms", "affine",
               "hungarian"]
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
    phase_nms(torch, results)
    phase_affine(torch, results)
    torch.cuda.empty_cache()
    diag = phase_diag(torch, results)
    phase_tools(torch)
    inference = phase_slice(torch)
    graphs = phase_graphs(torch)
    bench = phase_bench(torch)
    # With random weights (no pretrained backbone, identity frozen-BN
    # affines) the unclipped config's own BASE_LR 0.005 blows the losses up
    # within three steps; TRAIN_SMOKE_LR keeps every loss finite and
    # changes nothing else on the path.
    training = _train_steps(torch, "train", load_cfg(
        os.path.join(REPO, BOX_CFG), opts=["SOLVER.BASE_LR", TRAIN_SMOKE_LR]),
        3, seed=7)
    dataset = phase_dataset(torch)
    per_step = {k: v // 3 for k, v in training.items()}
    finetune = phase_finetune(torch, per_step)
    multigpu = phase_multigpu(torch, per_step)
    phase_surface_kernels(torch)
    surface = phase_surface(torch)
    surface_ops = phase_surface_ops(torch)
    # The f32 models of the parity phases run conv1's f32 kernel.
    _reset_counters()
    phase_parity(torch)
    phase_train_parity(torch)
    parity = _read_counters()
    if parity["conv1_f32"] == 0:
        raise RuntimeError(f"parity: launch counters {parity}: conv1's f32 "
                           "kernel never ran")
    launches = {k: inference[k] + training[k] + dataset[k] + surface[k]
                + finetune[k] + multigpu[k] + surface_ops[k] + bench[k]
                + graphs[k] for k in training}
    for name, n in NMS_LAUNCHES.items():
        if n == 0:
            raise RuntimeError(f"{name}: no launch on the paths that run it")
    if EPILOGUE_LAUNCHES[0] == 0:
        raise RuntimeError("affine_epilogue: no launch on the paths that run "
                           "it")
    print(f"[launches] inference slice {inference}; graphs {graphs}; "
          f"NMS kernels on the serving and training paths {NMS_LAUNCHES}; "
          f"conv epilogues there {EPILOGUE_LAUNCHES[0]}; "
          f"bench {bench}; "
          f"training slice "
          f"{training}; dataset paths {dataset}; fine-tuning path "
          f"{finetune}; data-parallel runs {multigpu}; surface paths "
          f"{surface}; parity tool {surface_ops}; "
          f"parity phases {parity}; "
          f"k3 path {results['roi_align_k3']['launches']}; diagnostic "
          f"tool {diag}; sum of the full-width paths {launches}", flush=True)

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
         "launches": parity["conv1_f32"] + launches["conv1_f32"],
         **results["conv1_f32"]},
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
        {"name": "nms_keep", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/nms.cu",
         "replaces": "detectandtrack_tpu/ops/nms.py:88",
         "launches": NMS_LAUNCHES["nms_keep"], **results["nms_keep"]},
        {"name": "soft_nms_confirm", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/nms.cu",
         "replaces": "detectandtrack_tpu/ops/nms.py:176",
         "launches": NMS_LAUNCHES["soft_nms_confirm"],
         **results["soft_nms_confirm"]},
        {"name": "affine_epilogue", "route": "cuda",
         "source": "detectandtrack_tpu_torch/csrc/affine.cu",
         "replaces": None, "launches": EPILOGUE_LAUNCHES[0],
         **results["affine_epilogue"]},
    ] + [{"name": f"diag_roialign_{variant}", "route": "cuda",
          "source": "detectandtrack_tpu_torch/csrc/diag_roialign.cu",
          "replaces": "tools/diag_roialign.py:140",
          "launches": diag[variant], **results[f"diag_{variant}"]}
         for variant in diag]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[2:]) if sys.argv[1:2] == ["--child"] else main())
