"""Split the RoIAlign backward's time on one card into its stages.

    python3 -m detectandtrack_tpu_torch.tools.roi_align_bwd_stages

On the inputs `chip_smoke.py` gives the backward (box stage S=8 K=512
P=7 and keypoint stage K=64 P=14 over the four FPN levels of an 800x1344
clip, K3's layout on the 8x200x336x256 P2 stack, C4's training box stage
S=2 on 50x84x1024 at P=14), bf16, it prints one JSON line per case: the
whole `roi_align_backward` call, its three stages alone (the prep kernel,
the sort and segment offsets, the gather kernel), each as CUDA-event
milliseconds over 20 launches after 3 warm-ups, the host time per call
(no synchronisation inside the loop), the bound `chip_smoke.py` states,
and the tile visits the gather makes (the (tile, pair) pairs whose
footprint meets, summed over the tiles of one channel slice). Needs a
CUDA card; the card's `nvidia-smi` name and power limit are printed
first.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events_ms(torch, fn, iters=20, warmup=3) -> float:
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


def _host_ms(torch, fn, iters=20) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def _visits(torch, shapes, footprints, keys, tile=8):
    """(tile, pair) pairs whose footprint meets the tile, over every tile
    of every (slab, level), one channel slice."""
    n_lvl = len(shapes)
    total = 0
    for lvl, (s_dim, h, w, _) in enumerate(shapes):
        ty = torch.arange(0, h, tile, device=footprints.device)
        tx = torch.arange(0, w, tile, device=footprints.device)
        on = (keys % n_lvl) == lvl
        f = footprints[on].long()
        rows = ((f[:, 0:1] < ty + tile) & (f[:, 1:2] > ty)).sum(1)
        cols = ((f[:, 2:3] < tx + tile) & (f[:, 3:4] > tx)).sum(1)
        total += int((rows * cols).sum())
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("roi_align_bwd_stages: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, _REPO)
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
    smoke = _smoke()
    print(smoke._card_line(), flush=True)
    ra._lib()
    gen = torch.Generator(device="cuda").manual_seed(5)
    strides = [4, 8, 16, 32]
    fpn = [(8, 800 // s, 1344 // s, 256) for s in strides]
    cases = []
    for stage, k, p in (("box", 512, 7), ("keypoint", 64, 14)):
        rois, levels = smoke._roi_cases(torch, k, b=1)
        cases.append((f"{stage} S=8 K={k} P={p}", fpn, strides,
                      rois.reshape(-1, 4), ra.slab_of_rows(8, k, "cuda"),
                      levels.reshape(-1), p))
    tubes = torch.as_tensor(make_realistic_tubes(1, 300, 8, 800, 1344,
                                                 seed=6)[0]).cuda()
    cases.append(("k3 layout P2 8x200x336x256 R=300 P=7", fpn[:1], [1],
                  (tubes.reshape(-1, 4) * 0.25).contiguous(),
                  torch.arange(8, dtype=torch.int32, device="cuda").repeat(
                      300), None, 7))
    c4 = torch.as_tensor(make_realistic_tubes(2, 512, 1, 800, 1344,
                                              seed=11)).clone()
    c4[:, :len(smoke.SPECIAL_ROIS)] = torch.tensor(smoke.SPECIAL_ROIS)
    cases.append(("C4 training box stage S=2 50x84x1024 K=512 P=14",
                  [(2, 50, 84, 1024)], [16], c4.reshape(-1, 4).cuda(),
                  ra.slab_of_rows(2, 512, "cuda"),
                  torch.zeros(1024, dtype=torch.int32, device="cuda"), 14))
    dtype = torch.bfloat16
    for label, shapes, st, rois, slabs, levels, p in cases:
        c = shapes[0][3]
        grad = torch.randn((rois.shape[0], p, p, c), device="cuda",
                           generator=gen).to(dtype)
        sizes = [a * b * c_ * d for a, b, c_, d in shapes]
        out = torch.empty((sum(sizes),), dtype=dtype, device="cuda")
        tables = ra._level_table(
            [m.data_ptr() for m in out.split(sizes)], shapes, st)
        keys, fp, smp = ra._launch_prep(ra._lib(), tables[1:], shapes, rois,
                                        slabs, levels, p, 2)
        order, seg = ra.backward_segments(keys, shapes[0][0] * len(shapes))
        fp_sorted = fp.index_select(0, order)
        stages = {
            "whole": lambda: ra.roi_align_backward(shapes, dtype, st, rois,
                                                   slabs, levels, grad, p, 2),
            "prep": lambda: ra.backward_prep(shapes, st, rois, slabs, levels,
                                             p, 2),
            "segments": lambda: ra.backward_segments(
                keys, shapes[0][0] * len(shapes)),
            "gather": lambda: ra._launch_gather(ra._lib(), tables, shapes,
                                                dtype, order, seg, fp_sorted,
                                                smp, grad, 2),
        }
        row = {"case": label, "dtype": "bfloat16"}
        for name, fn in stages.items():
            row[f"{name}_ms"] = _events_ms(torch, fn)
        row["host_ms_per_call"] = _host_ms(torch, stages["whole"])
        row["bound_ms"], row["bound_by"] = smoke._backward_bound(grad, shapes,
                                                                 dtype)
        row["visits"] = _visits(torch, shapes, fp, keys)
        row["pairs"] = rois.shape[0]
        row["blocks"] = sum(s * -(-h // 8) * -(-w // 8)
                            for s, h, w, _ in shapes) * -(-c // 128)
        print(json.dumps(row), flush=True)
        del grad
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
