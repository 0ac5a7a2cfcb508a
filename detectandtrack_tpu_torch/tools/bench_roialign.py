"""Time the multilevel RoIAlign kernel (K1) alone at a realistic roi mix.

    python3 -m detectandtrack_tpu_torch.tools.bench_roialign [iters]
        [--plain] [--device cuda|cpu] [--size 800x1344] [--slabs 16]
        [--channels 256] [--box-k 300] [--kps-k 100]

Port of tools/bench_roialign.py for the port's one RoIAlign forward
(`kernels/roi_align.py::roi_align_multilevel`, `csrc/roi_align.cu`). A
full-model run with random weights gives proposals that collapse onto few
FPN levels; this tool instead feeds the kernel person-shaped boxes of mixed
scales over the whole 800x1344 image, each on the FPN level its size
assigns, at the box stage (K=300 per slab, P=7) and the keypoint stage
(K=100, P=14) of S=16 slabs (B=2 clips of T=8), C=256, sampling ratio 2, in
bf16 on the FPN pyramid P2-P5 (strides 4-32). Each stage prints the
kernel's milliseconds per call (CUDA events), microseconds per pair, and
its bound (`utils/roofline.roi_align_work`, from the distinct map cells
these rois touch); `--plain` also times the plain PyTorch version. The
JAX tool's dense, hybrid and gather forms and its DAT_ROI_GANG /
DAT_ROI_SLOTS knobs were TPU-only variants and have no counterpart.
`--device cpu` runs the plain version at a small size (host times, no
bound).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernels.roi_align import (roi_align_multilevel,
                                 roi_align_multilevel_reference, slab_of_rows)
from ..utils import roofline
from ..utils.env import card_line
from ..utils.profiling import time_call

STRIDES = [4, 8, 16, 32]


def make_rois(rng, s_dim: int, k: int, h: int, w: int):
    """Person-shaped boxes of mixed scales over an h x w image and their
    FPN levels (0..3 for P2..P5) → (rois (S, K, 4) f32, levels (S, K)
    int32)."""
    scale = min(h / 800.0, w / 1344.0)
    areas = (rng.uniform(32, 448, size=(s_dim, k)) * scale) ** 2
    aspect = rng.uniform(0.33, 1.2, size=(s_dim, k))      # mostly tall
    bw = np.sqrt(areas * aspect)
    bh = np.sqrt(areas / aspect)
    cx = rng.uniform(0, w, size=(s_dim, k))
    cy = rng.uniform(0, h, size=(s_dim, k))
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    lvl = np.clip(np.floor(2 + np.log2(np.sqrt(areas) / (224.0 * scale))),
                  0, 3).astype(np.int32)
    return (torch.from_numpy(rois.astype(np.float32)),
            torch.from_numpy(lvl))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain PyTorch version")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", default="800x1344")
    ap.add_argument("--slabs", type=int, default=16)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--box-k", type=int, default=300)
    ap.add_argument("--kps-k", type=int, default=100)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_roialign: no CUDA device (--device cpu runs "
                         "the plain version)")
    dev = args.device
    h, w = (int(v) for v in args.size.split("x"))
    s_dim, c = args.slabs, args.channels
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = [torch.randn((s_dim, h // st, w // st, c), generator=gen,
                         device=dev).to(torch.bfloat16) for st in STRIDES]
    shapes = [tuple(f.shape) for f in feats]
    where = card_line() if dev == "cuda" else "cpu, plain version"
    print(f"bench_roialign: S={s_dim} {h}x{w} FPN P2-P5 C={c} bf16, "
          f"sampling 2 ({where})", flush=True)
    rows = []
    for name, k, p in (("box", args.box_k, 7), ("kps", args.kps_k, 14)):
        rois, levels = make_rois(rng, s_dim, k, h, w)
        rois, levels = rois.to(dev), levels.to(dev)
        n = s_dim * k
        fns = [("kernel" if dev == "cuda" else "plain", roi_align_multilevel)]
        if args.plain and dev == "cuda":
            fns.append(("plain", roi_align_multilevel_reference))
        for label, fn in fns:
            t = time_call(fn, feats, STRIDES, rois, levels, p, 2,
                          iters=args.iters, warmup=3)
            row = {"stage": name, "impl": label, "k": k, "p": p,
                   "ms": t.seconds * 1e3, "us_per_pair": t.seconds / n * 1e6}
            line = (f"{name} {p}x{p} K={k} [{label:6s}]: {row['ms']:8.3f} ms "
                    f" ({row['us_per_pair']:6.3f} us/pair)")
            if dev == "cuda":
                work = roofline.roi_align_work(
                    shapes, STRIDES, rois.reshape(-1, 4),
                    slab_of_rows(s_dim, k, "cpu"), levels.reshape(-1), p,
                    torch.bfloat16)
                row["bound_ms"], row["bound_by"] = roofline.bound(work)
                line += (f"; bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']}), "
                         f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
            print(line, flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
