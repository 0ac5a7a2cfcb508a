"""Attribute a RoIAlign-shaped kernel's per-pair cost: gather, level
select, contractions.

    python3 -m detectandtrack_tpu_torch.tools.diag_roialign [n_pairs] [p]
        [--device cuda|cpu] [--iters 20] [--warmup 3] [--hw 256x320]

Port of tools/diag_roialign.py. It times the diagnostic kernel
(`kernels/diag_roialign.py`, `csrc/diag_roialign.cu`) in its four variants
on the same inputs as the JAX tool, made from `np.random.default_rng(0)`:
4 level maps of (1, 256, 320, 256) bf16, n pairs with x1 uniform in
[0, 64) and levels uniform in [0, 4):

  full      per-pair patch gather from the pair's level + both contractions
  noswitch  the same, every pair from level 0
  nodma     the contractions on a zero resident patch (no gather)
  nodot     the gather + a trivial add (no contractions)

Each variant prints its milliseconds per call (`utils/profiling`: CUDA
events on the card), microseconds per pair and, on the card, the share of
its bound (`utils/roofline.diag_work`) beside the card's `nvidia-smi` name
and power limit. `--device cpu` runs the plain version (use a small `--hw`
and n there); its times are the host's and no share is printed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernels.diag_roialign import VARIANTS, diag_pool, patch_cells
from ..utils import roofline
from ..utils.env import card_line
from ..utils.profiling import time_call

N_LEVELS = 4
C = 256


def make_inputs(n: int, hw=(256, 320), device="cuda"):
    """The JAX tool's inputs: maps (1, H, W, 256) bf16 per level, rois
    (4n,) f32 uniform in [0, 64), levels (n,) int32 in [0, 4)."""
    rng = np.random.default_rng(0)
    feats = [torch.from_numpy(rng.normal(size=(1,) + tuple(hw) + (C,)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
        for _ in range(N_LEVELS)]
    rois = torch.from_numpy(rng.uniform(0, 64, size=(n * 4,)).astype(
        np.float32)).to(device)
    levels = torch.from_numpy(rng.integers(0, N_LEVELS, size=(n,)).astype(
        np.int32)).to(device)
    return feats, rois, levels


def run_variant(variant, feats, rois, levels, p, iters, warmup):
    """Time one variant → dict(variant, ms, host_ms, us_per_pair, bound_ms,
    bound_by); the bound is the card's, so None off the card."""
    n = levels.shape[0]
    t = time_call(diag_pool, feats, rois, levels, p, variant, iters=iters,
                  warmup=warmup)
    row = {"variant": variant, "p": p, "n": n, "ms": t.seconds * 1e3,
           "host_ms": t.host_seconds * 1e3,
           "us_per_pair": t.seconds / n * 1e6, "bound_ms": None,
           "bound_by": None}
    if rois.is_cuda:
        work = roofline.diag_work(
            patch_cells(rois, levels, len(feats), variant), n, p,
            feats[0].shape[3], variant)
        row["bound_ms"], row["bound_by"] = roofline.bound(work)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_pairs", nargs="?", type=int, default=4800)
    ap.add_argument("p", nargs="?", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--hw", default="256x320",
                    help="level map height x width (default the JAX tool's)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("diag_roialign: no CUDA device (--device cpu runs "
                         "the plain version)")
    hw = tuple(int(v) for v in args.hw.split("x"))
    where = card_line() if args.device == "cuda" else "cpu, plain version"
    print(f"diag_roialign: n={args.n_pairs} p={args.p}, maps 4x(1, {hw[0]}, "
          f"{hw[1]}, {C}) bf16 ({where})", flush=True)
    feats, rois, levels = make_inputs(args.n_pairs, hw, args.device)
    rows = []
    for variant in VARIANTS:
        row = run_variant(variant, feats, rois, levels, args.p, args.iters,
                          args.warmup)
        line = (f"{variant:9s}: {row['ms']:8.3f} ms  "
                f"({row['us_per_pair']:6.2f} us/pair), host "
                f"{row['host_ms']:.3f} ms")
        if row["bound_ms"] is not None:
            line += (f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}),"
                     f" {100 * row['bound_ms'] / row['ms']:.1f}% of it")
        print(line, flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
