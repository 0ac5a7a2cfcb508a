"""Time the NMS loop kernels of two (or more) checkouts on one card.

    python3 -m detectandtrack_tpu_torch.tools.nms_ab TREE ...

Runs each checkout in its own process, in the order given (name a pair as
parent, change, change, parent to see the drift between runs), and prints
one JSON line per run. At `chip_smoke.py [nms]`'s shapes (`KEEP_SHAPES`,
random boxes and a suppression chain) it times greedy NMS from the
score-sorted boxes to the keep mask (`keep`): the tree's `nms_keep` where
it takes the sorted boxes, and where it takes the suppression matrix (the
entry before the fused kernels) the torch passes that build the matrix
plus that call; and the tree's `nms_keep` alone as it is called
(`kernel`: the same call, or the call on a matrix built beforehand). At
the soft-NMS config's B=2 lanes of N=300 it times `soft_nms_confirm`
(linear and gaussian, random and chain). Each time two ways: CUDA events
around 10 eager calls after 2 warm-ups (`*_ms`, host launch cost
included), and one call's device time inside a CUDA graph of 20 calls
(`*_graph_ms`, `graph_ms`). Each result is held to the tree's own plain
version bit for bit. The inputs come from this checkout's functions for
every tree (the IoU through the tree's own `bbox_overlaps`, unchanged
since the port began); each tree builds its own kernels. Needs a CUDA
card; the card's `nvidia-smi` name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, lanes, N, IoU threshold): the RPN's 5 levels x B=2 at
# PRE_NMS_TOP_N_TEST 1000, the final NMS's B=2 at 300, and the training
# step's 5 levels x B=1 at PRE_NMS_TOP_N_TRAIN 2000.
KEEP_SHAPES = (("RPN", 10, 1000, 0.7), ("final", 2, 300, 0.5),
               ("train", 5, 2000, 0.7))
SOFT_LANES, SOFT_N = 2, 300


def greedy_lanes(lanes, n, chain, seed, h=800, w=1344):
    """(boxes (lanes, n, 4), scores (lanes, n)) on the card: boxes spread
    over an h x w image with random sizes, or a long suppression chain
    (12 px boxes 3 px apart in score order: each suppresses only the
    next at IoU 0.5, N dependent decisions)."""
    rng = np.random.default_rng(seed)
    if chain:
        x1 = np.arange(n, dtype=np.float32) * 3.0
        one = np.stack([x1, np.zeros(n, np.float32), x1 + 11.0,
                        np.full(n, 11.0, np.float32)], 1)
        boxes = np.broadcast_to(one, (lanes, n, 4)).copy()
        scores = np.broadcast_to(np.linspace(1.0, 0.5, n, dtype=np.float32),
                                 (lanes, n)).copy()
    else:
        x1, y1 = rng.uniform(0, w - 64, (lanes, n)), rng.uniform(
            0, h - 64, (lanes, n))
        bw, bh = rng.uniform(16, 320, (lanes, n)), rng.uniform(
            16, 320, (lanes, n))
        boxes = np.stack([x1, y1, np.minimum(x1 + bw, w - 1),
                          np.minimum(y1 + bh, h - 1)], -1).astype(np.float32)
        scores = rng.uniform(0, 1, (lanes, n)).astype(np.float32)
    return (torch.as_tensor(boxes).cuda(), torch.as_tensor(scores).cuda())


def keep_inputs(boxes, scores):
    """`ops/nms.py::nms_fixed`'s sort → (sorted boxes, valid_sorted), with
    every 7th row invalid."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    valid = torch.ones_like(scores, dtype=torch.bool)
    valid[..., ::7] = False            # some invalid rows
    return b.contiguous(), valid


def soft_inputs(boxes, scores, method, sigma=0.5, thresh=0.3):
    """`ops/nms.py::soft_nms_fixed`'s inputs to the confirmation loop →
    (scores, dmat, overlaps, alive), every 9th box dead."""
    from detectandtrack_tpu_torch.ops.boxes import bbox_overlaps
    n = boxes.shape[-2]
    iou = bbox_overlaps(boxes, boxes)
    if method == "linear":
        dmat = torch.where(iou > thresh, 1.0 - iou, torch.ones_like(iou))
    else:
        dmat = torch.exp(-(iou * iou) / sigma)
    overlaps = (dmat < 1.0) & ~torch.eye(n, dtype=torch.bool,
                                         device=boxes.device)
    alive = torch.ones_like(scores, dtype=torch.bool)
    alive[..., ::9] = False
    return scores, dmat, overlaps, alive


def eager_ms(fn, iters=10, warmup=2) -> float:
    """Mean time of one eager call of `fn`: CUDA events around `iters`
    calls after `warmup` calls (the host's launch cost included)."""
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


def graph_ms(fn, iters=20, reps=5) -> float:
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph (after two eager warm-ups on a side stream), replayed `reps`
    times between CUDA events, so no host time sits between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def run_tree(tree: str) -> dict:
    """One checkout's NMS kernels at the [nms] shapes → times."""
    sys.path.insert(0, os.path.abspath(tree))
    from detectandtrack_tpu_torch.kernels import nms as kn
    from detectandtrack_tpu_torch.ops.boxes import bbox_overlaps
    fused = "sorted_boxes" in inspect.signature(kn.nms_keep).parameters
    out = {"tree": tree, "fused": fused, "nms_keep": [],
           "soft_nms_confirm": []}
    for label, lanes, n, thresh in KEEP_SHAPES:
        for chain in (False, True):
            b, valid = keep_inputs(*greedy_lanes(lanes, n, chain, seed=n))
            rank = torch.arange(n, device=b.device)
            tri = rank[:, None] < rank[None, :]

            def supp(b=b, thresh=thresh, tri=tri):
                return (bbox_overlaps(b, b) > thresh) & tri

            if fused:
                def keep(b=b, valid=valid, thresh=thresh):
                    return kn.nms_keep(b, valid, thresh)
                kernel = keep
                ref = kn.nms_keep_reference(b, valid, thresh)
            else:
                s = supp()

                def keep(valid=valid, supp=supp):
                    return kn.nms_keep(supp(), valid)

                def kernel(valid=valid, s=s):
                    return kn.nms_keep(s, valid)
                ref = kn.nms_keep_reference(s, valid)
            if not torch.equal(keep(), ref):
                raise RuntimeError(f"{tree}: nms_keep {label} differs from "
                                   "its plain version")
            out["nms_keep"].append({
                "shape": f"{label} {lanes}x{n} "
                         f"{'chain' if chain else 'random'}",
                "kept": int(ref.sum()),
                "keep_ms": eager_ms(keep), "keep_graph_ms": graph_ms(keep),
                "kernel_ms": eager_ms(kernel),
                "kernel_graph_ms": graph_ms(kernel)})
            del ref
    for method in ("linear", "gaussian"):
        for chain in (False, True):
            args = soft_inputs(*greedy_lanes(SOFT_LANES, SOFT_N, chain,
                                             seed=31), method)

            def soft(args=args):
                return kn.soft_nms_confirm(*args, -1e10)

            if not torch.equal(soft(), kn.soft_nms_confirm_reference(
                    *args, -1e10)):
                raise RuntimeError(f"{tree}: soft_nms_confirm {method} "
                                   "differs from its plain version")
            out["soft_nms_confirm"].append({
                "shape": f"{method} {SOFT_LANES}x{SOFT_N} "
                         f"{'chain' if chain else 'random'}",
                "ms": eager_ms(soft), "graph_ms": graph_ms(soft)})
    return out


def _by_path(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(_PKG, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(run_tree(args.trees[0])), flush=True)
        return 0
    print(_by_path("dat_env", "utils/env.py").card_line(), flush=True)
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), os.path.abspath(tree),
             "--child"], cwd=os.path.abspath(tree), capture_output=True,
            text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
