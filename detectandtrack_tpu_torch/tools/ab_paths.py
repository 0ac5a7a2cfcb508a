"""Time the port's main paths of two (or more) checkouts on one card.

    python3 -m detectandtrack_tpu_torch.tools.ab_paths [--cfg CFG] TREE ...

Runs each checkout in its own process, in the order given (name a pair as
parent, change, change, parent to see the drift between runs), and prints
one JSON line per run: the median request time of the config's inference
path (`--cfg`, default the main config configs/video/3d_R50_T8_tubes_kps.yaml;
bf16, seeded random weights, B=2 clips of T frames at the config's first
shape bucket through the model's own RPN, its graphed `make_detect_fn`;
1 warm-up, then `--requests`), the median step time of its training path
(B=1, BASE_LR 1e-4; 1 warm-up, then `--steps`), each as host time ending
in `torch.cuda.synchronize()`, peak memory and the kernel launch counters
(the NMS kernels' where the tree has them).
The config and the synthetic inputs come from this checkout's own
`core/config.py` and `utils/synthetic.py` for every tree, so all trees run
the same model on the same inputs; each tree builds its own kernels. Needs
a CUDA card; the card's `nvidia-smi` name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_CFG = "configs/video/3d_R50_T8_tubes_kps.yaml"


def _by_path(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(_PKG, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_NMS = ("nms_keep", "soft_nms_confirm")


def _counters(tree_pkg) -> dict:
    conv1 = tree_pkg["conv1"].conv1
    ra = tree_pkg["roi_align"]
    out = {"conv1": conv1.launches,
           "conv1_tc": getattr(conv1, "launches_tc", None),
           "roi_align": ra.roi_align_multilevel.launches,
           "roi_align_backward": ra.roi_align_backward.launches}
    if tree_pkg["nms"] is not None:
        out.update({k: getattr(tree_pkg["nms"], k).launches for k in _NMS})
    return out


def _reset(tree_pkg) -> None:
    conv1 = tree_pkg["conv1"].conv1
    for name in ("launches", "launches_tc", "launches_cc", "launches_f32"):
        if hasattr(conv1, name):
            setattr(conv1, name, 0)
    tree_pkg["roi_align"].roi_align_multilevel.launches = 0
    tree_pkg["roi_align"].roi_align_backward.launches = 0
    if tree_pkg["nms"] is not None:
        for k in _NMS:
            getattr(tree_pkg["nms"], k).launches = 0


def run_tree(tree: str, n_requests: int, n_steps: int,
             cfg_file: str = MAIN_CFG) -> dict:
    """One checkout's main inference and training paths → timings."""
    import numpy as np
    import torch
    config = _by_path("ab_config", "core/config.py")
    synthetic = _by_path("ab_synthetic", "utils/synthetic.py")
    sys.path.insert(0, os.path.abspath(tree))
    from detectandtrack_tpu_torch.engine.inference import make_detect_fn
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.kernels import conv1, roi_align
    from detectandtrack_tpu_torch.models.detector import build_model
    try:
        from detectandtrack_tpu_torch.kernels import nms
    except ImportError:                  # a tree from before the NMS kernels
        nms = None
    pkg = {"conv1": conv1, "roi_align": roi_align, "nms": nms}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = config.load_cfg(os.path.join(_PKG, "..", cfg_file))
    b, t, (h, w) = 2, cfg.VIDEO.NUM_FRAMES, cfg.TEST.SHAPE_BUCKETS[0]
    model = build_model(cfg, device="cuda", seed=0)
    detect = make_detect_fn(model)
    gen = torch.Generator(device="cuda").manual_seed(3)
    clips = [torch.randn((b, t, h, w, 3), device="cuda", generator=gen)
             for _ in range(n_requests + 1)]
    detect(clips[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(pkg)
    req = []
    for clip in clips[1:]:
        t0 = time.perf_counter()
        detect(clip)
        torch.cuda.synchronize()
        req.append(time.perf_counter() - t0)
    inf_launches = _counters(pkg)
    inf_peak = torch.cuda.max_memory_allocated()
    del model, detect, clips
    torch.cuda.empty_cache()

    tcfg = config.load_cfg(os.path.join(_PKG, "..", cfg_file),
                           opts=["SOLVER.BASE_LR", 1e-4])
    tb = tcfg.TRAIN.IMS_PER_BATCH
    tubes = synthetic.make_realistic_tubes(tb, tcfg.TRAIN.MAX_GT_PER_IM, t,
                                           h, w, seed=7)
    batch = synthetic.train_batch(np.random.default_rng(7), tubes, [5] * tb,
                                  (h, w))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = build_model(tcfg, device="cuda", seed=0, train=True)
    state = create_train_state(tcfg, model)
    step = make_train_step(model, tcfg)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(pkg)
    steps = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
        raise RuntimeError(f"{tree}: non-finite loss {metrics}")
    return {"tree": tree, "cfg": cfg_file, "request_s": req,
            "request_median_s": statistics.median(req),
            "inference_launches": inf_launches,
            "inference_peak_gib": inf_peak / 2 ** 30,
            "step_s": steps, "step_median_s": statistics.median(steps),
            "train_launches": _counters(pkg),
            "train_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--cfg", default=MAIN_CFG,
                    help="config file, relative to the repository root")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(run_tree(args.trees[0], args.requests, args.steps,
                                  args.cfg)), flush=True)
        return 0
    print(_by_path("dat_env", "utils/env.py").card_line(), flush=True)
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), os.path.abspath(tree),
             "--child", "--cfg", args.cfg,
             "--requests", str(args.requests), "--steps", str(args.steps)],
            cwd=os.path.abspath(tree), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
