"""Time the RoIAlign backward of checkouts on a real training step's inputs.

    python3 -m detectandtrack_tpu_torch.tools.roi_align_bwd_train [TREE ...]

Runs two full-width training steps of the main config
(configs/video/3d_R50_T8_tubes_kps.yaml, bf16, seeded random weights,
BASE_LR 1e-4, the seeded batch `chip_smoke.py` trains on) with this
checkout, records the inputs of the second step's `roi_align_backward`
calls (the box stage, P=7, and the keypoint stage, P=14) into
`out_bwd_train/` of this checkout, and prints what they hold (pairs,
levels, the rois' median width and height). Then each TREE (default: this
checkout), in its own process and in the order given (name a pair as
parent, change, change, parent), times its own `roi_align_backward` on
those inputs: CUDA events over 20 calls after 3 warm-ups, one JSON line
per stage. Needs a CUDA card; the card's `nvidia-smi` name and power limit
are printed first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_INPUTS = os.path.join(_REPO, "out_bwd_train", "inputs.pt")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(torch) -> None:
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                        make_train_step)
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.utils.env import card_line
    smoke = _smoke()
    print(card_line(), flush=True)
    cfg = load_cfg(os.path.join(_REPO, smoke.BOX_CFG),
                   opts=["SOLVER.BASE_LR", smoke.TRAIN_SMOKE_LR])
    calls = []
    kernel = ra.roi_align_backward

    def record(shapes, dtype, strides, rois, slabs, levels, grad, p=7, s=2):
        calls.append(dict(
            shapes=[tuple(sh) for sh in shapes], dtype=str(dtype)[6:],
            strides=list(strides), rois=rois.clone(), slabs=slabs.clone(),
            levels=None if levels is None else levels.clone(),
            grad=grad.clone(), p=p, s=s))
        return kernel(shapes, dtype, strides, rois, slabs, levels, grad, p, s)

    record.launches = 0
    ra.roi_align_backward = record
    model = build_model(cfg, device="cuda", seed=0, train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    b, (h, w) = cfg.TRAIN.IMS_PER_BATCH, cfg.TEST.SHAPE_BUCKETS[0]
    batch = {k: v.cuda() for k, v in smoke._train_batch(
        torch, cfg, b, h, w, cfg.TRAIN.MAX_GT_PER_IM, 5, 7).items()}
    for _ in range(2):
        calls.clear()
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    ra.roi_align_backward = kernel
    os.makedirs(os.path.dirname(_INPUTS), exist_ok=True)
    torch.save(calls, _INPUTS)
    for c in calls:
        r = c["rois"]
        lv = c["levels"]
        print(json.dumps({
            "stage": f"P={c['p']}", "pairs": r.shape[0],
            "maps": c["shapes"], "dtype": c["dtype"],
            "pairs_per_level": None if lv is None else torch.bincount(
                lv.long(), minlength=len(c["shapes"])).tolist(),
            "roi_median_w": (r[:, 2] - r[:, 0]).median().item(),
            "roi_median_h": (r[:, 3] - r[:, 1]).median().item()}),
              flush=True)


def _time(torch, tree: str) -> None:
    sys.path.insert(0, tree)
    from detectandtrack_tpu_torch.kernels import roi_align as ra
    for c in torch.load(_INPUTS):
        dtype = getattr(torch, c["dtype"])

        def call():
            return ra.roi_align_backward(c["shapes"], dtype, c["strides"],
                                         c["rois"], c["slabs"], c["levels"],
                                         c["grad"], c["p"], c["s"])

        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"tree": tree, "stage": f"P={c['p']}",
                          "pairs": c["rois"].shape[0],
                          "ms": start.elapsed_time(end) / 20}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("roi_align_bwd_train: needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        _time(torch, os.path.abspath(args.trees[0]))
        return 0
    sys.path.insert(0, _REPO)
    _capture(torch)
    for tree in args.trees or [_REPO]:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], cwd=_REPO)
        if done.returncode != 0:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
