"""The synthetic end-to-end learning recipe through the port's CLI.

    python3 -m detectandtrack_tpu_torch.tools.smoke_learn [--steps 150]
        [--seeds 3 ...] [--device cuda|cpu] [--out DIR] [KEY VALUE ...]

For each seed (RNG_SEED: the model's init and the samplers' draws):
`--mode train` of `configs/video/synthetic_smoke.yaml` for `--steps` SGD
steps from a seeded init on the generated easy set (`--mode demo-data`,
made once under `--out`), then `--mode test` (batch 2) and `--mode track`
on that set. Prints one JSON line per seed: the tracking mAP and MOTA,
the detection box AP50 and keypoint AP, the training wall time and the
card line (or "cpu"). Dotted opts after the flags apply to every run (the
tests shrink the frames with them). The JAX package's counterpart is its
CLI run the same way (`python -m detectandtrack_tpu.cli.launch`).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Sequence

from ..cli.launch import main as cli

SMOKE_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "video", "synthetic_smoke.yaml")


def learn(out_dir: str, steps: int, seed: int, device: str,
          opts: Sequence[str] = ()) -> dict:
    """Train, test and track one seed under `out_dir` → its metrics."""
    data = os.path.join(out_dir, "data")
    if not os.path.exists(os.path.join(data, "synthetic", "train.json")):
        cli(["--mode", "demo-data", "--out", os.path.join(data, "synthetic")])
    run = os.path.join(out_dir, f"seed{seed}_{steps}")
    args = ["--cfg", SMOKE_CFG, "--out", run, "--device", device,
            "DATA.ROOT", data, "RNG_SEED", str(seed),
            "SOLVER.MAX_ITER", str(steps)] + [str(o) for o in opts]
    t0 = time.perf_counter()
    cli(["--mode", "train"] + args)
    train_s = time.perf_counter() - t0
    cli(["--mode", "test", "--batch-size", "2", "--weights",
         os.path.join(run, "model_final.npz")] + args)
    cli(["--mode", "track"] + args)
    with open(os.path.join(run, "track_metrics.json")) as f:
        track = json.load(f)
    with open(os.path.join(run, "detection_metrics.json")) as f:
        det = json.load(f)
    return {"seed": seed, "steps": steps, "mAP": track["mAP"],
            "MOTA": track["MOTA"], "box_AP50": det["box_AP50"],
            "keypoint_AP": det["keypoint_AP"], "train_s": train_s}


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--seeds", type=int, nargs="+", default=[3])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="out_smoke_learn")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_intermixed_args(argv)
    rows = []
    for seed in args.seeds:
        row = learn(args.out, args.steps, seed, args.device, args.opts)
        if args.device == "cuda":        # the CLI has stopped without one
            from ..utils.env import card_line
            row["device"] = card_line()
        else:
            row["device"] = "cpu"
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
