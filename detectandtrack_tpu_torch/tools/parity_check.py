"""One-command real-data parity check against the reference contract
(port of tools/parity_check.py).

    python -m detectandtrack_tpu_torch.tools.parity_check \
        --pkl model_final.pkl --ann posetrack_val.json --frames images/ \
        [--cfg configs/video/3d_R50_T8_tubes_kps.yaml] [--out out/parity] \
        [--target-map 60.6 --target-mota 55.2] [--tolerance 0.1] \
        [--ref-dets detections.pkl] [--max-clips N] [--device cuda|cpu]

It chains, through the port's CLI on `--device` (default `cuda`; with no
CUDA device it stops, `--device cpu` runs on the CPU):

  1. `--mode import-weights` on the Detectron `.pkl` (2D→3D inflation and
     COCO→PoseTrack head surgery, `utils/detectron_import.py`);
  2. registers the annotation file as the dataset `parity_val`;
  3. `--mode stream` (one-pass detect→track) on it, writing
     `OUT/our_dets.pkl` when `--ref-dets` is given;
  4. prints the evaluator's mAP and MOTA with their deltas against
     `--target-map` / `--target-mota` as one JSON object;
  5. with `--ref-dets`, diffs the detections against a Detectron
     `detections.pkl` (`all_boxes` / `all_keyps` per image): the mean
     best-IoU of each reference box and the mean keypoint pixel delta.

Exit code 0 when both metrics are within `--tolerance` of the targets, else
1. The targets default to the paper-recalled values the JAX package's
tool uses. `to_detectron_detections` rewrites the CLI's detections into
the Detectron form that `--ref-dets` reads; `printed_reports` reads the
printed JSON back.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import Dict, List

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pkl", required=True, help="reference model_final.pkl")
    p.add_argument("--ann", required=True, help="PoseTrack val json")
    p.add_argument("--frames", required=True, help="frames root dir")
    p.add_argument("--cfg", default="configs/video/3d_R50_T8_tubes_kps.yaml")
    p.add_argument("--out", default="out/parity")
    p.add_argument("--target-map", type=float, default=60.6)
    p.add_argument("--target-mota", type=float, default=55.2)
    p.add_argument("--tolerance", type=float, default=0.1)
    p.add_argument("--ref-dets", default=None,
                   help="reference detections.pkl for raw-output diffs")
    p.add_argument("--max-clips", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..cli import launch as cli
    from ..data import posetrack as ptk

    cli._device(args)                    # no card for cuda: stop here
    os.makedirs(args.out, exist_ok=True)
    # PosetrackDataset joins DATA.ROOT with the catalog's paths, and an
    # absolute path survives the join.
    ptk._CATALOG["parity_val"] = (os.path.abspath(args.ann),
                                  os.path.abspath(args.frames))
    device = ["--device", args.device]
    npz = cli.main(["--mode", "import-weights", "--cfg", args.cfg,
                    "--weights", args.pkl, "--out", args.out] + device)

    stream_args = ["--mode", "stream", "--cfg", args.cfg,
                   "--weights", npz, "--out", args.out] + device + [
                   "TEST.DATASETS", "[parity_val]"]
    if args.max_clips:
        stream_args += ["--max-clips", str(args.max_clips)]
    if args.ref_dets:
        stream_args += ["--det-out", os.path.join(args.out, "our_dets.pkl")]
    cli.main(stream_args)

    with open(os.path.join(args.out, "track_metrics.json")) as f:
        metrics = json.load(f)
    m_ap = metrics.get("mAP")
    mota = metrics.get("MOTA")
    d_ap = m_ap - args.target_map
    d_mota = mota - args.target_mota
    ok = abs(d_ap) <= args.tolerance and abs(d_mota) <= args.tolerance
    print(json.dumps({
        "mAP": m_ap, "MOTA": mota,
        "target_mAP": args.target_map, "target_MOTA": args.target_mota,
        "delta_mAP": round(d_ap, 3), "delta_MOTA": round(d_mota, 3),
        "within_tolerance": ok, "tolerance": args.tolerance,
        "targets_provenance": "BASELINE.md [P] paper-recalled — re-verify",
    }, indent=2))

    if args.ref_dets:
        _diff_against_reference(args)
    return 0 if ok else 1


def _diff_against_reference(args):
    """Best-IoU box + keypoint deltas vs a Detectron detections.pkl."""
    with open(args.ref_dets, "rb") as f:
        ref = pickle.load(f, encoding="latin1")
    with open(os.path.join(args.out, "our_dets.pkl"), "rb") as f:
        ours = pickle.load(f)
    # Detectron format: all_boxes[cls][image] = (N, 5); all_keyps[cls]
    # [image] = list of (4, K). Flatten our per-video frames in dataset
    # image order to align.
    ref_boxes = ref["all_boxes"][1]
    ref_keyps = ref.get("all_keyps", [None, []])[1]
    flat = []
    for vid in sorted(ours):
        flat.extend(ours[vid])
    n = min(len(flat), len(ref_boxes))
    ious, kp_px = [], []
    for i in range(n):
        rb = np.asarray(ref_boxes[i], np.float64)
        fr = flat[i]
        ob = np.asarray(fr["boxes"], np.float64)
        ov = np.asarray(fr.get("valid", np.ones(len(ob), bool)))
        ob = ob[ov]
        if not len(rb) or not len(ob):
            continue
        for j, r in enumerate(rb):
            iw = (np.minimum(r[2], ob[:, 2]) - np.maximum(r[0], ob[:, 0])
                  + 1).clip(0)
            ih = (np.minimum(r[3], ob[:, 3]) - np.maximum(r[1], ob[:, 1])
                  + 1).clip(0)
            inter = iw * ih
            area = ((r[2] - r[0] + 1) * (r[3] - r[1] + 1)
                    + (ob[:, 2] - ob[:, 0] + 1) * (ob[:, 3] - ob[:, 1] + 1)
                    - inter)
            best = int(np.argmax(inter / np.maximum(area, 1e-9)))
            ious.append(float((inter / np.maximum(area, 1e-9))[best]))
            if ref_keyps and i < len(ref_keyps) and j < len(ref_keyps[i]) \
                    and "keypoints" in fr:
                rk = np.asarray(ref_keyps[i][j], np.float64)   # (4, K)
                okp = np.asarray(fr["keypoints"], np.float64)[ov][best]
                kp_px.append(float(np.mean(np.hypot(
                    okp[:, 0] - rk[0], okp[:, 1] - rk[1]))))
    print(json.dumps({
        "ref_images_compared": n,
        "mean_best_iou": round(float(np.mean(ious)), 4) if ious else None,
        "mean_kp_px_delta": (round(float(np.mean(kp_px)), 3)
                             if kp_px else None),
    }, indent=2))


def printed_reports(text: str) -> List[dict]:
    """The JSON objects the tool printed into `text` (the metrics, then the
    diff when `--ref-dets` was given), in order."""
    dec, out = json.JSONDecoder(), []
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if line.rstrip() == "{":
            out.append(dec.raw_decode("".join(lines[i:]))[0])
    return out


def to_detectron_detections(dets: Dict[str, List[dict]]) -> dict:
    """The CLI's detections ({video: [frame dict]}, as `--det-out` writes
    them) → Detectron's `{"all_boxes", "all_keyps"}` for class 1, one entry
    per frame in the order `_diff_against_reference` flattens them: valid
    rows only, boxes (N, 5) with the score last, keypoints (4, K) per
    detection with rows x, y, prob, prob (the frame dicts keep no logit).
    Values keep their dtype (float64 from the CLI): a rounded copy of a
    box a pixel-fraction wide would not be the box."""
    boxes, keyps = [], []
    for vid in sorted(dets):
        for fr in dets[vid]:
            v = np.asarray(fr["valid"], bool)
            b = np.asarray(fr["boxes"])[v]
            boxes.append(np.concatenate(
                [b, np.asarray(fr["scores"], b.dtype)[v, None]], axis=1))
            kps = np.asarray(fr["keypoints"])[v]                 # (N, K, 3)
            keyps.append([np.stack([k[:, 0], k[:, 1], k[:, 2], k[:, 2]])
                          for k in kps])
    return {"all_boxes": [[], boxes], "all_keyps": [[], keyps]}


if __name__ == "__main__":
    sys.exit(main())
