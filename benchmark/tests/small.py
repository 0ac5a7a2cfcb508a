"""Small CPU runs of the benchmark's cells: the cells' own configuration
and traffic, cut to T=2 frames, 64 x 96 clips and a few rois, so that a
test drives the harness, the system's CPU path and the reference in
seconds."""

import copy
import json
from pathlib import Path

import torch

from benchmark import harness
from benchmark.manifest import Manifest

BENCH = Path(__file__).resolve().parents[1]


def small_config(name="r50_t8", dtype=None):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = cfg["cfg"]
    c["VIDEO"]["NUM_FRAMES"] = 2
    c["RPN"].update(POST_NMS_TOP_N_TEST=30, PRE_NMS_TOP_N_TRAIN=100,
                    POST_NMS_TOP_N_TRAIN=50, BATCH_SIZE_PER_IM=32)
    c["TEST"].update(DETECTIONS_PER_IM=10, SHAPE_BUCKETS=[[64, 96]])
    c["KRCNN"].update(MAX_ROIS_PER_IM=4, TRAIN_MAX_ROIS_PER_IM=8)
    c["TRAIN"].update(SCALES=[48], MAX_SIZE=96, MAX_GT_PER_IM=8)
    c["FAST_RCNN"]["BATCH_SIZE_PER_IM"] = 32
    if dtype:
        c["MODEL"]["COMPUTE_DTYPE"] = dtype
    return cfg


SMALL_TRAFFIC = {
    "infer_b4": dict(batch=2, clip_hw=[64, 96], trace_seconds=1),
    "train_b1": dict(frame_hw=[45, 80], gt_range=[2, 4], trace_seconds=1),
}


def small_run(cell, seed=2 ** 33 + 5, trace=False, dtype=None,
              seconds=0.5):
    """(manifest, Run) of `cell` cut small, on the CPU."""
    m = Manifest.load(BENCH)
    w = m.cell(cell)
    tr = copy.deepcopy(m.traffic(w["traffic"]))
    tr.update(SMALL_TRAFFIC[w["traffic"]])
    run = harness.Run(cell=w, config=small_config(w["config"], dtype),
                      traffic=tr, limits=m.limits(cell), seed=seed,
                      seconds=seconds, trace=trace,
                      device=torch.device("cpu"))
    return m, run
