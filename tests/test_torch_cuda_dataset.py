"""The port's dataset-level inference on a CUDA card against its CPU path,
on the same seeded weights and generated set: `run_inference` (pinned,
non-blocking host → card copies, batch padding, a tail window, a short
video) gives the CPU's per-frame detections (f32, TF32 off: valid masks
equal, scores 1e-4, boxes 1e-2), and the streamed tracks equal the
two-pass ones on the card. Skipped without a card. On the card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_cuda_dataset.py
"""

import json

import numpy as np
import pytest
import torch

from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.data.posetrack import PosetrackDataset
from detectandtrack_tpu_torch.data.synthetic import (
    generate_synthetic_posetrack)
from detectandtrack_tpu_torch.engine.inference import run_inference
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.tracking.engine import (StreamingTrackingSink,
                                                      run_posetrack_tracking)

pytestmark = pytest.mark.cuda

OPTS = ["MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
        "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
        "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
        "TEST.SCALE", 64, "TEST.MAX_SIZE", 96,
        "TEST.SHAPE_BUCKETS", "[[64, 96]]", "KRCNN.NUM_STACKED_CONVS", 2,
        "KRCNN.CONV_HEAD_DIM", 32, "TRACKING.CONF_FILTER_INITIAL_DETS", 0.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dataset(root):
    """Videos of 5 and 1 frames (a tail window, a short video)."""
    for i, n in enumerate((5, 1)):
        generate_synthetic_posetrack(
            str(root), num_videos=1, frames_per_video=n, image_hw=(64, 96),
            people_per_video=2, seed=30 + i, json_name=f"p{i}.json",
            video_prefix=f"v{n}")
    docs = [json.loads((root / f"p{i}.json").read_text()) for i in range(2)]
    off = max(im["id"] for im in docs[0]["images"])
    for im in docs[1]["images"]:
        im["id"] += off
    for an in docs[1]["annotations"]:
        an["image_id"] += off
    for key in ("images", "annotations"):
        docs[0][key] += docs[1][key]
    (root / "val.json").write_text(json.dumps(docs[0]))
    return PosetrackDataset(str(root / "val.json"), str(root))


def test_run_inference_on_card_matches_cpu(cuda, tmp_path):
    ds = _dataset(tmp_path)
    cfg = load_cfg(opts=OPTS)
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev, seed=0)
        sink = StreamingTrackingSink(cfg=cfg)
        dets = run_inference(cfg, model, ds, batch_size=3, frame_sink=sink)
        runs[dev] = (dets, sink.results())
    (ref, _), (got, streamed) = runs["cpu"], runs["cuda"]
    assert list(got) == list(ref) == ["v1_0000", "v5_0000"]
    for vid in ref:
        assert len(got[vid]) == len(ref[vid]) == int(vid[1])
        for g, w in zip(got[vid], ref[vid]):
            np.testing.assert_array_equal(g["valid"], w["valid"])
            v = w["valid"]
            assert v.any()
            np.testing.assert_allclose(g["scores"][v], w["scores"][v],
                                       atol=1e-4)
            np.testing.assert_allclose(g["boxes"][v], w["boxes"][v],
                                       atol=1e-2)
            assert np.isfinite(g["keypoints"]).all()
    offline = run_posetrack_tracking(got, cfg=cfg)
    for vid in offline:
        for s, o in zip(streamed[vid], offline[vid]):
            np.testing.assert_array_equal(s["track_ids"], o["track_ids"])
