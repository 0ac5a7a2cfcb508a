"""The port's online detect → track (`StreamingTrackingSink` as the
`frame_sink` of `run_inference`, and the CLI's `--mode stream`) equals its
two-pass test + track frame for frame, on the CPU with a narrow R-18 model:
the same track ids, boxes and keypoints, over overlapping tail windows,
videos interleaved through the bucket queues and multi-scale KPS_AUG. The
sink takes frames out of order and refuses an incomplete video (as
tests/test_stream.py holds the JAX package's)."""

import filecmp
import json
import os

import numpy as np
import pytest

from detectandtrack_tpu_torch.cli.launch import main
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.data.posetrack import PosetrackDataset
from detectandtrack_tpu_torch.data.synthetic import (
    generate_synthetic_posetrack)
from detectandtrack_tpu_torch.engine.inference import run_inference
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.tracking.engine import (StreamingTrackingSink,
                                                      run_posetrack_tracking)

# A narrow R-18 (stream and two-pass run the same port model, so width
# only costs time).
TINY = ["MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "RESNETS.WIDTH_PER_GROUP", 8, "FPN.DIM", 32,
        "FAST_RCNN.MLP_HEAD_DIM", 64,
        "RPN.PRE_NMS_TOP_N_TEST", 50, "RPN.POST_NMS_TOP_N_TEST", 16,
        "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
        "TEST.SCALE", 64, "TEST.MAX_SIZE", 96,
        "TEST.SHAPE_BUCKETS", "[[64, 96]]",
        "KRCNN.NUM_STACKED_CONVS", 1, "KRCNN.CONV_HEAD_DIM", 16,
        "TRACKING.CONF_FILTER_INITIAL_DETS", 0.0]


def test_sink_handles_out_of_order_frames():
    """Frames arriving out of order are buffered and fed to the tracker in
    frame order."""
    rng = np.random.default_rng(0)

    def frame(x):
        return {"boxes": np.array([[x, 10.0, x + 20.0, 40.0]]),
                "scores": np.array([0.9]), "valid": np.array([True]),
                "keypoints": rng.normal(size=(1, 15, 3))}

    frames = [frame(10.0 * i) for i in range(4)]
    sink = StreamingTrackingSink()
    for order in [1, 3, 0, 2]:
        sink("v", order, 4, frames[order])
    tracked = sink.results()["v"]
    offline = run_posetrack_tracking({"v": frames})["v"]
    assert len(tracked) == 4 and sink.buffer_high_water["v"] == 3
    for a, b in zip(tracked, offline):
        np.testing.assert_array_equal(a["track_ids"], b["track_ids"])
        np.testing.assert_array_equal(a["boxes"], b["boxes"])


def test_sink_rejects_incomplete():
    sink = StreamingTrackingSink()
    sink("v", 0, 2, {"boxes": np.zeros((1, 4)), "scores": np.ones(1),
                     "valid": np.ones(1, bool)})
    with pytest.raises(RuntimeError, match="incomplete videos"):
        sink.results()


def _assert_stream_equals_two_pass(cfg, ds, batch):
    model = build_model(cfg, device="cpu", seed=0)
    sink = StreamingTrackingSink(cfg=cfg)
    dets = run_inference(cfg, model, ds, batch_size=batch, frame_sink=sink)
    streamed = sink.results()
    offline = run_posetrack_tracking(dets, cfg=cfg)
    assert set(streamed) == set(offline) == set(ds.videos())
    linked = 0
    for vid in offline:
        assert len(streamed[vid]) == len(offline[vid]) == len(
            ds.video_frames(vid))
        for s, o in zip(streamed[vid], offline[vid]):
            np.testing.assert_array_equal(s["track_ids"], o["track_ids"])
            np.testing.assert_array_equal(s["boxes"], o["boxes"])
            np.testing.assert_array_equal(s["keypoints"], o["keypoints"])
            linked += int((s["track_ids"] >= 0).sum())
    assert linked > 0
    return sink, offline


def test_streaming_equals_two_pass(tmp_path):
    """3 videos of 5 frames at T=2: windows [0,1], [2,3], tail [3,4]."""
    json_path = generate_synthetic_posetrack(
        str(tmp_path), num_videos=3, frames_per_video=5,
        image_hw=(64, 96), people_per_video=2, seed=11)
    cfg = load_cfg(opts=TINY + ["VIDEO.VIDEO_ON", True,
                                "VIDEO.NUM_FRAMES", 2])
    _assert_stream_equals_two_pass(cfg, PosetrackDataset(json_path,
                                                         str(tmp_path)), 2)


def test_streaming_stress_interleaved_videos_memory_bound(tmp_path):
    """Interleaved videos of two frame sizes (crossed bucket routes),
    multi-scale TTA with KPS_AUG, batch 2: stream equals two-pass, and the
    sink's out-of-order buffer stays O(batch × buckets × T) per video."""
    j1 = generate_synthetic_posetrack(
        str(tmp_path / "a"), num_videos=3, frames_per_video=7,
        image_hw=(64, 96), people_per_video=2, seed=21)
    j2 = generate_synthetic_posetrack(
        str(tmp_path / "b"), num_videos=2, frames_per_video=5,
        image_hw=(96, 64), people_per_video=1, seed=22)
    with open(j1) as f:
        d1 = json.load(f)
    with open(j2) as f:
        d2 = json.load(f)
    off = max(im["id"] for im in d1["images"]) + 1
    for im in d2["images"]:
        im["id"] += off
        im["vid_id"] = "b_" + str(im.get("vid_id", ""))
        im["file_name"] = os.path.join("..", "b", im["file_name"])
    for an in d2["annotations"]:
        an["image_id"] += off
    d1["images"] += d2["images"]
    d1["annotations"] += d2["annotations"]
    merged = str(tmp_path / "a" / "merged.json")
    with open(merged, "w") as f:
        json.dump(d1, f)
    ds = PosetrackDataset(merged, str(tmp_path / "a"))
    buckets = [[32, 64], [64, 96], [96, 96]]
    cfg = load_cfg(opts=TINY + [
        "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
        "TEST.BBOX_AUG_ENABLED", True, "TEST.BBOX_AUG_SCALES", "[32]",
        "TEST.KPS_AUG_ENABLED", True, "TEST.SHAPE_BUCKETS", str(buckets)])
    batch = 2
    sink, offline = _assert_stream_equals_two_pass(cfg, ds, batch)
    bound = batch * len(buckets) * cfg.VIDEO.NUM_FRAMES * 2
    for vid, hw in sink.buffer_high_water.items():
        assert hw <= bound, (vid, hw, bound)
        if len(offline[vid]) > bound:
            assert hw < len(offline[vid])


def test_cli_stream_equals_test_then_track(tmp_path):
    """`--mode stream` writes the same track files and metrics as
    `--mode test` then `--mode track`."""
    data = tmp_path / "data"
    generate_synthetic_posetrack(
        str(data / "synthetic"), num_videos=2, frames_per_video=5,
        image_hw=(64, 96), people_per_video=2, seed=5, json_name="val.json")
    opts = [str(x) for x in TINY + [
        "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2, "DATA.ROOT", data,
        "TEST.DATASETS", "[posetrack_synthetic_val]"]]
    base = ["--device", "cpu", "--batch-size", "2"]
    for mode in ("test", "track"):
        main(["--mode", mode, "--out", str(tmp_path / "two")] + base + opts)
    main(["--mode", "stream", "--out", str(tmp_path / "one"),
          "--det-out", str(tmp_path / "one" / "dets.pkl")] + base + opts)
    names = sorted(os.listdir(tmp_path / "two" / "tracks"))
    assert len(names) == 2
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "two" / "tracks", tmp_path / "one" / "tracks", names,
        shallow=False)
    assert not mismatch and not errors
    with open(tmp_path / "two" / "track_metrics.json") as f, open(
            tmp_path / "one" / "track_metrics.json") as g:
        assert json.load(f) == json.load(g)
    assert os.path.exists(tmp_path / "one" / "dets.pkl")
