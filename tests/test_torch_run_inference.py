"""The port's `run_inference` host logic against the JAX package's, with no
model compile: both packages' `make_detect_fn` / `make_kps_aug_fns` are
replaced by one deterministic numpy function of the clip pixels (and of
the proposal tubes and boxes it is given). Held exactly equal: the
per-frame dicts, the order and contents of `frame_sink` calls, the keys of
`dispatch_log` and the batches handed to the detector, for tail windows,
short videos, batch padding across videos, `max_clips`/`video_range`,
proposal files and multi-scale TTA with and without KPS_AUG over several
shape buckets."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from detectandtrack_tpu.core.config import load_cfg as jax_load_cfg
from detectandtrack_tpu.data.posetrack import PosetrackDataset as JDataset
from detectandtrack_tpu.data.synthetic import generate_synthetic_posetrack
from detectandtrack_tpu.engine import inference as jinf
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.data.posetrack import PosetrackDataset
from detectandtrack_tpu_torch.engine import inference as tinf

D, K = 5, 15
BASE = ["TEST.DETECTIONS_PER_IM", D, "TEST.SCALE", 64, "TEST.MAX_SIZE", 96,
        "TEST.SHAPE_BUCKETS", "[[64, 96]]", "RPN.POST_NMS_TOP_N_TEST", 6]


def _fake_outputs(clips, tubes=None, tvalid=None):
    """(B, T, H, W, 3) float32 clips → padded detections that depend on
    every clip's pixels: D boxes per frame inside the clip, scores with
    ties, a validity pattern, keypoints, features. With tubes, the valid
    proposal rows become the boxes (shifted by a pixel statistic)."""
    clips = np.asarray(clips, np.float32)
    b, t, h, w, _ = clips.shape
    m = clips.astype(np.float64).mean(axis=(2, 3))             # (B, T, 3)
    s = np.abs(m).sum(-1)                                      # (B, T)
    d = np.arange(D, dtype=np.float64)
    x1 = (s[:, None, :] * (d[None, :, None] + 1) * 3.1) % (w * 0.6)
    y1 = (s[:, None, :] * (d[None, :, None] + 2) * 1.7) % (h * 0.6)
    bw = 6 + (d[None, :, None] * 5 + s[:, None, :]) % (w * 0.3)
    bh = 8 + (d[None, :, None] * 3 + s[:, None, :]) % (h * 0.3)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)           # (B, D, T, 4)
    if tubes is not None:
        tubes = np.asarray(tubes, np.float64).reshape(b, -1, t, 4)
        tv = np.asarray(tvalid, bool)
        n = min(D, tubes.shape[1])
        shift = (s[:, None, :, None] % 3.0)
        boxes[:, :n] = np.where(tv[:, :n, None, None], tubes[:, :n] + shift,
                                boxes[:, :n])
    scores = ((s.sum(-1)[:, None] * (d[None] + 1) * 0.37) % 1.0)
    scores[:, 1] = scores[:, 0]                                # a tie
    valid = ((s.sum(-1)[:, None] * 10 + d[None]) % 5) < 4
    kps = np.zeros((b, D, t, K, 4))
    kj = np.arange(K) / K
    kps[..., 0] = boxes[..., 0:1] + kj * (boxes[..., 2:3] - boxes[..., 0:1])
    kps[..., 1] = boxes[..., 1:2] + kj[::-1] * (boxes[..., 3:4]
                                               - boxes[..., 1:2])
    kps[..., 2] = kj * 3.0
    kps[..., 3] = (kj + s[:, None, :, None] * 0.01) % 1.0
    return {"boxes": boxes.reshape(b, D, 4 * t).astype(np.float32),
            "scores": scores.astype(np.float32),
            "valid": valid,
            "features": np.repeat(m.reshape(b, 1, -1), D, 1).astype(
                np.float32),
            "keypoints": kps.astype(np.float32)}


def _fake_heatmaps(clips, boxes):
    """One KPS_AUG scale pass: (B, D, T, 2, 2, K) from the clip's pixels
    and the boxes in its coordinates."""
    clips = np.asarray(clips, np.float32)
    boxes = np.asarray(boxes, np.float32)
    b, t = clips.shape[:2]
    m = clips.mean(axis=(2, 3, 4))                             # (B, T)
    bx = boxes.reshape(b, D, t, 4).sum(-1)                     # (B, D, T)
    hm = (m[:, None, :, None, None, None] * 0.1
          + bx[..., None, None, None] * 0.01
          + np.arange(K, dtype=np.float32) * 0.05)
    return np.broadcast_to(hm, (b, D, t, 2, 2, K)).astype(np.float32)


def _fake_decode(hms, boxes):
    """Mean over the stacked scales, decoded at the boxes (original coords)
    → (B, D, T, K, 4)."""
    hm = np.asarray(hms, np.float32).mean(0)                   # (B,D,T,2,2,K)
    boxes = np.asarray(boxes, np.float32)
    b, _, t = hm.shape[:3]
    bx = boxes.reshape(b, D, t, 4)
    val = hm.mean(axis=(3, 4))                                 # (B, D, T, K)
    return np.stack([bx[..., 0:1] + val, bx[..., 1:2] + 2 * val, val,
                     (val * 7) % 1.0], -1).astype(np.float32)


class _Fakes:
    """Both packages' detect factories replaced; records each package's
    detector calls (batch size, clip shape, tubes given)."""

    def __init__(self, monkeypatch):
        self.calls = {"jax": [], "port": []}

        def jax_detect_fn(model, mesh=None, flip_tta=False,
                          with_proposals=False):
            def detect(params, clips, tubes=None, tvalid=None):
                self.calls["jax"].append(("detect", tuple(clips.shape),
                                          tubes is not None, flip_tta))
                return _fake_outputs(clips, tubes, tvalid)
            return detect

        def jax_kps_fns(model, flip, mesh=None):
            def hm(params, clips, boxes):
                self.calls["jax"].append(("hm", tuple(clips.shape), flip))
                return _fake_heatmaps(clips, boxes)

            def decode(params, hms, boxes):
                self.calls["jax"].append(("decode", tuple(hms.shape)))
                return _fake_decode(hms, boxes)
            return hm, decode

        def port_detect_fn(model, with_proposals=False, run_rpn=False,
                           flip_tta=False):
            def detect(clips, tubes=None, tvalid=None):
                assert torch.is_tensor(clips) and clips.dtype == torch.float32
                self.calls["port"].append(("detect", tuple(clips.shape),
                                           tubes is not None, flip_tta))
                out = _fake_outputs(
                    clips.numpy(), None if tubes is None else tubes.numpy(),
                    None if tvalid is None else tvalid.numpy())
                return {k: torch.from_numpy(v) for k, v in out.items()}
            return detect

        def port_kps_fns(model, flip):
            def hm(clips, boxes):
                self.calls["port"].append(("hm", tuple(clips.shape), flip))
                return torch.from_numpy(_fake_heatmaps(clips.numpy(),
                                                       boxes.numpy()))

            def decode(hms, boxes):
                self.calls["port"].append(("decode", tuple(hms.shape)))
                return torch.from_numpy(_fake_decode(hms.numpy(),
                                                     boxes.numpy()))
            return hm, decode

        monkeypatch.setattr(jinf, "make_detect_fn", jax_detect_fn)
        monkeypatch.setattr(jinf, "make_kps_aug_fns", jax_kps_fns)
        monkeypatch.setattr(tinf, "make_detect_fn", port_detect_fn)
        monkeypatch.setattr(tinf, "make_kps_aug_fns", port_kps_fns)


def _run_both(monkeypatch, json_path, image_root, opts, **kw):
    """Both packages' run_inference on one dataset file, with a recording
    sink and a dispatch log each → (port, jax) results, sink records,
    dispatch logs and detector calls."""
    fakes = _Fakes(monkeypatch)
    out = {}
    for name, cfg, ds, run in (
            ("jax", jax_load_cfg(opts=opts), JDataset(json_path, image_root),
             lambda c, d, **a: jinf.run_inference(c, None, None, d, **a)),
            ("port", load_cfg(opts=opts),
             PosetrackDataset(json_path, image_root),
             lambda c, d, **a: tinf.run_inference(
                 c, torch.nn.Linear(1, 1), d, **a))):
        sunk, log = [], {}
        dets = run(cfg, ds, frame_sink=lambda *a: sunk.append(a),
                   dispatch_log=log, **kw)
        out[name] = (dets, sunk, sorted(log))
    assert fakes.calls["port"] == fakes.calls["jax"]
    return out["port"], out["jax"], fakes.calls["port"]


def _assert_frames_equal(got, want):
    assert list(got) == list(want)
    for vid in want:
        assert len(got[vid]) == len(want[vid])
        for g, w in zip(got[vid], want[vid]):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_sinks_equal(got, want):
    assert [a[:3] for a in got] == [a[:3] for a in want]
    for g, w in zip(got, want):
        for k in w[3]:
            np.testing.assert_array_equal(g[3][k], w[3][k])


@pytest.fixture(scope="module")
def lengths_set(tmp_path_factory):
    """Videos of 7, 5, 3 and 2 frames (tails, exact fits, short videos)."""
    root = tmp_path_factory.mktemp("lengths")
    docs = []
    for i, n in enumerate((7, 5, 3, 2)):
        path = generate_synthetic_posetrack(
            str(root), num_videos=1, frames_per_video=n, image_hw=(64, 96),
            people_per_video=2, seed=20 + i, json_name=f"part{i}.json",
            video_prefix=f"len{n}")
        with open(path) as f:
            docs.append(json.load(f))
    merged = docs[0]
    for doc in docs[1:]:
        off = max(im["id"] for im in merged["images"])
        for im in doc["images"]:
            im["id"] += off
        for an in doc["annotations"]:
            an["image_id"] += off
        merged["images"] += doc["images"]
        merged["annotations"] += doc["annotations"]
    path = root / "val.json"
    path.write_text(json.dumps(merged))
    return str(path), str(root)


@pytest.mark.parametrize("t,stride,batch,extra", [
    (2, 1, 2, {}),
    (4, 1, 2, {}),
    (3, 2, 3, {}),
    (1, 1, 4, {}),
    (2, 1, 2, {"max_clips": 5}),
    (4, 1, 1, {"video_range": (1, 3)}),
])
def test_windows_tails_short_videos_and_padding(monkeypatch, lengths_set, t,
                                                stride, batch, extra):
    opts = BASE + ["VIDEO.VIDEO_ON", t > 1, "VIDEO.NUM_FRAMES", t,
                   "VIDEO.FRAME_STRIDE", stride]
    got, want, calls = _run_both(monkeypatch, *lengths_set, opts,
                                 batch_size=batch, **extra)
    _assert_frames_equal(got[0], want[0])
    _assert_sinks_equal(got[1], want[1])
    assert got[2] == want[2]
    assert all(c[1][0] == batch for c in calls)         # padded batches
    if not extra and stride == 1:
        assert {v: len(f) for v, f in got[0].items()} == {
            "len2_0000": 2, "len3_0000": 3, "len5_0000": 5, "len7_0000": 7}
        assert len(got[1]) == 17 and len(got[2]) == 17  # each frame once


def _proposal_db(ds, seed=0):
    rng = np.random.default_rng(seed)
    db = {}
    for vid in ds.videos():
        per = {}
        for idx, fr in enumerate(ds.video_frames(vid)):
            poses = sorted(ds.gt_poses(fr), key=lambda p: p["track_id"])
            boxes = np.array([p["box"] for p in poses], np.float32)
            per[idx] = boxes + rng.normal(scale=2.0, size=boxes.shape).astype(
                np.float32)
        db[vid] = per
    return db


@pytest.mark.parametrize("t,batch", [(2, 2), (1, 3)])
def test_proposal_files(monkeypatch, lengths_set, tmp_path, t, batch):
    json_path, root = lengths_set
    prop = tmp_path / "props.pkl"
    with open(prop, "wb") as f:
        pickle.dump(_proposal_db(JDataset(json_path, root)), f)
    opts = BASE + ["VIDEO.VIDEO_ON", t > 1, "VIDEO.NUM_FRAMES", t,
                   "TEST.DATASETS", "[posetrack_synthetic_val]",
                   "TEST.PROPOSAL_FILES", f"[{prop}]"]
    got, want, calls = _run_both(monkeypatch, json_path, root, opts,
                                 batch_size=batch)
    _assert_frames_equal(got[0], want[0])
    _assert_sinks_equal(got[1], want[1])
    assert got[2] == want[2]
    assert calls and all(c[2] for c in calls)           # tubes reached it


@pytest.fixture(scope="module")
def two_size_set(tmp_path_factory):
    """Landscape and portrait videos in one file (test_stream.py's stress
    set, smaller): their scale passes route through crossed buckets."""
    root = tmp_path_factory.mktemp("two_size")
    j1 = generate_synthetic_posetrack(
        str(root / "a"), num_videos=2, frames_per_video=5,
        image_hw=(64, 96), people_per_video=2, seed=21)
    j2 = generate_synthetic_posetrack(
        str(root / "b"), num_videos=2, frames_per_video=3,
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
    merged = root / "a" / "merged.json"
    merged.write_text(json.dumps(d1))
    return str(merged), str(root / "a")


@pytest.mark.parametrize("t,batch,kps_aug,scales", [
    (1, 1, True, "[32]"),
    (2, 2, True, "[32]"),
    (2, 3, True, "[32, 96]"),
    (2, 2, False, "[32]"),
])
def test_multiscale_tta(monkeypatch, two_size_set, t, batch, kps_aug, scales):
    opts = BASE + ["VIDEO.VIDEO_ON", t > 1, "VIDEO.NUM_FRAMES", t,
                   "TEST.BBOX_AUG_ENABLED", True,
                   "TEST.BBOX_AUG_SCALES", scales,
                   "TEST.KPS_AUG_ENABLED", kps_aug,
                   "TEST.SHAPE_BUCKETS", "[[32, 64], [64, 96], [96, 96]]"]
    got, want, calls = _run_both(monkeypatch, *two_size_set, opts,
                                 batch_size=batch)
    _assert_frames_equal(got[0], want[0])
    _assert_sinks_equal(got[1], want[1])
    assert got[2] == want[2]
    assert all(c[3] for c in calls if c[0] == "detect")  # flip TTA asked
    shapes = {c[1][2:4] for c in calls if c[0] == "detect"}
    assert len(shapes) >= 2                             # several buckets
    assert any(c[0] == "decode" for c in calls) == kps_aug
    assert {v: len(f) for v, f in got[0].items()} == {
        "video_0000": 5, "video_0001": 5, "b_video_0000": 3,
        "b_video_0001": 3}
