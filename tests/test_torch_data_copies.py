"""The port's copies of the JAX package's host data, evaluation and tracking
modules against the originals, on the same inputs (numpy-seeded): the
synthetic set generator (JSON and JPEG bytes), the PoseTrack dataset, clip
loading and batching, masks, TTA merge helpers, host NMS, OKS, the
evaluators, the tracking engine's writers and readers, the training
statistics, the subprocess fan-out, the visualizer and the small
utilities. All are exact."""

import dataclasses
import filecmp
import json
import logging
import os
import sys
import types

import numpy as np
import pytest

from detectandtrack_tpu.core.config import load_cfg as jax_load_cfg
from detectandtrack_tpu.data import pipeline as jpipe
from detectandtrack_tpu.data import posetrack as jpt
from detectandtrack_tpu.data import synthetic as jsyn
from detectandtrack_tpu.engine import augment as jaug
from detectandtrack_tpu.engine import inference as jinf
from detectandtrack_tpu.ops import keypoints as jkp
from detectandtrack_tpu.ops import masks as jmasks
from detectandtrack_tpu.ops import nms as jnms
from detectandtrack_tpu.tracking import engine as jeng
from detectandtrack_tpu.tracking import evaluation as jeval
from detectandtrack_tpu.utils import io as jio
from detectandtrack_tpu.utils import logging_utils as jlog
from detectandtrack_tpu.utils import subprocess_utils as jsub
from detectandtrack_tpu.utils import timer as jtimer
from detectandtrack_tpu.utils import training_stats as jstats
from detectandtrack_tpu.utils import vis as jvis
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.data import pipeline as tpipe
from detectandtrack_tpu_torch.data import posetrack as tpt
from detectandtrack_tpu_torch.data import synthetic as tsyn
from detectandtrack_tpu_torch.engine import augment as taug
from detectandtrack_tpu_torch.engine import inference as tinf
from detectandtrack_tpu_torch.ops import keypoints as tkp
from detectandtrack_tpu_torch.ops import masks as tmasks
from detectandtrack_tpu_torch.ops import nms as tnms
from detectandtrack_tpu_torch.tracking import engine as teng
from detectandtrack_tpu_torch.tracking import evaluation as teval
from detectandtrack_tpu_torch.utils import io as tio
from detectandtrack_tpu_torch.utils import logging_utils as tlog
from detectandtrack_tpu_torch.utils import subprocess_utils as tsub
from detectandtrack_tpu_torch.utils import timer as ttimer
from detectandtrack_tpu_torch.utils import training_stats as tstats
from detectandtrack_tpu_torch.utils import vis as tvis


def _assert_same(got, want, path="out"):
    """Nested dicts / lists / tuples / arrays / scalars equal exactly (NaN
    equal to NaN), with the same types of containers."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _generate(pkg, out, hard, **kw):
    args = dict(num_videos=2, frames_per_video=4, image_hw=(72, 104),
                people_per_video=2, seed=3, hard=hard)
    args.update(kw)
    return pkg.generate_synthetic_posetrack(str(out), **args)


@pytest.mark.parametrize("hard", [False, True])
def test_generated_set_is_byte_identical(tmp_path, hard):
    want = _generate(jsyn, tmp_path / "jax", hard, json_name="val.json",
                     video_prefix="clip")
    got = _generate(tsyn, tmp_path / "port", hard, json_name="val.json",
                    video_prefix="clip")
    assert os.path.basename(got) == os.path.basename(want) == "val.json"
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()
    files = sorted(os.path.relpath(os.path.join(d, n), tmp_path / "jax")
                   for d, _, ns in os.walk(tmp_path / "jax") for n in ns)
    jpgs = [f for f in files if f.endswith(".jpg")]
    assert len(jpgs) == 8
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """An easy, a hard and a portrait set on disk (the JAX generator's)."""
    root = tmp_path_factory.mktemp("sets")
    easy = _generate(jsyn, root / "easy", False, frames_per_video=5)
    hard = _generate(jsyn, root / "hard", True, image_hw=(96, 128),
                     num_videos=3, frames_per_video=3)
    tall = _generate(jsyn, root / "tall", False, image_hw=(120, 64),
                     num_videos=1, frames_per_video=2)
    return {"easy": (easy, str(root / "easy")),
            "hard": (hard, str(root / "hard")),
            "tall": (tall, str(root / "tall"))}


def _datasets(sets, name):
    json_path, image_root = sets[name]
    return (tpt.PosetrackDataset(json_path, image_root),
            jpt.PosetrackDataset(json_path, image_root))


@pytest.mark.parametrize("name", ["easy", "hard", "tall"])
def test_dataset_records_and_gt_poses(sets, name):
    got, want = _datasets(sets, name)
    assert got.videos() == want.videos()
    assert got.keypoint_names == want.keypoint_names
    assert got.num_keypoints == want.num_keypoints
    for vid in want.videos():
        frames = want.video_frames(vid)
        assert [dataclasses.asdict(f) for f in got.video_frames(vid)] == [
            dataclasses.asdict(f) for f in frames]
        for g, w in zip(got.video_frames(vid), frames):
            assert got.image_path(g) == want.image_path(w)
            _assert_same(got.gt_poses(g), want.gt_poses(w))
        for args in ((0, 2, 1), (1, 4, 2), (3, 8, 1)):
            assert ([f.image_id for f in got.clip_records(vid, *args)]
                    == [f.image_id for f in want.clip_records(vid, *args)])
    for args in ((2, 1, True), (2, 1, False), (3, 2, False), (8, 1, False)):
        assert got.clip_windows(*args) == want.clip_windows(*args)


def test_dataset_catalog(tmp_path):
    assert tpt._CATALOG == jpt._CATALOG
    for name in jpt._CATALOG:
        ann, images = jpt._CATALOG[name]
        path = tmp_path / ann
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"images": [], "annotations": []}))
        got = tpt.get_dataset(name, str(tmp_path))
        want = jpt.get_dataset(name, str(tmp_path))
        assert (got.json_path, got.image_root) == (want.json_path,
                                                   want.image_root)
    with pytest.raises(KeyError) as jerr:
        jpt.get_dataset("nope", str(tmp_path))
    with pytest.raises(KeyError) as terr:
        tpt.get_dataset("nope", str(tmp_path))
    assert str(terr.value) == str(jerr.value)


# (set, video index, start, T, stride, flipped, bucket, mask size, scale
#  target, max size, GT min area)
_CLIPS = {
    "plain": ("easy", 0, 1, 2, 1, False, (64, 96), 0, 64, 96, -1.0),
    "flipped": ("easy", 1, 0, 3, 2, True, (64, 96), 0, 64, 96, -1.0),
    "masks": ("hard", 2, 0, 2, 1, False, (96, 128), 14, 96, 128, -1.0),
    "masks flipped, GT area filter": ("hard", 1, 1, 2, 1, True, (64, 96),
                                      14, 64, 96, 120.0),
    "short video clamps": ("hard", 0, 1, 4, 1, False, (64, 96), 0, 64, 96,
                           -1.0),
    "portrait into landscape bucket": ("tall", 0, 0, 2, 1, False, (64, 96),
                                       8, 80, 200, -1.0),
    "bucket picked from the list": ("easy", 0, 2, 2, 1, False, None, 0, 48,
                                    96, -1.0),
}


@pytest.mark.parametrize("case", list(_CLIPS))
def test_load_clip(sets, case):
    (name, vi, start, t, stride, flipped, bucket, mask, target, max_size,
     min_area) = _CLIPS[case]
    got_ds, want_ds = _datasets(sets, name)
    vid = want_ds.videos()[vi]
    kw = dict(bucket_hw=bucket, buckets=((32, 64), (64, 96)), max_gt=4,
              num_keypoints=15, gt_min_area=min_area, mask_size=mask)
    means, stds = (102.9801, 115.9465, 122.7717), (1.0, 2.0, 1.0)
    want = jpipe.load_clip(want_ds, jpipe.ClipSpec(vid, start, flipped),
                           t, stride, means, stds, target, max_size, **kw)
    got = tpipe.load_clip(got_ds, tpipe.ClipSpec(vid, start, flipped),
                          t, stride, means, stds, target, max_size, **kw)
    _assert_same(got, want)
    assert want["gt_valid"].any()
    if mask:
        assert want["gt_masks"].any()


def test_choose_scale_and_pick_bucket():
    buckets = [(32, 64), (64, 96), (96, 96)]
    for h, w in ((64, 96), (96, 64), (720, 1280), (1280, 720), (5, 7)):
        for target, max_size in ((64, 96), (800, 1333), (600, 1000)):
            s = jpipe.choose_scale(h, w, target, max_size)
            assert tpipe.choose_scale(h, w, target, max_size) == s
            sh, sw = int(round(h * s)), int(round(w * s))
            assert (tpipe.pick_bucket(sh, sw, buckets)
                    == jpipe.pick_bucket(sh, sw, buckets))


@pytest.mark.parametrize("train,workers", [(True, 1), (True, 3),
                                           (False, 1)])
def test_clip_batcher_batches(sets, train, workers):
    opts = ["VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
            "TRAIN.SCALES", "[64, 32]", "TRAIN.MAX_SIZE", 96,
            "TEST.SCALE", 64, "TEST.MAX_SIZE", 96,
            "TEST.SHAPE_BUCKETS", "[[32, 64], [64, 96]]",
            "TRAIN.MAX_GT_PER_IM", 4, "TRAIN.GT_MIN_AREA", 50.0,
            "MODEL.MASK_ON", True, "MRCNN.RESOLUTION", 8]
    got_ds, want_ds = _datasets(sets, "easy")
    want_b = jpipe.ClipBatcher(want_ds, jax_load_cfg(opts=opts), train=train,
                               seed=5)
    got_b = tpipe.ClipBatcher(got_ds, load_cfg(opts=opts), train=train,
                              seed=5)
    assert got_b.windows == want_b.windows
    assert got_b.specs() == [tpipe.ClipSpec(**dataclasses.asdict(s))
                             for s in want_b.specs()]
    for epoch in range(2):
        want = list(want_b.epoch(3, num_workers=workers))
        got = list(got_b.epoch(3, num_workers=workers))
        assert len(got) == len(want) > 0
        _assert_same(got, want)


def test_masks():
    rng = np.random.default_rng(4)
    probs = rng.uniform(0, 1, (6, 14, 14)).astype(np.float32)
    boxes = np.array([[3.2, 4.9, 40.1, 30.7], [-10, -5, 20, 25],
                      [50, 20, 95, 63], [10, 10, 10.4, 10.2],
                      [0, 0, 96, 64], [70.5, 2.5, 120, 80]])
    for mask, box in zip(probs, boxes):
        for thresh in (0.5, 0.3):
            np.testing.assert_array_equal(
                tmasks.paste_mask(mask, box, 64, 96, thresh),
                jmasks.paste_mask(mask, box, 64, 96, thresh))
    polys = [[[5, 5, 30, 8, 25, 40, 4, 30]],
             [[50.4, 10.6, 90.2, 12, 70, 60], [0, 60, 10, 50, 12, 63.5]]]
    for segm in polys:
        np.testing.assert_array_equal(
            tmasks.rasterize_polygons(segm, 64, 96),
            jmasks.rasterize_polygons(segm, 64, 96))
    masks = [jmasks.paste_mask(m, b, 64, 96) for m, b in zip(probs, boxes)]
    gts = [jmasks.rasterize_polygons(s, 64, 96) for s in polys]
    np.testing.assert_array_equal(tmasks.mask_iou_matrix(masks, gts),
                                  jmasks.mask_iou_matrix(masks, gts))


def _passes(rng, n_pass=3, d=6, t=2, k=15, ties=True):
    out = []
    for _ in range(n_pass):
        xy = rng.uniform(0, 60, (d, t, 2))
        wh = rng.uniform(8, 30, (d, t, 2))
        scores = rng.uniform(0, 1, d)
        if ties:
            scores[1] = scores[0]          # near-duplicate ranks tie
            scores[4] = scores[3] = 0.5
        out.append({
            "boxes": np.concatenate([xy, xy + wh], -1).reshape(d, 4 * t),
            "scores": scores,
            "valid": rng.uniform(size=d) > 0.2,
            "keypoints": rng.uniform(0, 60, (d, t, k, 4)),
            "features": rng.normal(size=(d, 8)).astype(np.float32),
            "masks": rng.uniform(0, 1, (d, t, 6, 6)).astype(np.float32)})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment(seed):
    rng = np.random.default_rng(seed)
    passes = _passes(rng)
    for thresh, max_out in ((0.5, None), (0.3, 4), (0.7, 9)):
        _assert_same(taug.merge_multiscale_detections(passes, 2, thresh,
                                                      max_out),
                     jaug.merge_multiscale_detections(passes, 2, thresh,
                                                      max_out))
    _assert_same(taug.rescale_detections(passes[0], 1.7),
                 jaug.rescale_detections(passes[0], 1.7))
    np.testing.assert_array_equal(
        taug._unflip_boxes(passes[1]["boxes"], 96.0),
        jaug._unflip_boxes(passes[1]["boxes"], 96.0))
    for ds in ("posetrack", "coco"):
        k = 15 if ds == "posetrack" else 17
        kps = rng.uniform(0, 90, (5, 2, k, 3))
        np.testing.assert_array_equal(taug._unflip_keypoints(kps, 96.0, ds),
                                      jaug._unflip_keypoints(kps, 96.0, ds))
    clips = rng.normal(size=(2, 2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(taug.flip_clip(clips), jaug.flip_clip(clips))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nms_numpy(seed):
    rng = np.random.default_rng(seed)
    n = 40
    xy = rng.uniform(0, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], 1)
    boxes[5] = boxes[4]                          # exact duplicate
    scores = np.round(rng.uniform(0, 1, n), 1)   # many ties
    for thresh in (0.3, 0.5, 0.7):
        got = tnms.nms_numpy(boxes, scores, thresh)
        assert got == jnms.nms_numpy(boxes, scores, thresh)
        assert len(got) < n


def test_keypoint_helpers():
    rng = np.random.default_rng(6)
    np.testing.assert_array_equal(tkp.POSETRACK_OKS_SIGMAS,
                                  jkp.POSETRACK_OKS_SIGMAS)
    np.testing.assert_array_equal(tkp.COCO_OKS_SIGMAS, jkp.COCO_OKS_SIGMAS)
    for ds in ("posetrack", "coco"):
        assert tkp.get_keypoints(ds) == jkp.get_keypoints(ds)
        np.testing.assert_array_equal(tkp.flip_permutation(ds),
                                      jkp.flip_permutation(ds))
    kps = rng.uniform(0, 100, (7, 15, 3))
    np.testing.assert_array_equal(tkp.flip_keypoints(kps, 96.0),
                                  jkp.flip_keypoints(kps, 96.0))
    np.testing.assert_array_equal(tkp.scale_keypoints(kps, 0.37),
                                  jkp.scale_keypoints(kps, 0.37))
    gt = kps[:4].copy()
    gt[:, :, 2] = rng.integers(0, 3, (4, 15))
    gt[2, :, 2] = 0                              # no visible joint
    areas = rng.uniform(100, 3000, 4)
    pred = kps + rng.normal(0, 3, kps.shape)
    for sig in (jkp.POSETRACK_OKS_SIGMAS, jkp.POSETRACK_OKS_SIGMAS * 2):
        np.testing.assert_array_equal(tkp.compute_oks(pred, gt, areas, sig),
                                      jkp.compute_oks(pred, gt, areas, sig))
    dup = np.concatenate([pred, pred[:3] + 0.5])
    rois = np.concatenate([dup[:, :, :2].min(1), dup[:, :, :2].max(1)], 1)
    for thresh in (0.3, 0.9):
        got = tkp.nms_oks(dup, rois, thresh)
        assert got == jkp.nms_oks(dup, rois, thresh)


def test_window_proposals():
    class _DS:
        def video_frames(self, vid):
            return [None] * 4
    rng = np.random.default_rng(8)
    db = {"v": {i: rng.uniform(0, 50, (n, 4)) for i, n in
                enumerate((3, 5, 2, 4))}}
    for vid, start, t, stride, kp in (("v", 1, 3, 1, 5), ("v", 0, 2, 2, 2),
                                      ("v", 2, 4, 1, 6), ("nope", 0, 3, 1, 4)):
        _assert_same(tinf.window_proposals(db, _DS(), vid, start, t, stride,
                                           kp),
                     jinf.window_proposals(db, _DS(), vid, start, t, stride,
                                           kp))


def _detections(ds, rng, d=5, mask=0):
    """Seeded per-frame detections around the set's GT: jittered GT boxes
    and keypoints, distractors, random scores and validity."""
    dets = {}
    for vid in ds.videos():
        frames = []
        for fr in ds.video_frames(vid):
            gts = ds.gt_poses(fr)
            boxes = rng.uniform(0, 60, (d, 4))
            boxes[:, 2:] += boxes[:, :2] + 10
            kps = rng.uniform(0, 90, (d, 15, 3))
            for i, g in enumerate(gts[:d - 1]):
                boxes[i] = g["box"] + rng.normal(0, 2, 4)
                kps[i, :, :2] = g["keypoints"][:, :2] + rng.normal(
                    0, 2, (15, 2))
            out = {"boxes": boxes, "scores": rng.uniform(0, 1, d),
                   "valid": rng.uniform(size=d) > 0.1, "keypoints": kps,
                   "features": rng.normal(size=(d, 8)).astype(np.float32)}
            if mask:
                out["masks"] = rng.uniform(0, 1, (d, mask, mask)).astype(
                    np.float32)
            frames.append(out)
        dets[vid] = frames
    return dets


@pytest.mark.parametrize("name,mask_on", [("easy", False), ("hard", True),
                                          ("hard", False)])
def test_evaluate_detections(sets, name, mask_on):
    got_ds, want_ds = _datasets(sets, name)
    dets = _detections(want_ds, np.random.default_rng(9),
                       mask=14 if mask_on else 0)
    want = jeval.evaluate_detections(dets, want_ds, mask_on=mask_on)
    got = teval.evaluate_detections(dets, got_ds, mask_on=mask_on)
    _assert_same(got, want)
    assert ("mask_AP" in got) == mask_on and want["box_AP50"] > 0


def _gt(ds, pkg):
    return {vid: [[pkg.PoseAnnotation(keypoints=p["keypoints"], box=p["box"],
                                      head_box=p["head_box"],
                                      track_id=p["track_id"])
                   for p in ds.gt_poses(fr)] for fr in ds.video_frames(vid)]
            for vid in ds.videos()}


@pytest.mark.parametrize("name", ["easy", "hard"])
def test_tracking_engine_and_evaluate_tracking(sets, name, tmp_path):
    got_ds, want_ds = _datasets(sets, name)
    dets = _detections(want_ds, np.random.default_rng(10))
    cfg_j = jax_load_cfg(opts=["TRACKING.CONF_FILTER_INITIAL_DETS", 0.2])
    cfg_t = load_cfg(opts=["TRACKING.CONF_FILTER_INITIAL_DETS", 0.2])
    want = jeng.run_posetrack_tracking(dets, cfg=cfg_j)
    got = teng.run_posetrack_tracking(dets, cfg=cfg_t)
    _assert_same(got, want)
    assert any((f["track_ids"] >= 0).any() for v in got.values() for f in v)
    _assert_same(teng.evaluate_tracking(got, _gt(got_ds, teval)),
                 jeng.evaluate_tracking(want, _gt(want_ds, jeval)))

    paths_j = jeng.write_posetrack_results(want, str(tmp_path / "jax"))
    paths_t = teng.write_posetrack_results(got, str(tmp_path / "port"))
    assert [os.path.basename(p) for p in paths_t] == [
        os.path.basename(p) for p in paths_j]
    for pt, pj in zip(paths_t, paths_j):
        assert filecmp.cmp(pt, pj, shallow=False)
    back_t = teng.read_posetrack_results(str(tmp_path / "port"))
    _assert_same(back_t, jeng.read_posetrack_results(str(tmp_path / "jax")))
    _assert_same(teng.evaluate_tracking(back_t, _gt(got_ds, teval)),
                 jeng.evaluate_tracking(back_t, _gt(want_ds, jeval)))


def test_evaluator_joint_counts():
    """PosetrackEvaluator's per-frame bookkeeping on the same seeded frames:
    id switches, invisible GT joints, a joint with no GT at all, a GT
    without a head box, a frame without GT."""
    rng = np.random.default_rng(12)
    videos = []
    for video in range(2):
        frames = []
        for f in range(4):
            gts, preds = [], []
            for g in range(3):
                k = rng.uniform(0, 90, (15, 3))
                k[:, 2] = rng.uniform(size=15) > 0.3
                k[14, 2] = 0
                head = None if g == 2 else np.array([10, 0, 30, 20.0])
                gts.append((k, head, g))
                preds.append((k + rng.normal(0, 4, (15, 3)), (g + f) % 3,
                               float(rng.uniform())))
            frames.append(([] if f == 2 else gts, preds))
        videos.append(frames)
    summaries = []
    for pkg in (jeval, teval):
        ev = pkg.PosetrackEvaluator(15)
        for frames in videos:
            ev.start_video()
            for gts, preds in frames:
                ev.add_frame(
                    [pkg.PoseAnnotation(keypoints=k, box=np.array(
                        [0, 0, 60, 90.0]), head_box=h, track_id=tid)
                     for k, h, tid in gts],
                    [pkg.PoseAnnotation(keypoints=k, track_id=tid, score=sc)
                     for k, tid, sc in preds])
        summaries.append(ev.summarize())
    _assert_same(summaries[1], summaries[0])
    assert summaries[0]["id_switches"] > 0
    assert not summaries[0]["used_head_boxes"]


def test_small_utilities(tmp_path):
    obj = {"a": np.arange(5), "b": [1.5, "x"]}
    tio.save_object(obj, str(tmp_path / "sub" / "t.pkl"))
    jio.save_object(obj, str(tmp_path / "sub" / "j.pkl"))
    assert filecmp.cmp(tmp_path / "sub" / "t.pkl", tmp_path / "sub" / "j.pkl",
                       shallow=False)
    _assert_same(tio.load_object(str(tmp_path / "sub" / "j.pkl")),
                 jio.load_object(str(tmp_path / "sub" / "t.pkl")))
    timers = [ttimer.Timer(), jtimer.Timer()]
    for tm in timers:
        tm.tic()
        assert tm.toc(average=False) >= 0.0
        tm.tic()
        tm.toc()
        assert tm.calls == 2 and tm.average_time == tm.total_time / 2
    assert vars(ttimer.Timer()) == vars(jtimer.Timer())
    root = logging.getLogger()
    level = root.level
    try:
        assert tlog.setup_logging().name == "detectandtrack_tpu_torch"
        assert jlog.setup_logging().name == "detectandtrack_tpu"
        assert tlog.setup_logging("x", logging.WARNING) is logging.getLogger(
            "x")
        assert root.level == logging.WARNING
    finally:
        root.setLevel(level)


def test_training_stats(tmp_path, monkeypatch):
    """The same iterations, losses and clock through both `TrainingStats`:
    the same `get_stats`, the same `json_stats:` log lines and the same
    JSONL file, byte for byte."""
    rng = np.random.default_rng(0)
    losses = [{"loss_total": float(v), "loss_kps": float(v / 2)}
              for v in rng.uniform(0, 10, 45)]
    clock = np.cumsum(rng.uniform(0.1, 0.3, 200)).tolist()
    out = {}
    for name, mod in (("jax", jstats), ("port", tstats)):
        ticks = iter(clock)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda: next(ticks)))
        path = tmp_path / f"{name}.jsonl"
        stats = mod.TrainingStats(45, log_period=10, window_size=7,
                                  jsonl_path=str(path))
        lines = []
        monkeypatch.setattr(mod.logger, "info",
                            lambda fmt, line: lines.append(line))
        for i, vals in enumerate(losses):
            stats.iter_tic()
            stats.iter_toc()
            stats.update_iter_stats(vals, i, lr=0.01 * (i + 1))
        out[name] = (stats.get_stats(), lines)
        stats.close()
        sv = mod.SmoothedValue(4)
        for v in (3.0, 1.0, 2.0, 5.0, 4.0):
            sv.update(v)
        out[name] += ((sv.median, sv.average, list(sv.window)),)
    _assert_same(out["port"], out["jax"])
    assert len(out["jax"][1]) == 5
    assert filecmp.cmp(tmp_path / "jax.jsonl", tmp_path / "port.jsonl",
                       shallow=False)


_SHARD = "import pickle, sys; pickle.dump(list(range(int(sys.argv[1]), " \
    "int(sys.argv[2]))), open(sys.argv[3], 'wb'))"


def test_subprocess_utils(tmp_path):
    """Ranges, the fan-out's shard files and their merge, and a failing
    shard, through both copies."""
    for total in (0, 1, 5, 13):
        for n in (1, 2, 3, 7):
            _assert_same(tsub.split_ranges(total, n),
                         jsub.split_ranges(total, n))
    cmd = [sys.executable, "-c", _SHARD, "{start}", "{end}", "{out}"]
    paths = {}
    for name, mod in (("jax", jsub), ("port", tsub)):
        paths[name] = mod.process_in_parallel(
            "part", 10, cmd, str(tmp_path / name), num_workers=3)
        assert [os.path.basename(p) for p in paths[name]] == [
            "part_range_0_4.pkl", "part_range_4_7.pkl", "part_range_7_10.pkl"]
        with pytest.raises(RuntimeError, match="1 shard"):
            mod.process_in_parallel("bad", 2, [sys.executable, "-c",
                                               "import sys; sys.exit({start})"],
                                    str(tmp_path / name), num_workers=2)
    _assert_same(tsub.merge_shard_results(paths["jax"]),
                 jsub.merge_shard_results(paths["port"]))
    assert tsub.merge_shard_results(paths["port"]) == list(range(10))


def test_vis_draw_detections():
    """Boxes, scores, skeletons and track ids drawn by both copies onto
    the same frame give the same pixels; invalid rows are not drawn."""
    assert tvis._EDGE_IDX == jvis._EDGE_IDX
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (72, 104, 3), dtype=np.uint8)
    boxes = np.array([[5, 6, 40, 60], [30, 10, 90, 70], [1, 1, 3, 3]],
                     np.float32)
    kps = np.concatenate([rng.uniform(0, 100, (3, 15, 2)),
                          rng.uniform(-0.5, 1, (3, 15, 1))], -1)
    args = dict(scores=np.array([0.9, 0.4, 0.2], np.float32), keypoints=kps,
                track_ids=np.array([3, -1, 7]),
                valid=np.array([True, True, False]))
    got = tvis.draw_detections(image, boxes, **args)
    want = jvis.draw_detections(image, boxes, **args)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)
    np.testing.assert_array_equal(
        tvis.draw_detections(image, boxes[:2], kp_thresh=0.3,
                             keypoints=kps[:2, :, :2]),
        jvis.draw_detections(image, boxes[:2], kp_thresh=0.3,
                             keypoints=kps[:2, :, :2]))
