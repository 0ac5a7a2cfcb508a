"""The port's own copies of the JAX package's framework-free modules against
the originals, on the same inputs: the config tree (`core/config.py`), the
anchors (`ops/anchors.py`), the host tracker with its native solver
(`tracking/`, `csrc/hungarian.cpp`) and the synthetic proposal tubes
(`utils/synthetic.make_realistic_tubes`, a copy of
`bench.make_realistic_tubes`). All are exact."""

import dataclasses
import glob
import os

import numpy as np
import pytest

import bench
from detectandtrack_tpu.core import config as jconfig
from detectandtrack_tpu.ops import anchors as janchors
from detectandtrack_tpu.tracking import tracker as jtracker
from detectandtrack_tpu_torch.core import config as tconfig
from detectandtrack_tpu_torch.ops import anchors as tanchors
from detectandtrack_tpu_torch.tracking import native as tnative
from detectandtrack_tpu_torch.tracking import tracker as ttracker
from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes

CONFIGS = sorted(glob.glob("configs/video/*.yaml"))


@pytest.mark.parametrize("path", [None] + CONFIGS)
def test_load_cfg_gives_the_jax_tree(path):
    opts = ["RPN.POST_NMS_TOP_N_TEST", 77, "TEST.SHAPE_BUCKETS",
            "[[64, 96]]"]
    want = jconfig.load_cfg(path, opts=opts)
    got = tconfig.load_cfg(path, opts=opts)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__


def test_load_cfg_rejects_what_the_jax_loader_rejects():
    for opts in (["MODEL.NOT_A_KEY", 1], ["RPN.SIZES", "[1, 2]"]):
        with pytest.raises(Exception) as jerr:
            jconfig.load_cfg(opts=opts)
        with pytest.raises(type(jerr.value)) as terr:
            tconfig.load_cfg(opts=opts)
        assert str(terr.value) == str(jerr.value)


def _anchor_cases():
    cases = set()
    for path in CONFIGS:
        cfg = tconfig.load_cfg(path)
        ratios = tuple(cfg.RPN.ASPECT_RATIOS)
        if cfg.FPN.FPN_ON:
            lo, hi = cfg.FPN.RPN_MIN_LEVEL, cfg.FPN.RPN_MAX_LEVEL
            for i, lvl in enumerate(range(lo, hi + 1)):
                cases.add((2 ** lvl, (cfg.RPN.SIZES[i],), ratios))
        else:
            cases.add((cfg.RPN.STRIDE, tuple(cfg.RPN.SIZES), ratios))
    return sorted(cases)


@pytest.mark.parametrize("stride,sizes,ratios", _anchor_cases())
def test_anchors_equal_the_jax_module(stride, sizes, ratios):
    want = janchors.generate_anchors(stride, sizes, ratios)
    got = tanchors.generate_anchors(stride, sizes, ratios)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tanchors.shifted_anchor_field(got, stride, 5, 7),
        janchors.shifted_anchor_field(want, stride, 5, 7))


def _detections(rng, n_frames=6, n=9):
    """Seeded per-frame detections: drifting boxes, a few births and
    deaths, keypoints and features."""
    base = rng.uniform(0, 300, (n, 2))
    size = rng.uniform(20, 120, (n, 2))
    frames = []
    for f in range(n_frames):
        xy = base + rng.normal(0, 6.0, base.shape) + 3.0 * f
        boxes = np.concatenate([xy, xy + size], 1)
        frames.append(dict(
            boxes=boxes, scores=rng.uniform(0.2, 1.0, n),
            keypoints=np.concatenate([
                xy[:, None] + rng.uniform(0, 1, (n, 15, 2)) * size[:, None],
                np.ones((n, 15, 1))], -1),
            features=rng.normal(size=(n, 16)),
            valid=rng.uniform(size=n) > 0.15))
    return frames


@pytest.mark.parametrize("metric,algo,native", [
    ("bbox-iou", "hungarian", True), ("bbox-iou", "hungarian", False),
    ("bbox-iou", "greedy", True), ("pose-pckh", "hungarian", True),
    ("cnn-cosine", "hungarian", True)])
def test_tracker_gives_the_jax_track_ids(metric, algo, native):
    kw = dict(distance_metric=metric, algo=algo, score_thresh=0.3,
              use_native=native)
    want_tr = jtracker.Tracker(jtracker.TrackerConfig(**kw))
    got_tr = ttracker.Tracker(ttracker.TrackerConfig(**kw))
    linked = 0
    for fr in _detections(np.random.default_rng(11)):
        want = want_tr.update(**fr)
        got = got_tr.update(**fr)
        np.testing.assert_array_equal(got, want)
        linked += int((got >= 0).sum())
    assert linked > 0 and got_tr._next_id == want_tr._next_id


def test_native_solver_matches_scipy_and_raises_without_its_library(
        monkeypatch):
    rng = np.random.default_rng(12)
    cost = rng.uniform(0, 1, (7, 9))
    cost[2, :] = 1e6
    got = tnative.solve_assignment(cost, forbidden=1e5)
    want = tnative.solve_assignment(cost, forbidden=1e5, use_native=False)
    assert sorted(got) == sorted(want) and all(r != 2 for r, _ in got)
    np.testing.assert_allclose(
        tnative.iou_cost_native(cost[:3, :4] * 100, cost[3:6, :4] * 100 + 50),
        jtracker.bbox_iou_cost(cost[:3, :4] * 100, cost[3:6, :4] * 100 + 50))

    def no_compiler(names):
        raise RuntimeError("g++ not found")

    tnative._lib.cache_clear()
    monkeypatch.setattr(tnative._build, "_libs", {})
    monkeypatch.setattr(tnative._build, "build", no_compiler)
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            tnative.solve_assignment(cost)
    finally:
        tnative._lib.cache_clear()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_realistic_tubes_equals_bench(seed):
    args = (2, 37, 8, 800, 1344)
    want = bench.make_realistic_tubes(*args, seed=seed)
    got = make_realistic_tubes(*args, seed=seed)
    assert got.dtype == want.dtype and got.shape == (2, 37, 32)
    np.testing.assert_array_equal(got, want)
