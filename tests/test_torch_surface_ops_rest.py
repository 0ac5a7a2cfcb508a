"""The rest of the JAX package's public ops in the port, against their JAX
twins at the JAX tests' own cases (tests/test_ops_nms.py,
tests/test_ops_boxes.py, tests/test_ops_keypoints.py): class-aware NMS,
the sequential soft-NMS and the fixpoint held to it, pairwise IoU, the box
and heatmap flips, the heatmap decode's numpy oracle and `cache_url`.

Tolerances: indices, masks, flips, the copied numpy oracle and `cache_url`
exact; IoU and soft-NMS scores 1e-6. Where the port batches over leading
dims, the lanes go through one call and JAX runs lane by lane."""

import hashlib
import os

import numpy as np
import pytest
import torch

from detectandtrack_tpu.ops import boxes as jboxes
from detectandtrack_tpu.ops import keypoints as jkps
from detectandtrack_tpu.ops import nms as jnms
from detectandtrack_tpu.utils import io as jio
from detectandtrack_tpu_torch.engine import augment as taugment
from detectandtrack_tpu_torch.ops import boxes as tboxes
from detectandtrack_tpu_torch.ops import keypoints as tkps
from detectandtrack_tpu_torch.ops import nms as tnms
from detectandtrack_tpu_torch.utils import io as tio
from detectandtrack_tpu_torch.utils.synthetic import (SOFT_NMS_CASES,
                                                      soft_nms_case)
from test_ops_boxes import _rand_boxes
from test_ops_nms import _rand

SOFT_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- class-aware NMS (tests/test_ops_nms.py:59) ----------------------------

@pytest.mark.parametrize("classes", [[0, 0], [0, 1]])
def test_batched_nms_classes_dont_suppress(classes):
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    ids = np.array(classes)
    want = jnms.batched_nms_fixed(boxes, scores, ids, 0.5, 2)
    got = tnms.batched_nms_fixed(_t(boxes), _t(scores), _t(ids), 0.5, 2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1].sum()) == (1 if classes == [0, 0] else 2)


def test_batched_nms_lanes_match_jax():
    """Three lanes of random boxes in 3 classes, some invalid and one
    non-finite coordinate per lane (the offset ignores it), in one call."""
    rng = np.random.default_rng(5)
    lanes = []
    for _ in range(3):
        boxes, scores = _rand(rng, 40)
        boxes[7, 2] = np.inf
        lanes.append((boxes, scores, rng.integers(0, 3, 40),
                      rng.uniform(size=40) > 0.2))
    got = tnms.batched_nms_fixed(*(_t(np.stack([l[i] for l in lanes]))
                                   for i in range(3)), 0.5, 24,
                                 valid=_t(np.stack([l[3] for l in lanes])))
    for li, (boxes, scores, ids, valid) in enumerate(lanes):
        idx, mask = jnms.batched_nms_fixed(boxes, scores, ids, 0.5, 24,
                                           valid=valid)
        np.testing.assert_array_equal(got[1][li].numpy(), np.asarray(mask))
        np.testing.assert_array_equal(got[0][li].numpy(), np.asarray(idx))


# -- the sequential soft-NMS and the fixpoint (tests/test_ops_nms.py:95-128)

def _soft_cases():
    """(name, boxes, scores, max_out, kwargs) of the JAX tests' cases."""
    cases = []
    rng = np.random.default_rng(7)
    for trial in range(4):
        boxes, scores = _rand(rng, 60)
        for method in ("linear", "gaussian"):
            cases.append((f"random{trial}-{method}", boxes, scores, 60,
                          dict(method=method)))
    n = 48
    x1 = np.arange(n, dtype=np.float32) * 6.0
    chain = np.stack([x1, np.zeros(n, np.float32), x1 + 9.0,
                      np.full(n, 9.0, np.float32)], axis=1)
    for method in ("linear", "gaussian"):
        cases.append((f"chain-{method}", chain,
                      np.linspace(1.0, 0.5, n).astype(np.float32), n,
                      dict(method=method)))
    rng = np.random.default_rng(9)
    boxes, scores = _rand(rng, 30)
    valid = rng.uniform(size=30) > 0.3
    cases += [("budget", boxes, scores, 8, dict(valid=valid)),
              ("pad", boxes, scores, 45, dict(valid=valid)),
              ("thresh", boxes, scores, 30, dict(score_thresh=0.5))]
    return cases


SOFT_CASES = _soft_cases()


def _port_kw(kw):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("case", SOFT_CASES, ids=[c[0] for c in SOFT_CASES])
def test_soft_nms_scan_matches_jax(case):
    """The port's scan against JAX's scan, and the port's fixpoint
    against the port's scan: indices and masks exact, scores 1e-6."""
    _, boxes, scores, max_out, kw = case
    want = jnms.soft_nms_scan(boxes, scores, max_out, **kw)
    scan = tnms.soft_nms_scan(_t(boxes), _t(scores), max_out, **_port_kw(kw))
    fixed = tnms.soft_nms_fixed(_t(boxes), _t(scores), max_out,
                                **_port_kw(kw))
    assert scan[0].shape == (max_out,) and scan[0].dtype == torch.int64
    assert scan[1].any()
    for got in (scan, fixed):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   **SOFT_TOL)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_scan_lanes_match_jax(method):
    """Three lanes with invalid rows through one call of the port's scan,
    against JAX's scan lane by lane."""
    rng = np.random.default_rng(13)
    lanes = [_rand(rng, 30) + (rng.uniform(size=30) > 0.3,)
             for _ in range(3)]
    got = tnms.soft_nms_scan(*(_t(np.stack([l[i] for l in lanes]))
                               for i in range(2)), 20, method=method,
                             valid=_t(np.stack([l[2] for l in lanes])))
    for li, (boxes, scores, valid) in enumerate(lanes):
        idx, mask, sc = jnms.soft_nms_scan(boxes, scores, 20, method=method,
                                           valid=valid)
        np.testing.assert_array_equal(got[1][li].numpy(), np.asarray(mask))
        np.testing.assert_array_equal(got[0][li].numpy(), np.asarray(idx))
        np.testing.assert_allclose(got[2][li].numpy(), np.asarray(sc),
                                   **SOFT_TOL)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
@pytest.mark.parametrize("case", SOFT_NMS_CASES)
@pytest.mark.parametrize("max_out", [8, 52])
def test_soft_nms_fixed_matches_the_ports_scan(method, case, max_out):
    """The port's fixpoint against the port's own sequential oracle, on
    tests/test_torch_surface_ops.py's three-lane cases (the cases
    chip_smoke.py's [surface-ops] runs on the card)."""
    rng = np.random.default_rng(11)
    lanes = [soft_nms_case(case, rng) for _ in range(3)]
    args = [_t(np.stack([l[i] for l in lanes])) for i in range(3)]
    kw = dict(sigma=0.5, iou_thresh=0.3, score_thresh=0.05, method=method,
              valid=args[2])
    fixed = tnms.soft_nms_fixed(args[0], args[1], max_out, **kw)
    scan = tnms.soft_nms_scan(args[0], args[1], max_out, **kw)
    torch.testing.assert_close(fixed[1], scan[1], rtol=0, atol=0)
    torch.testing.assert_close(fixed[0], scan[0], rtol=0, atol=0)
    torch.testing.assert_close(fixed[2], scan[2], **SOFT_TOL)


# -- boxes (tests/test_ops_boxes.py:57, :67) --------------------------------

def test_clip_and_flip_match_jax():
    b = np.array([[-10.0, -5.0, 500.0, 300.0]], np.float32)
    c = tboxes.clip_boxes(_t(b), 200, 300)
    assert c.tolist() == [[0.0, 0.0, 299.0, 199.0]]
    f = tboxes.flip_boxes(c, 300)
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(jboxes.flip_boxes(c.numpy(), 300)))
    torch.testing.assert_close(tboxes.flip_boxes(f, 300), c, rtol=0, atol=0)


def test_flip_boxes_matches_jax_and_unflip():
    """Batched random boxes: equal to JAX's flip and to the flip TTA's
    host statement of the convention (`augment._unflip_boxes`)."""
    rng = np.random.default_rng(4)
    b = np.stack([_rand_boxes(rng, 12) for _ in range(3)])
    got = tboxes.flip_boxes(_t(b), 321.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jboxes.flip_boxes(b,
                                                                    321.0)))
    np.testing.assert_array_equal(got, taugment._unflip_boxes(b, 321.0))


def test_pairwise_iou_matches_jax_and_matrix_diag():
    rng = np.random.default_rng(3)
    a = _rand_boxes(rng, 12)
    got = tboxes.bbox_iou_pairwise(_t(a), _t(a)).numpy()
    np.testing.assert_allclose(got, np.diag(tboxes.bbox_overlaps(
        _t(a), _t(a)).numpy()), atol=1e-6)
    b = np.stack([_rand_boxes(rng, 12) for _ in range(2)])
    c = np.stack([_rand_boxes(rng, 12) for _ in range(2)])
    got = tboxes.bbox_iou_pairwise(_t(b), _t(c)).numpy()
    assert got.shape == (2, 12) and (got > 0).any()
    np.testing.assert_allclose(got, np.asarray(jboxes.bbox_iou_pairwise(
        b, c)), **SOFT_TOL)


# -- keypoints (tests/test_ops_keypoints.py:32, :53) ------------------------

def test_heatmap_decode_oracle_is_the_jax_oracle():
    rng = np.random.default_rng(1)
    hm = rng.normal(size=(3, 15, 56, 56)).astype(np.float32)
    rois = np.array([[10, 20, 110, 220], [0, 0, 56, 56], [5, 5, 6, 6]],
                    np.float32)
    ora = tkps.heatmaps_to_keypoints_numpy(hm, rois)
    np.testing.assert_array_equal(ora,
                                  jkps.heatmaps_to_keypoints_numpy(hm, rois))
    dev = tkps.heatmaps_to_keypoints(_t(hm), _t(rois)).numpy()
    np.testing.assert_allclose(dev, ora, atol=1e-4)


@pytest.mark.parametrize("dataset", ["posetrack", "coco"])
def test_flip_heatmaps_matches_jax_and_unflip(dataset):
    """Equal to JAX's flip; each joint's argmax bin of the flipped maps,
    unflipped by the flip TTA's `augment._unflip_keypoints`, is the
    original's argmax bin; and the decode mirrors as in the JAX test."""
    k = len(tkps.get_keypoints(dataset)[0])
    rng = np.random.default_rng(2)
    hm = rng.normal(size=(2, k, 56, 48)).astype(np.float32)
    flipped = tkps.flip_heatmaps(_t(hm), dataset).numpy()
    np.testing.assert_array_equal(flipped,
                                  np.asarray(jkps.flip_heatmaps(hm, dataset)))

    def bins(h):
        idx = h.reshape(h.shape[:-2] + (-1,)).argmax(-1)
        py, px = np.divmod(idx, h.shape[-1])
        return np.stack([px, py, np.ones_like(px)], -1).astype(np.float64)

    np.testing.assert_array_equal(
        taugment._unflip_keypoints(bins(flipped), hm.shape[-1], dataset),
        bins(hm))
    rois = np.array([[0, 0, 48, 56]] * 2, np.float32)
    a = tkps.heatmaps_to_keypoints(_t(hm), _t(rois)).numpy()
    b = tkps.heatmaps_to_keypoints(_t(flipped), _t(rois)).numpy()
    perm = tkps.flip_permutation(dataset)
    np.testing.assert_allclose(b[:, perm, 0], 48.0 - a[..., 0], atol=0.51)


# -- cache_url (copied) -----------------------------------------------------

def test_cache_url_equals_the_original(tmp_path):
    """A local path passes through; a URL resolves to the cached file when
    it is there and raises the same error when it is not. No download."""
    cache = str(tmp_path / "cache")
    local = str(tmp_path / "w.pkl")
    assert tio.cache_url(local, cache) == jio.cache_url(local, cache) == local
    url = "https://example.invalid/models/model_final.pkl"
    with pytest.raises(FileNotFoundError) as terr:
        tio.cache_url(url, cache)
    with pytest.raises(FileNotFoundError) as jerr:
        jio.cache_url(url, cache)
    assert str(terr.value) == str(jerr.value)
    os.makedirs(cache)
    hit = os.path.join(cache, hashlib.sha256(url.encode()).hexdigest()[:16]
                       + "_model_final.pkl")
    open(hit, "wb").close()
    assert tio.cache_url(url, cache) == jio.cache_url(url, cache) == hit
