"""The port's box, NMS, keypoint-decode, level-assignment and proposal ops
against their JAX twins on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.kernels import roi_align as jra
from detectandtrack_tpu.models import rpn as jrpn
from detectandtrack_tpu.ops import boxes as jbox
from detectandtrack_tpu.ops import keypoints as jkps
from detectandtrack_tpu.ops import nms as jnms
from detectandtrack_tpu_torch.kernels import roi_align as tra
from detectandtrack_tpu_torch.models import rpn as trpn
from detectandtrack_tpu_torch.ops import boxes as tbox
from detectandtrack_tpu_torch.ops import keypoints as tkps
from detectandtrack_tpu_torch.ops import nms as tnms


def _boxes(rng, n, lo=-20.0, hi=120.0):
    x1 = rng.uniform(lo, hi, n)
    y1 = rng.uniform(lo, hi, n)
    w = rng.uniform(-2.0, 60.0, n)          # includes inverted boxes
    h = rng.uniform(-2.0, 60.0, n)
    return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


def test_bbox_transform_and_clip_match_jax():
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 64)
    deltas = rng.normal(scale=2.0, size=(64, 12)).astype(np.float32)
    deltas[:4, 2] = 50.0                    # hits BBOX_XFORM_CLIP
    w = (10.0, 10.0, 5.0, 5.0)
    tiled = np.tile(boxes, (1, 3))
    want = np.asarray(jbox.bbox_transform(tiled.reshape(-1, 4),
                                          deltas.reshape(-1, 4), w))
    got = tbox.bbox_transform(torch.from_numpy(tiled.reshape(-1, 4)),
                              torch.from_numpy(deltas.reshape(-1, 4)), w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    want = np.asarray(jbox.clip_boxes(want.reshape(64, 12), 90.0, 110.0))
    got = tbox.clip_boxes(got.reshape(64, 12), 90.0, 110.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_overlaps_area_and_small_filter_match_jax():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 30), _boxes(rng, 20)
    np.testing.assert_allclose(
        tbox.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbox.bbox_overlaps(a, b)), atol=1e-6)
    np.testing.assert_allclose(tbox.boxes_area(torch.from_numpy(a)).numpy(),
                               np.asarray(jbox.boxes_area(a)), rtol=1e-6)
    np.testing.assert_array_equal(
        tbox.filter_small_boxes(torch.from_numpy(a), 8.0).numpy(),
        np.asarray(jbox.filter_small_boxes(a, 8.0)))


def _nms_case(name, rng):
    boxes = _boxes(rng, 48, 0.0, 80.0)
    scores = rng.uniform(0, 1, 48).astype(np.float32)
    valid = np.ones(48, bool)
    if name == "ties":
        scores = np.round(scores * 4) / 4          # many equal scores
        boxes[10:20] = boxes[0]                    # identical boxes too
    elif name == "invalid":
        valid = rng.uniform(size=48) > 0.4
    elif name == "all_invalid":
        valid[:] = False
    return boxes, scores, valid


@pytest.mark.parametrize("case", ["random", "ties", "invalid",
                                  "all_invalid"])
@pytest.mark.parametrize("max_out", [5, 64])
def test_nms_fixed_matches_jax(case, max_out):
    rng = np.random.default_rng(2)
    lanes = [_nms_case(case, rng) for _ in range(3)]
    got_idx, got_mask = tnms.nms_fixed(
        torch.from_numpy(np.stack([l[0] for l in lanes])),
        torch.from_numpy(np.stack([l[1] for l in lanes])), 0.5, max_out,
        torch.from_numpy(np.stack([l[2] for l in lanes])))
    for li, (boxes, scores, valid) in enumerate(lanes):
        idx, mask = jnms.nms_fixed(boxes, scores, 0.5, max_out, valid)
        np.testing.assert_array_equal(got_mask[li].numpy(), np.asarray(mask))
        np.testing.assert_array_equal(got_idx[li].numpy(), np.asarray(idx))


def test_heatmaps_to_keypoints_matches_jax():
    rng = np.random.default_rng(3)
    hm = rng.normal(size=(6, 15, 28, 28)).astype(np.float32)
    hm[0, 0] = 0.0                               # flat map: first argmax
    hm[1, :, 0, 0] = 9.0                         # peak on the border
    rois = _boxes(rng, 6, 0.0, 200.0)
    want = np.asarray(jkps.heatmaps_to_keypoints(hm, rois))
    got = tkps.heatmaps_to_keypoints(torch.from_numpy(hm),
                                     torch.from_numpy(rois))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_assign_fpn_levels_matches_jax():
    rng = np.random.default_rng(4)
    rois = _boxes(rng, 200, -50.0, 900.0) * np.float32(3.0)
    rois[:5] = [[0, 0, 0, 0], [10, 10, 9, 9], [0, 0, 1e4, 1e4],
                [0, 0, 223, 223], [0, 0, 111, 111]]
    want = np.asarray(jra.assign_fpn_levels(rois, 2, 5, 224, 4))
    got = tra.assign_fpn_levels(torch.from_numpy(rois), 2, 5, 224, 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_stable_breaks_ties_like_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf, 2.0]], np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(x), 5)
    tv, ti = trpn.topk_stable(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vals))


def test_decode_and_collect_proposals_match_jax():
    rng = np.random.default_rng(5)
    t, n = 3, 40
    anchors = _boxes(rng, n, 0.0, 60.0)
    deltas = rng.normal(scale=0.5, size=(n, 4 * t)).astype(np.float32)
    want = np.asarray(jrpn.decode_tube_proposals(anchors, deltas, (64.0, 96.0),
                                                 t))
    got = trpn.decode_tube_proposals(torch.from_numpy(anchors),
                                     torch.from_numpy(deltas), (64.0, 96.0), t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)

    levels = []
    for _ in range(3):
        tubes = rng.uniform(0, 90, (12, 4 * t)).astype(np.float32)
        scores = np.round(rng.normal(size=12), 1).astype(np.float32)
        valid = rng.uniform(size=12) > 0.3
        levels.append((tubes, scores, valid))
    jt, js, jv = jrpn.collect_fpn_proposals(levels, max_out=20)
    tt, ts, tv = trpn.collect_fpn_proposals(
        [torch.from_numpy(l[0])[None] for l in levels],
        [torch.from_numpy(l[1])[None] for l in levels],
        [torch.from_numpy(l[2])[None] for l in levels], 20)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
