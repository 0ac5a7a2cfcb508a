"""The NMS loops of the port (`kernels/nms.py`: greedy NMS's keep sweep and
soft-NMS's confirmation rounds, the plain versions that the CPU runs and
the CUDA kernels are held to) against the JAX package's `nms_fixed`,
`soft_nms_fixed` and `soft_nms_scan` on the same seeded numpy inputs.

Greedy NMS: random boxes, a long suppression chain (each box suppresses
only the next: the JAX fixpoint's worst case, N rounds), score ties and
invalid rows, at N in {1, 63, 65, 1000} (one 64-bit word, either side of a
word edge, the RPN's lane), two lanes batched; indices and masks exact.
Soft-NMS: the soft-NMS cases of `utils/synthetic.py`, linear and gaussian
decay; indices and masks exact, scores within 1e-6 (the tolerance of
tests/test_torch_surface_ops.py)."""

import numpy as np
import pytest
import torch

from detectandtrack_tpu.ops import nms as jnms
from detectandtrack_tpu_torch.kernels.nms import (nms_keep_reference,
                                                  soft_nms_confirm_reference)
from detectandtrack_tpu_torch.ops import nms as tnms
from detectandtrack_tpu_torch.ops.boxes import bbox_overlaps
from detectandtrack_tpu_torch.utils.synthetic import (SOFT_NMS_CASES,
                                                      soft_nms_case)

IOU = 0.5
GREEDY_CASES = ("random", "chain", "ties", "invalid")
SOFT_KW = dict(sigma=0.5, iou_thresh=0.3, score_thresh=0.05)


def greedy_case(name, n, rng):
    """One lane (boxes (n, 4), scores (n,), valid (n,)). "chain": boxes
    12 px wide, 3 px apart, in score order: IoU 0.6 with the next box,
    1/3 with the one after, so the greedy keeps every other box."""
    x1, y1 = rng.uniform(0, 200, n), rng.uniform(0, 200, n)
    w, h = rng.uniform(8, 60, n), rng.uniform(8, 60, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    if name == "chain":
        x1 = np.arange(n, dtype=np.float32) * 3.0
        boxes = np.stack([x1, np.zeros(n, np.float32), x1 + 11.0,
                          np.full(n, 11.0, np.float32)], 1)
        scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    elif name == "ties":
        scores = np.round(scores * 4) / 4
        boxes[n // 4:n // 2] = boxes[0]
    elif name == "invalid":
        valid = rng.uniform(size=n) > 0.4
    return boxes, scores, valid


def _lanes(name, n, seed):
    rng = np.random.default_rng(seed)
    lanes = [greedy_case(name, n, rng) for _ in range(2)]
    return [np.stack([lane[k] for lane in lanes]) for k in range(3)]


def _sorted_inputs(boxes, scores, valid):
    """`ops/nms.py::nms_fixed`'s sort and suppression matrix →
    (order, supp, valid_sorted)."""
    n = boxes.shape[-2]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e10))
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    rank = torch.arange(n)
    supp = (bbox_overlaps(b, b) > IOU) & (rank[:, None] < rank[None, :])
    return order, supp, torch.gather(scores, -1, order) > -5e9


@pytest.mark.parametrize("n", [1, 63, 65, 1000])
@pytest.mark.parametrize("case", GREEDY_CASES)
def test_nms_keep_and_nms_fixed_match_jax(case, n):
    boxes, scores, valid = _lanes(case, n, 100 * n + GREEDY_CASES.index(case))
    tb, ts, tv = (torch.from_numpy(x) for x in (boxes, scores, valid))
    order, supp, valid_sorted = _sorted_inputs(tb, ts, tv)
    kept = nms_keep_reference(supp, valid_sorted)
    budget = n // 2 + 1
    got_idx, got_mask = tnms.nms_fixed(tb, ts, IOU, budget, tv)
    for li in range(2):
        idx, mask = jnms.nms_fixed(boxes[li], scores[li], IOU, n,
                                   valid=valid[li])
        idx, mask = np.asarray(idx), np.asarray(mask)
        np.testing.assert_array_equal(order[li][kept[li]].numpy(),
                                      idx[mask])
        if case == "chain":
            np.testing.assert_array_equal(idx[mask], np.arange(0, n, 2))
        idx, mask = jnms.nms_fixed(boxes[li], scores[li], IOU, budget,
                                   valid=valid[li])
        np.testing.assert_array_equal(got_mask[li].numpy(), np.asarray(mask))
        np.testing.assert_array_equal(got_idx[li].numpy(), np.asarray(idx))


def _soft_inputs(boxes, scores, valid, method):
    """`ops/nms.py::soft_nms_fixed`'s inputs to the confirmation loop."""
    n = boxes.shape[-2]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e10))
    iou = bbox_overlaps(boxes, boxes)
    if method == "linear":
        dmat = torch.where(iou > SOFT_KW["iou_thresh"], 1.0 - iou,
                           torch.ones_like(iou))
    else:
        dmat = torch.exp(-(iou * iou) / SOFT_KW["sigma"])
    overlaps = (dmat < 1.0) & ~torch.eye(n, dtype=torch.bool)
    return scores, dmat, overlaps, scores > -5e9


@pytest.mark.parametrize("method", ["linear", "gaussian"])
@pytest.mark.parametrize("case", SOFT_NMS_CASES)
def test_soft_nms_confirm_and_soft_nms_fixed_match_jax(method, case):
    rng = np.random.default_rng(7 + SOFT_NMS_CASES.index(case))
    lanes = [soft_nms_case(case, rng) for _ in range(2)]
    boxes, scores, valid = (np.stack([lane[k] for lane in lanes])
                            for k in range(3))
    n = boxes.shape[1]
    tb, ts, tv = (torch.from_numpy(x) for x in (boxes, scores, valid))
    final = soft_nms_confirm_reference(*_soft_inputs(tb, ts, tv, method),
                                       -1e10)
    got = tnms.soft_nms_fixed(tb, ts, n, valid=tv, method=method, **SOFT_KW)
    for li in range(2):
        for oracle in (jnms.soft_nms_fixed, jnms.soft_nms_scan):
            idx, mask, sc = (np.asarray(x) for x in oracle(
                boxes[li], scores[li], n, valid=valid[li], method=method,
                **SOFT_KW))
            np.testing.assert_array_equal(got[1][li].numpy(), mask)
            np.testing.assert_array_equal(got[0][li].numpy(), idx)
            np.testing.assert_allclose(got[2][li].numpy(), sc, rtol=1e-6,
                                       atol=1e-6)
            picks = torch.argsort(-final[li], stable=True)
            above = final[li][picks] > SOFT_KW["score_thresh"]
            np.testing.assert_array_equal(picks[above].numpy(), idx[mask])
            np.testing.assert_allclose(final[li][picks][above].numpy(),
                                       sc[mask], rtol=1e-6, atol=1e-6)
