"""The NMS loops of the port (`kernels/nms.py`: greedy NMS's keep sweep and
soft-NMS's confirmation rounds, the plain versions that the CPU runs and
the CUDA kernels are held to) against the JAX package's `nms_fixed`,
`soft_nms_fixed` and `soft_nms_scan` on the same seeded numpy inputs.

Greedy NMS: random boxes, a long suppression chain (each box suppresses
only the next: the JAX fixpoint's worst case, N rounds), score ties,
invalid rows and non-finite coordinates (NaN and ±inf: the IoU semantics
the CUDA kernel copies), at N in {1, 63, 65, 1000} (one 64-bit word,
either side of a word edge, the RPN's lane), two lanes batched; indices
and masks exact.
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
from detectandtrack_tpu_torch.utils.synthetic import (GREEDY_NMS_CASES,
                                                      SOFT_NMS_CASES,
                                                      greedy_nms_case,
                                                      soft_nms_case)

IOU = 0.5
SOFT_KW = dict(sigma=0.5, iou_thresh=0.3, score_thresh=0.05)


def _lanes(name, n, seed):
    rng = np.random.default_rng(seed)
    lanes = [greedy_nms_case(name, n, rng) for _ in range(2)]
    return [np.stack([lane[k] for lane in lanes]) for k in range(3)]


def _sorted_inputs(boxes, scores, valid):
    """`ops/nms.py::nms_fixed`'s sort → (order, sorted boxes,
    valid_sorted)."""
    scores = torch.where(valid, scores, torch.full_like(scores, -1e10))
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    return order, b, torch.gather(scores, -1, order) > -5e9


@pytest.mark.parametrize("n", [1, 63, 65, 1000])
@pytest.mark.parametrize("case", GREEDY_NMS_CASES)
def test_nms_keep_and_nms_fixed_match_jax(case, n):
    boxes, scores, valid = _lanes(case, n, 100 * n + GREEDY_NMS_CASES.index(case))
    tb, ts, tv = (torch.from_numpy(x) for x in (boxes, scores, valid))
    order, sorted_boxes, valid_sorted = _sorted_inputs(tb, ts, tv)
    kept = nms_keep_reference(sorted_boxes, valid_sorted, IOU)
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


def _kernel_iou_bits(a, b, thresh):
    """csrc/nms.cu's suppression bit for aligned box pairs, emulated in
    numpy f32 (one rounding an operation, as the kernel's _rn intrinsics):
    inter_union with fminf / fmaxf, the division-free decision
    (iou_above_sure) and the exact division where it is unsure. Also
    returns where the division-free decision was taken."""
    f32 = np.float32
    t = f32(thresh)

    def area(x):
        return ((x[:, 2] - x[:, 0]) + f32(1)) * ((x[:, 3] - x[:, 1]) + f32(1))

    with np.errstate(all="ignore"):
        iw = np.fmax((np.fmin(a[:, 2], b[:, 2]) - np.fmax(a[:, 0], b[:, 0]))
                     + f32(1), f32(0))
        ih = np.fmax((np.fmin(a[:, 3], b[:, 3]) - np.fmax(a[:, 1], b[:, 1]))
                     + f32(1), f32(0))
        inter = iw * ih
        uni = (area(a) + area(b)) - inter
        pos = uni > 0
        f = t * uni
        above = inter > f * f32(1 + 2.0 ** -20)
        below = inter < f * f32(1 - 2.0 ** -20)
        unsure = pos & ~((f >= f32(2.0 ** -100)) & (above | below))
        bit = np.where(pos, above, f32(0) > t)
        exact = np.where(pos, inter / uni, f32(0)) > t
    return np.where(unsure, exact, bit), pos & ~unsure


@pytest.mark.parametrize("thresh", [0.7, 0.5, 0.3, 1.0, 1e-30, 0.0, -0.5,
                                    1.5])
def test_mask_kernel_iou_rule_equals_bbox_overlaps(thresh):
    """The mask kernel's IoU test, emulated, against `bbox_overlaps` >
    thresh on pairs within 4 ulps of the threshold, random, tiny,
    degenerate and non-finite pairs; the division-free decision must agree
    with the division wherever it is taken."""
    rng = np.random.default_rng(5)
    from detectandtrack_tpu_torch.utils.synthetic import iou_threshold_pairs
    sets = []
    if 0 < thresh < 1:
        near = iou_threshold_pairs(rng, 20, 256, thresh).reshape(-1, 2, 4)
        sets.append((near[:, 0], near[:, 1]))
    for scale in (1e-3, 1.0, 200.0):
        xy = rng.uniform(0, 10 * scale, (4000, 2, 2))
        wh = rng.uniform(-0.5 * scale, 3 * scale, (4000, 2, 2))
        pairs = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        sets.append((pairs[:, 0], pairs[:, 1]))
    odd = rng.uniform(0, 50, (3000, 2, 4)).astype(np.float32)
    bad = rng.uniform(size=odd.shape) < 0.15
    odd[bad] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                          int(bad.sum()))
    sets.append((odd[:, 0], odd[:, 1]))
    decided_any = False
    for a, b in sets:
        got, decided = _kernel_iou_bits(a, b, thresh)
        ref = (bbox_overlaps(torch.from_numpy(a)[:, None],
                             torch.from_numpy(b)[:, None])[:, 0, 0]
               > thresh).numpy()
        np.testing.assert_array_equal(got, ref)
        decided_any |= bool(decided.any())
    assert decided_any == (thresh > 0)
