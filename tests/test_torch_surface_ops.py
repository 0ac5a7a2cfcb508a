"""The model-surface ops of the port against their JAX twins on the same
seeded numpy inputs: the joints' flip permutation, soft-NMS, the final
detection stage with soft-NMS and box voting, mask targets and loss, the
mask head (its 2x2/s2 `conv5_mask` deconv through the weight bridge) and
the res5 box head, forward and backward.

Tolerances: indices and masks exact; soft-NMS scores 1e-6; boxes 1e-4;
mask head logits and res5 head outputs 1e-4; res5 head gradients as in
tests/test_torch_train_step.py (rtol 1e-3, atol 1e-5 or 1% of the leaf's
largest entry: against an f64 JAX gradient, the f32 input gradient of the
dilated head is off by 2.5e-3 of its largest entry in torch and 1.1e-3 in
jitted JAX, from cancellation in the conv backward); mask loss 1e-5."""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from detectandtrack_tpu.engine import losses as jlosses
from detectandtrack_tpu.engine import targets as jtargets
from detectandtrack_tpu.models import heads as jheads
from detectandtrack_tpu.models.detector import GeneralizedRCNN
from detectandtrack_tpu.ops import keypoints as jkps
from detectandtrack_tpu.ops import nms as jnms
from detectandtrack_tpu_torch.engine import losses as tlosses
from detectandtrack_tpu_torch.engine import targets as ttargets
from detectandtrack_tpu_torch.models import heads as theads
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.ops import keypoints as tkps
from detectandtrack_tpu_torch.ops import nms as tnms
from detectandtrack_tpu_torch.utils.params import (_to_port,
                                                   jax_params_to_state_dict,
                                                   state_dict_to_jax_params)
from detectandtrack_tpu_torch.utils.synthetic import (SOFT_NMS_CASES,
                                                      soft_nms_case)
from test_torch_slice import both_cfgs
from test_torch_slice import _random_params


@pytest.mark.parametrize("dataset", ["posetrack", "coco"])
def test_flip_permutation_matches_jax_table(dataset):
    np.testing.assert_array_equal(tkps.flip_permutation(dataset),
                                  jkps.flip_permutation(dataset))


@pytest.mark.parametrize("method", ["linear", "gaussian"])
@pytest.mark.parametrize("case", SOFT_NMS_CASES)
@pytest.mark.parametrize("max_out", [8, 52])
def test_soft_nms_fixed_matches_jax(method, case, max_out):
    """Three lanes batched in one call against JAX's fixpoint and its
    sequential scan, lane by lane; max_out 52 > N pads."""
    rng = np.random.default_rng(11)
    lanes = [soft_nms_case(case, rng) for _ in range(3)]
    kw = dict(sigma=0.5, iou_thresh=0.3, score_thresh=0.05, method=method)
    got = tnms.soft_nms_fixed(
        torch.from_numpy(np.stack([l[0] for l in lanes])),
        torch.from_numpy(np.stack([l[1] for l in lanes])), max_out,
        valid=torch.from_numpy(np.stack([l[2] for l in lanes])), **kw)
    snapshot = [x.clone() for x in got]
    assert got[0].shape == (3, max_out) and got[0].dtype == torch.int64
    for li, (boxes, scores, valid) in enumerate(lanes):
        for oracle in (jnms.soft_nms_fixed, jnms.soft_nms_scan):
            idx, mask, sc = oracle(boxes, scores, max_out, valid=valid, **kw)
            np.testing.assert_array_equal(got[1][li].numpy(),
                                          np.asarray(mask))
            np.testing.assert_array_equal(got[0][li].numpy(),
                                          np.asarray(idx))
            try:
                np.testing.assert_allclose(got[2][li].numpy(),
                                           np.asarray(sc), rtol=1e-6,
                                           atol=1e-6)
            except AssertionError as err:
                raise AssertionError(f"{err}\n" + _soft_report(
                    got, snapshot, lanes, li, np.asarray(sc), max_out,
                    kw)) from err


def _soft_report(got, snapshot, lanes, li, want, max_out, kw):
    """What a score mismatch of `test_soft_nms_fixed_matches_jax` needs to
    name its cause: whether the port's output changed after the call,
    whether the port recomputes the same on the batch and on the lane
    alone, the process's torch state, and for each mismatched slot the
    box, its IoU and decay rows in the port and in JAX."""
    from detectandtrack_tpu.ops.boxes import bbox_overlaps as jax_overlaps
    from detectandtrack_tpu_torch.ops.boxes import bbox_overlaps

    boxes, scores, valid = lanes[li]
    batch = tnms.soft_nms_fixed(
        torch.from_numpy(np.stack([l[0] for l in lanes])),
        torch.from_numpy(np.stack([l[1] for l in lanes])), max_out,
        valid=torch.from_numpy(np.stack([l[2] for l in lanes])), **kw)
    alone = tnms.soft_nms_fixed(torch.from_numpy(boxes),
                                torch.from_numpy(scores), max_out,
                                valid=torch.from_numpy(valid), **kw)
    iou = bbox_overlaps(torch.from_numpy(boxes),
                        torch.from_numpy(boxes)).numpy()
    jiou = np.asarray(jax_overlaps(boxes, boxes))
    lines = [
        "soft-NMS mismatch report:",
        f"  output changed after the call: "
        f"{not all(torch.equal(a, b) for a, b in zip(got, snapshot))}",
        f"  batch recomputed now: {batch[2][li].numpy().tolist()}",
        f"  lane alone now:       {alone[2].numpy().tolist()}",
        f"  torch {torch.__version__}, threads {torch.get_num_threads()}, "
        f"cpu capability {torch.backends.cpu.get_cpu_capability()}",
        f"  lane {li} boxes {boxes.tolist()}",
        f"  scores {scores.tolist()}, valid {valid.tolist()}"]
    bad = np.flatnonzero(~np.isclose(got[2][li].numpy(), want, rtol=1e-6,
                                     atol=1e-6))
    for slot in bad:
        i = int(got[0][li, slot])
        row = iou[i]
        if kw["method"] == "linear":
            decay = np.where(row > kw["iou_thresh"], 1.0 - row, 1.0)
        else:
            decay = np.exp(-(row * row) / kw["sigma"])
        lines += [f"  slot {slot}: box {i}, got {got[2][li, slot].item()!r}"
                  f", want {want[slot]!r}",
                  f"    IoU row (port) {row.tolist()}",
                  f"    IoU row (JAX)  {jiou[i].tolist()}",
                  f"    decay row {decay.tolist()}"]
    return "\n".join(lines)


FINAL_OPTS = {
    "hard+vote": ["TEST.SOFT_NMS_ENABLED", False],
    "linear+vote": ["TEST.SOFT_NMS_METHOD", "linear"],
    "gaussian+vote": ["TEST.SOFT_NMS_METHOD", "gaussian"],
    "gaussian": ["TEST.SOFT_NMS_METHOD", "gaussian",
                 "TEST.BBOX_VOTE_ENABLED", False],
}


@pytest.mark.parametrize("case", sorted(FINAL_OPTS))
def test_finalize_detections_matches_jax(case):
    """The final stage of 3d_R50_T8_softnms_vote (T=8) on seeded
    candidates with ties, invalid rows and clusters: soft-NMS's decayed
    scores, box voting over the valid pre-NMS candidates, the fc7 rows
    gathered through soft-NMS's indices."""
    jcfg, cfg = both_cfgs("configs/video/3d_R50_T8_softnms_vote.yaml",
                          ["TEST.DETECTIONS_PER_IM", 40, "TEST.SCORE_THRESH",
                           0.05] + FINAL_OPTS[case])
    t, b, k = 8, 2, 48
    rng = np.random.default_rng(12)
    base = rng.uniform(0, 200, (b, k // 4, 1, 4)).astype(np.float32)
    jitter = rng.normal(0, 4, (b, k // 4, 4, 4 * t)).astype(np.float32)
    refined = (np.tile(base, (1, 1, 4, t)) + jitter).reshape(b, k, 4 * t)
    pf = refined.reshape(b, k, t, 4)
    pf[..., 2:] = np.maximum(pf[..., 2:], pf[..., :2] + 8.0)
    refined = pf.reshape(b, k, 4 * t)
    scores = np.round(rng.uniform(0, 1, (b, k)) * 8).astype(np.float32) / 8
    valid = rng.uniform(size=(b, k)) > 0.2
    fc7 = rng.normal(size=(b, k, 16)).astype(np.float32)

    want = GeneralizedRCNN(jcfg).apply(
        {}, refined, scores, valid, fc7,
        method=GeneralizedRCNN._finalize_detections)
    model = build_model(cfg, device="meta")
    got = model._finalize_detections(*(torch.from_numpy(a) for a in (
        refined, scores, valid, fc7)))
    mask = np.asarray(want[2])
    assert mask.any() and not mask.all()
    np.testing.assert_array_equal(got[2].numpy(), mask)
    for g, w, tol in zip(got, want, (1e-4, 1e-6, 0, 1e-6)):
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(w)[mask],
                                   rtol=1e-6, atol=tol)
    if "vote" in case:     # voting moved some boxes off the candidates
        assert not np.isin(got[0].numpy()[mask][:, 0],
                           refined[..., 0]).all()


def _sampled_f64(rois, gt, bitmaps, p):
    """The bilinear samples `mask_targets` thresholds, in float64."""
    s, m = bitmaps.shape[0], bitmaps.shape[-1]
    rois, gt = rois.astype(np.float64), gt.astype(np.float64)
    f = (np.arange(p) + 0.5) / p
    u = ((rois[:, :1] + f * (rois[:, 2:3] - rois[:, :1]) - gt[:, :1])
         / np.maximum(gt[:, 2:3] - gt[:, :1], 1.0) * m - 0.5)
    v = ((rois[:, 1:2] + f * (rois[:, 3:4] - rois[:, 1:2]) - gt[:, 1:2])
         / np.maximum(gt[:, 3:4] - gt[:, 1:2], 1.0) * m - 0.5)
    u, v = np.broadcast_to(u[:, None], (s, p, p)), np.broadcast_to(
        v[:, :, None], (s, p, p))
    u0, v0 = np.floor(u), np.floor(v)
    out = np.zeros((s, p, p))
    for vi, ui, w in ((v0, u0, (1 - (u - u0)) * (1 - (v - v0))),
                      (v0, u0 + 1, (u - u0) * (1 - (v - v0))),
                      (v0 + 1, u0, (1 - (u - u0)) * (v - v0)),
                      (v0 + 1, u0 + 1, (u - u0) * (v - v0))):
        inb = (ui >= 0) & (ui < m) & (vi >= 0) & (vi < m)
        val = bitmaps[np.arange(s)[:, None, None],
                      np.clip(vi, 0, m - 1).astype(int),
                      np.clip(ui, 0, m - 1).astype(int)]
        out += np.where(inb, val, 0.0) * w
    return out


def test_mask_targets_and_loss_match_jax():
    """GT bitmaps resampled into rois (some equal to their GT box, whose
    samples fall half-way between bitmap pixels, some partly outside it),
    then the weighted per-pixel sigmoid CE."""
    rng = np.random.default_rng(13)
    s, m, p = 24, 16, 28
    gt = rng.uniform(0, 100, (s, 2))
    gt = np.concatenate([gt, gt + rng.uniform(10, 60, (s, 2))],
                        1).astype(np.float32)
    rois = (gt + rng.normal(0, 8, (s, 4))).astype(np.float32)
    rois[:6] = gt[:6]
    yy, xx = np.mgrid[:m, :m] / (m - 1.0)
    c = rng.uniform(0.3, 0.7, (s, 2, 1, 1))
    bitmaps = ((xx - c[:, 0]) ** 2 + (yy - c[:, 1]) ** 2
               < rng.uniform(0.05, 0.2, (s, 1, 1))).astype(np.float32)
    want = np.asarray(jax.jit(jtargets.mask_targets, static_argnums=3)(
        rois, gt, bitmaps, p))
    got = ttargets.mask_targets(torch.from_numpy(rois), torch.from_numpy(gt),
                                torch.from_numpy(bitmaps), p)
    # A roi equal to its GT box puts some samples half-way between a 0 and
    # a 1 pixel, where the last ulp decides the 0.5 threshold (JAX's own
    # jitted and eager results differ there): exact everywhere else.
    sure = np.abs(_sampled_f64(rois, gt, bitmaps, p) - 0.5) > 1e-5
    assert 0 < (~sure).sum() < 0.01 * sure.size
    np.testing.assert_array_equal(got.numpy()[sure], want[sure])
    assert 0 < want.mean() < 1

    logits = rng.normal(0, 3, (s, p, p)).astype(np.float32)
    weights = (rng.uniform(size=s) > 0.3).astype(np.float32)
    for w in (weights, np.zeros_like(weights)):
        jl = float(jlosses.mask_loss(logits, want, w, 0.7))
        tl = float(tlosses.mask_loss(torch.from_numpy(logits),
                                     torch.from_numpy(want),
                                     torch.from_numpy(w), 0.7))
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)


def test_conv5_mask_deconv_geometry():
    """flax's 2x2/s2 ConvTranspose (SAME padding, unflipped kernel) equals
    torch's ConvTranspose2d(k=2, s=2, p=0) with the bridge's flipped
    (ci, co, kh, kw) kernel."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(3, 7, 7, 5)).astype(np.float32)
    kernel = rng.normal(size=(2, 2, 5, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    want = fnn.ConvTranspose(6, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    deconv = torch.nn.ConvTranspose2d(5, 6, 2, stride=2)
    w = torch.from_numpy(np.ascontiguousarray(_to_port(deconv, kernel)))
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), w, torch.from_numpy(bias),
        stride=2).permute(0, 2, 3, 1)
    assert got.shape == (3, 14, 14, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _head_pair(jhead, thead, x, seed):
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), x)
    shapes = jax.tree.map(lambda s: tuple(s.shape), shapes,
                          is_leaf=lambda s: hasattr(s, "shape"))
    params = _random_params(shapes, np.random.default_rng(seed))
    thead.load_state_dict(jax_params_to_state_dict(params, thead))
    with torch.no_grad():
        got = thead(torch.from_numpy(x))
    return jhead.apply(params, x), got


def test_mask_head_matches_jax():
    """1up4convs at P=14 on (R, T, P, P, C) rois → (R, T, 28, 28, C')."""
    x = np.random.default_rng(15).normal(size=(3, 2, 14, 14, 12)).astype(
        np.float32)
    want, got = _head_pair(jheads.MaskHead(num_classes=2, dim=8),
                           theads.MaskHead(12, 2, 8), x, seed=16)
    assert tuple(got.shape) == (3, 2, 28, 28, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("dilation", [1, 2])
def test_res5_box_head_matches_jax(dilation):
    """res5 head on 64-wide pooled rois at T=3 (temporal kernel 3), ResNeXt
    groups 2, stride 2 or dilation 2."""
    x = np.random.default_rng(17).normal(size=(4, 3, 7, 7, 64)).astype(
        np.float32)
    want, got = _head_pair(
        jheads.Res5BoxHead(num_classes=2, num_frames=3, time_kernel=3,
                           width=16, groups=2, dilation=dilation),
        theads.Res5BoxHead(64, 2, 3, 3, 16, groups=2, dilation=dilation),
        x, seed=18)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("dilation", [1, 2])
def test_res5_box_head_grad_matches_jax(dilation):
    """The res5 head's backward, stride 2 or dilation 2 (the one branch
    that tells the dilated-C5 train step from the C4 one): gradients of a
    seeded linear loss of its three outputs w.r.t. every parameter and the
    pooled input, against `jax.grad` of the flax head."""
    rng = np.random.default_rng(19)
    x = rng.normal(size=(4, 3, 14, 14, 16)).astype(np.float32)
    jhead = jheads.Res5BoxHead(num_classes=2, num_frames=3, time_kernel=3,
                               width=8, dilation=dilation)
    thead = theads.Res5BoxHead(16, 2, 3, 3, 8, dilation=dilation)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), x)
    shapes = jax.tree.map(lambda s: tuple(s.shape), shapes,
                          is_leaf=lambda s: hasattr(s, "shape"))
    params = _random_params(shapes, np.random.default_rng(20))
    thead.load_state_dict(jax_params_to_state_dict(params, thead))
    outs = jax.eval_shape(jhead.apply, params, x)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def jloss(p, xx):
        return sum((o * c).sum() for o, c in zip(jhead.apply(p, xx), cots))

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(thead(xt), cots)).backward()
    got_p = state_dict_to_jax_params(
        {k: p.grad for k, p in thead.named_parameters()}, thead)
    pairs = [("input", xt.grad.numpy(), np.asarray(want_x))] + [
        (jax.tree_util.keystr(k), np.asarray(g), np.asarray(w))
        for (k, g), w in zip(jax.tree_util.tree_leaves_with_path(got_p),
                             jax.tree_util.tree_leaves(want_p))]
    assert len(pairs) == 1 + len(jax.tree_util.tree_leaves(want_p))
    for name, g, w in pairs:
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=max(
            1e-5, 1e-2 * float(np.abs(w).max())), err_msg=name)
