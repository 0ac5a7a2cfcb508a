"""The plain versions of the port's two kernels (what a CPU tensor runs)
against the JAX package's Pallas kernels in interpret mode and its exact
XLA forms, at f32 and atol 1e-4, on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.kernels import conv1 as jconv1
from detectandtrack_tpu.kernels import roi_align as jra
from detectandtrack_tpu.models.backbone import Conv1S2D
from detectandtrack_tpu_torch.kernels import conv1 as tconv1
from detectandtrack_tpu_torch.kernels import roi_align as tra
from detectandtrack_tpu_torch.models.backbone import Conv1


def _pyramid(rng, s=3, c=8):
    feats = [rng.normal(size=(s, 80 // 2 ** i, 96 // 2 ** i, c))
             .astype(np.float32) for i in range(3)]
    return feats, [4, 8, 16]


def _torch_align(feats, strides, rois, levels, p):
    return tra.roi_align_multilevel(
        [torch.from_numpy(f) for f in feats], strides,
        torch.from_numpy(rois), torch.from_numpy(levels), p, 2).numpy()


@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_plain_matches_pallas_interpret(p):
    """Span-contract rois (aspect <= 2, sized for their level), as the
    JAX package's own Pallas test draws them."""
    rng = np.random.default_rng(21)
    feats, strides = _pyramid(rng)
    rois = np.zeros((3, 6, 4), np.float32)
    lv = rng.integers(0, 3, size=(3, 6)).astype(np.int32)
    for si in range(3):
        for ri in range(6):
            side = 40.0 * 2 ** lv[si, ri]
            x1, y1 = rng.uniform(-10, 300), rng.uniform(-10, 250)
            rois[si, ri] = [x1, y1, x1 + side * rng.uniform(0.6, 1.8),
                            y1 + side * rng.uniform(0.6, 1.8)]
    want = np.asarray(jra.roi_align_multilevel_pallas(
        [jnp.asarray(f) for f in feats], strides, jnp.asarray(rois),
        jnp.asarray(lv), p, 2, interpret=True))
    got = _torch_align(feats, strides, rois, lv, p)
    assert got.shape == (3, 6, p, p, 8)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_plain_matches_dense_on_all_rois(p):
    """Every roi kind, at every level: degenerate, sub-pixel, wholly and
    partly outside the map, 6:1 and 1:6, and huge."""
    rng = np.random.default_rng(22)
    feats, strides = _pyramid(rng)
    special = np.array([
        [50, 50, 50, 50], [100.2, 60.1, 100.7, 60.6], [-300, -200, -20, -10],
        [300, 250, 700, 600], [10, 100, 370, 160], [200, 5, 260, 320],
        [-500, -500, 2000, 2000], [0, 0, 383, 319]], np.float32)
    rois = np.concatenate([np.tile(special[None], (3, 1, 1)),
                           rng.uniform(-20, 380, (3, 8, 4))
                           .astype(np.float32)], axis=1)
    rois[:, 8:, 2:] = rois[:, 8:, :2] + rng.uniform(0.5, 150, (3, 8, 2))
    lv = rng.integers(0, 3, size=rois.shape[:2]).astype(np.int32)
    want = np.asarray(jra.roi_align_multilevel_dense(
        [jnp.asarray(f) for f in feats], strides, jnp.asarray(rois),
        jnp.asarray(lv), p, 2))
    got = _torch_align(feats, strides, rois, lv, p)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_roi_align_plain_keeps_bf16():
    rng = np.random.default_rng(23)
    feats, strides = _pyramid(rng, s=2)
    rois = np.array([[[8, 8, 60, 70]], [[0, 0, 200, 150]]], np.float32)
    lv = np.array([[0], [2]], np.int32)
    got = tra.roi_align_multilevel(
        [torch.from_numpy(f).bfloat16() for f in feats], strides,
        torch.from_numpy(rois), torch.from_numpy(lv), 7, 2)
    assert got.dtype == torch.bfloat16
    want = _torch_align([f.astype(np.float32) for f in feats], strides, rois,
                        lv, 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05)


@pytest.mark.parametrize("t,tt", [(1, 1), (3, 4)])
def test_conv1_plain_matches_pallas_interpret(t, tt):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, tt, 32, 48, 3)).astype(np.float32)
    k7 = (rng.normal(size=(t, 7, 7, 3, 64)) * 0.05).astype(np.float32)
    want = np.asarray(jconv1.conv1_s2d_pallas(
        jnp.asarray(x), jnp.asarray(k7), t, jnp.float32, True))
    got = tconv1.conv1(torch.from_numpy(x), torch.from_numpy(k7), t,
                       torch.float32)
    assert got.shape == (2, tt, 16, 24, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("t,shape", [(1, (1, 1, 31, 33, 3)),
                                     (3, (1, 3, 27, 21, 3))])
def test_conv1_plain_matches_reference_odd_sizes(t, shape):
    """Odd H, W: the JAX model takes its plain conv there (the Pallas
    kernel needs even sizes)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape).astype(np.float32)
    k7 = (rng.normal(size=(t, 7, 7, 3, 64)) * 0.05).astype(np.float32)
    want = np.asarray(jconv1._conv1_reference(
        jnp.asarray(x), jnp.asarray(k7), t, jnp.float32))
    got = tconv1.conv1(torch.from_numpy(x), torch.from_numpy(k7), t,
                       torch.float32)
    assert got.shape == want.shape == shape[:2] + (
        (shape[2] + 1) // 2, (shape[3] + 1) // 2, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_conv1_module_matches_conv1s2d_pallas(monkeypatch):
    """The port's Conv1 (conv1 then affine) against the JAX Conv1S2D with
    its Pallas kernel selected, sharing the canonical param tree."""
    monkeypatch.setenv("DAT_CONV1_IMPL", "pallas")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 32, 48, 3)).astype(np.float32)
    jm = Conv1S2D(time_kernel=3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    p = shapes["params"]
    params = {"params": {
        "conv": {"kernel": (rng.normal(size=p["conv"]["kernel"].shape)
                            * 0.05).astype(np.float32)},
        "bn": {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
               "bias": rng.normal(size=64).astype(np.float32)}}}
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = Conv1(3)
    tm.load_state_dict({
        "conv.weight": torch.from_numpy(params["params"]["conv"]["kernel"]),
        "bn.scale": torch.from_numpy(params["params"]["bn"]["scale"]),
        "bn.bias": torch.from_numpy(params["params"]["bn"]["bias"])})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
