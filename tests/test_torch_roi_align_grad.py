"""The K3 entry points, the RoIAlign backward and the conv1 gradient of the
port (their plain versions, which CPU tensors run, and the autograd
Functions around them) against the JAX package on the CPU, at f32 on
seeded numpy inputs. Forward outputs atol 1e-4 (as the K1 tests);
gradients atol 1e-4 against JAX (sums in another order), 1e-5 against
torch's own autograd of the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.kernels import conv1 as jconv1
from detectandtrack_tpu.kernels import roi_align as jra
from detectandtrack_tpu_torch.kernels import conv1 as tconv1
from detectandtrack_tpu_torch.kernels import roi_align as tra
from detectandtrack_tpu_torch.kernels import roi_align_ops as tops

ATOL = 1e-4


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _special_rois(rng, n_random, span=380.0):
    """Every roi kind: degenerate, sub-pixel, wholly and partly outside the
    map, 6:1 and 1:6, huge, whole map; then random boxes."""
    special = np.array([
        [50, 50, 50, 50], [100.2, 60.1, 100.7, 60.6], [-300, -200, -20, -10],
        [300, 250, 700, 600], [10, 100, 370, 160], [200, 5, 260, 320],
        [-500, -500, 2000, 2000], [0, 0, 383, 319]], np.float32)
    rand = rng.uniform(-20, span, (n_random, 4)).astype(np.float32)
    rand[:, 2:] = rand[:, :2] + rng.uniform(0.5, 150, (n_random, 2))
    return np.concatenate([special, rand])


def _pyramid(rng, s=3, c=8):
    return ([rng.normal(size=(s, 80 // 2 ** i, 96 // 2 ** i, c))
             .astype(np.float32) for i in range(3)], [4, 8, 16])


@pytest.mark.parametrize("p", [7, 14])
def test_k3_entry_points_match_jax_reference(p):
    rng = np.random.default_rng(40 + p)
    feats, strides = _pyramid(rng)
    rois = _special_rois(rng, 8)
    r = len(rois)
    slabs = rng.integers(0, 3, r).astype(np.int32)
    levels = rng.integers(0, 3, r).astype(np.int32)
    f0 = feats[0]
    tube = np.concatenate([rois[:5], rois[5:10], rois[10:15]], axis=1)
    j = jax.jit(lambda f, fs, rr, tb, sl, lv: (
        jra.roi_align(f[1], rr, p, 2, 0.25, False),
        jra.roi_align_3d(f, tb, p, 2, 0.25, False),
        jra.roi_align_batched(f, rr, sl, p, 2, 0.25, False),
        jra.roi_align_multilevel([x[2] for x in fs], strides, rr, lv, p, 2,
                                 False),
        jra.roi_align_multilevel_batched(fs, strides, rr, lv, sl, p, 2,
                                         False)))
    want = j(jnp.asarray(f0), [jnp.asarray(f) for f in feats],
             jnp.asarray(rois), jnp.asarray(tube), jnp.asarray(slabs),
             jnp.asarray(levels))
    got = (tops.roi_align(_t(f0[1]), _t(rois), p, 2, 0.25),
           tops.roi_align_3d(_t(f0), _t(tube), p, 2, 0.25),
           tops.roi_align_batched(_t(f0), _t(rois), _t(slabs), p, 2, 0.25),
           tops.roi_align_multilevel([_t(f[2]) for f in feats], strides,
                                     _t(rois), _t(levels), p, 2),
           tops.roi_align_multilevel_batched(
               [_t(f) for f in feats], strides, _t(rois), _t(levels),
               _t(slabs), p, 2))
    cases = list(zip(got, want))
    for i, (got, want) in enumerate(cases):
        assert tuple(got.shape) == want.shape, i
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, err_msg=f"entry point {i}")


def test_k3_matches_pallas_interpret_inside_patch_contract():
    """Rois spanning <= patch-8 cells, as the JAX package's own test of the
    40-cell patch draws them, on three slabs."""
    rng = np.random.default_rng(50)
    feat = rng.normal(size=(3, 48, 64, 8)).astype(np.float32)
    x1 = rng.uniform(0, 30, 12)
    y1 = rng.uniform(0, 16, 12)
    rois = np.stack([x1, y1, x1 + rng.uniform(2, 31, 12),
                     y1 + rng.uniform(2, 31, 12)], 1).astype(np.float32)
    slabs = rng.integers(0, 3, 12).astype(np.int32)
    for p in (7, 14):
        want = np.asarray(jra._roi_align_pallas(
            jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(slabs), p, 2,
            patch=40, interpret=True))
        got = tops.roi_align_batched(_t(feat), _t(rois), _t(slabs), p, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _ml_case(rng):
    feats, strides = _pyramid(rng)
    rois = _special_rois(rng, 6).reshape(1, 14, 4).repeat(3, 0)
    rois = rois + rng.normal(0, 3, rois.shape).astype(np.float32)
    levels = rng.integers(0, 3, (3, 14)).astype(np.int32)
    return feats, strides, rois, levels


@pytest.mark.parametrize("p", [7, 14])
def test_backward_reference_matches_autograd_and_jax_dense(p):
    rng = np.random.default_rng(60 + p)
    feats, strides, rois, levels = _ml_case(rng)
    g = rng.normal(size=(3, 14, p, p, 8)).astype(np.float32)

    # torch autograd of the plain forward, and the Function's backward.
    tf = [_t(f, grad=True) for f in feats]
    out = tra.roi_align_multilevel_reference(tf, strides, _t(rois),
                                             _t(levels), p, 2)
    auto = torch.autograd.grad(out, tf, _t(g))
    tf2 = [_t(f, grad=True) for f in feats]
    out2 = tra.roi_align_multilevel_autograd(tf2, strides, _t(rois),
                                             _t(levels), p, 2)
    fn = torch.autograd.grad(out2, tf2, _t(g))
    ref = tra.roi_align_backward_reference(
        [f.shape for f in feats], torch.float32, strides,
        _t(rois.reshape(-1, 4)), tra.slab_of_rows(3, 14, "cpu"),
        _t(levels.reshape(-1)), _t(g.reshape(-1, p, p, 8)), p, 2)

    (want,) = jax.jit(lambda fs, gg: jax.vjp(
        lambda x: jra.roi_align_multilevel_dense(
            x, strides, jnp.asarray(rois), jnp.asarray(levels), p, 2),
        fs)[1](gg))([jnp.asarray(f) for f in feats], jnp.asarray(g))
    for lvl in range(3):
        np.testing.assert_allclose(ref[lvl].numpy(), auto[lvl].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(fn[lvl].numpy(), ref[lvl].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(ref[lvl].numpy(), np.asarray(want[lvl]),
                                   atol=ATOL)
    assert all(float(r.abs().sum()) > 0 for r in ref)


def test_k3_gradient_matches_jax_reference_vjp():
    """roi_align (a Function: gradient to the features, none to the rois)
    against jax.vjp of roi_align_reference, and roi_align_3d against the
    JAX form's gradient."""
    rng = np.random.default_rng(70)
    feat = rng.normal(size=(40, 48, 8)).astype(np.float32)
    rois = _special_rois(rng, 6, span=160.0)
    g = rng.normal(size=(len(rois), 7, 7, 8)).astype(np.float32)
    tf = _t(feat, grad=True)
    tr = _t(rois, grad=True)
    out = tops.roi_align(tf, tr, 7, 2, 0.5)
    got = torch.autograd.grad(out, [tf, tr], _t(g), allow_unused=True)
    assert got[1] is None
    want = jax.jit(lambda f, gg: jax.vjp(lambda x: jra.roi_align_reference(
        x, jnp.asarray(rois), 7, 2, 0.5), f)[1](gg))(jnp.asarray(feat), g)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL)

    stack = rng.normal(size=(3, 40, 48, 8)).astype(np.float32)
    tube = rois[:12].reshape(4, 12)
    g3 = rng.normal(size=(4, 3, 14, 14, 8)).astype(np.float32)
    ts = _t(stack, grad=True)
    (got3,) = torch.autograd.grad(tops.roi_align_3d(ts, _t(tube), 14, 2, 0.5),
                                  ts, _t(g3))
    want3 = jax.jit(lambda f, gg: jax.vjp(lambda x: jra.roi_align_3d(
        x, jnp.asarray(tube), 14, 2, 0.5, False), f)[1](gg))(
            jnp.asarray(stack), g3)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3[0]),
                               atol=ATOL)


@pytest.mark.parametrize("t,shape", [(3, (2, 4, 32, 48, 3)),
                                     (1, (1, 2, 31, 33, 3))])
def test_conv1_function_gradients_match_jax(t, shape):
    rng = np.random.default_rng(80 + t)
    x = rng.normal(size=shape).astype(np.float32)
    k7 = (rng.normal(size=(t, 7, 7, 3, 64)) * 0.05).astype(np.float32)
    out_shape = shape[:2] + ((shape[2] + 1) // 2, (shape[3] + 1) // 2, 64)
    g = rng.normal(size=out_shape).astype(np.float32)
    tx, tk = _t(x, grad=True), _t(k7, grad=True)
    before = tconv1.conv1_backward.calls
    y = tconv1.conv1_autograd(tx, tk, t, torch.float32)
    dx, dk = torch.autograd.grad(y, [tx, tk], _t(g))
    assert tconv1.conv1_backward.calls == before + 1
    _, vjp = jax.vjp(lambda a, b: jconv1._conv1_reference(a, b, t,
                                                          jnp.float32),
                     jnp.asarray(x), jnp.asarray(k7))
    want_dx, want_dk = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=ATOL)
    # dk sums H·W·B·T products per tap: compare at its own scale.
    scale = float(np.abs(np.asarray(want_dk)).max())
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk),
                               atol=ATOL * scale)
