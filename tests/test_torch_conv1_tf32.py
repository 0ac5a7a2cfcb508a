"""The f32 conv1 kernel's arithmetic on the CPU: the 3-pass TF32 split.

The kernel (`csrc/conv1.cu::conv1_tf32_kernel`) rounds each f32 operand v
to big = cvt.rna.tf32.f32(v) and small = cvt.rna.tf32.f32(v - big) and
sums small*big + big*small + big*big in f32. Here `tf32_rna` emulates that
rounding with integer operations on the f32 bits, `conv1_tf32_im2col`
reads the input window in the kernel's K order, and the split products of
that matrix with `conv1_tf32_weights` are held to the port's plain conv, to
an f64 conv and to the JAX package's Pallas kernel in interpret mode, on
seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detectandtrack_tpu.kernels import conv1 as jconv1
from detectandtrack_tpu_torch.kernels import conv1 as tconv1
from detectandtrack_tpu_torch.utils import roofline

SLOTS = tconv1.TF32_SLOTS
_F32_MAX = float(np.finfo(np.float32).max)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an f32 tensor: keep 10 mantissa bits, rounding
    to nearest with ties away from zero (add half of the dropped 13 bits'
    range to the sign-magnitude bits, then clear them); overflow goes to
    +-inf, +-inf stays, NaN stays NaN."""
    assert v.dtype == torch.float32
    bits = v.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(v), v, out)


def split(v: torch.Tensor):
    big = tf32_rna(v)
    return big, tf32_rna(v - big)


def _bits(values):
    return torch.tensor(np.array(values, np.uint32).view(np.int32)).view(
        torch.float32)


@pytest.mark.parametrize("given,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),            # tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),            # just below the tie
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),
    (_F32_MAX, float("inf")),                        # rounds past the max
    (-_F32_MAX, float("-inf")),
    (float("inf"), float("inf")),
    (float("-inf"), float("-inf")),
    (0.0, 0.0),
])
def test_tf32_rna_hand_picked(given, want):
    got = tf32_rna(torch.tensor([given], dtype=torch.float32))
    assert got.item() == want


def test_tf32_rna_bits():
    """Largest finite values, subnormals and NaN, by their bits."""
    given = _bits([0x7F7FEFFF, 0x7F7FF000, 0xFF7FEFFF, 0x00000001,
                   0x00000FFF, 0x00001000, 0x80001000, 0x007FFFFF,
                   0x7FC00000, 0x7F800001, 0xFFC00000])
    got = tf32_rna(given).view(torch.int32).numpy().view(np.uint32)
    want = [0x7F7FE000, 0x7F800000, 0xFF7FE000, 0x00000000, 0x00000000,
            0x00002000, 0x80002000, 0x00800000]
    assert [hex(b) for b in got[:8]] == [hex(b) for b in want]
    assert torch.isnan(tf32_rna(given)[8:]).all()


def test_split_keeps_f32_accuracy():
    """big + small equals v to ~2^-22 of |v|; big alone only to 2^-11."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy((rng.normal(size=100000)
                          * 10.0 ** rng.integers(-5, 5, 100000)).astype(
                              np.float32))
    big, small = split(v)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((v.double() - big.double() - small.double()).abs()
           / v.double().abs()).max().item()
    assert rel <= 2.0 ** -21
    assert ((v - big).abs() / v.abs()).max().item() <= 2.0 ** -11
    assert ((v - big).abs() / v.abs()).max().item() > 2.0 ** -13


def _inputs(shape, t, seed):
    """A clip of normalised pixels ((u - 102) / 57.4, u uniform on
    [0, 255]) and conv1 weights of the He scale the model starts from."""
    rng = np.random.default_rng(seed)
    x = ((rng.uniform(0, 255, size=shape) - 102.0) / 57.4).astype(np.float32)
    k7 = (rng.normal(size=(t, 7, 7, 3, 64))
          * np.sqrt(2.0 / (t * 49 * 3))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(k7)


def conv_3pass(x, k7, t):
    """Three plain convs of the rounded operands, summed in f32."""
    xb, xs = split(x)
    kb, ks = split(k7)
    ref = tconv1.conv1_reference
    return (ref(xs, kb, t, torch.float32) + ref(xb, ks, t, torch.float32)
            + ref(xb, kb, t, torch.float32))


@pytest.mark.parametrize("t,shape", [(1, (1, 2, 31, 45, 3)),
                                     (3, (1, 3, 37, 41, 3)),
                                     (3, (2, 2, 24, 32, 3))])
def test_3pass_conv_near_f64(t, shape):
    x, k7 = _inputs(shape, t, 41)
    want = tconv1.conv1_reference(x.double(), k7.double(), t, torch.float64)
    err3 = (conv_3pass(x, k7, t).double() - want).abs().max().item()
    one = tconv1.conv1_reference(tf32_rna(x), tf32_rna(k7), t, torch.float32)
    err1 = (one.double() - want).abs().max().item()
    assert err3 <= 1e-5
    assert err1 >= 100 * err3


def conv1_tf32_im2col(x: torch.Tensor, t: int) -> torch.Tensor:
    """The A operand of the f32 kernel as a matrix: x (B, T, H, W, 3) →
    (B, T, ceil(H/2), ceil(W/2), 24·7·t), K in `conv1_tf32_weights`'
    order: slot s < 21 of group (kt, ky) of output (τ, oy, ox) is value
    6·ox − 9 + s of clip row 2·oy − 3 + ky of frame τ + kt − (t−1)//2, the
    row flattened (x, c) and zero outside the clip; slots 21..23 are zero
    (the kernel never loads them)."""
    b, nt, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x, (0, 0, 3, 2 * wo + 2 - w, 3, 2 * ho + 2 - h,
                   (t - 1) // 2, t // 2))
    rows = xp.reshape(b, nt + t - 1, 2 * ho + 5, -1)
    groups = [F.pad(rows[:, kt:kt + nt, ky:ky + 2 * ho:2]
                    .unfold(-1, 21, 6)[..., :wo, :], (0, SLOTS - 21))
              for kt in range(t) for ky in range(7)]
    return torch.stack(groups, -2).reshape(b, nt, ho, wo, -1)


def emulate_kernel(x, k7, t):
    """The kernel's arithmetic: split A and B, three products, f32 sums."""
    ab, a_s = split(conv1_tf32_im2col(x, t))
    bb, bs = split(tconv1.conv1_tf32_weights(k7).t())
    return a_s @ bb + ab @ bs + ab @ bb


@pytest.mark.parametrize("t,shape", [
    (3, (1, 3, 13, 17, 3)), (1, (2, 2, 9, 11, 3)), (3, (1, 2, 37, 41, 3)),
    (1, (1, 1, 1, 1, 3)), (3, (1, 2, 19, 1, 3)), (3, (1, 1, 65, 9, 3))])
def test_tf32_layout_matches_plain_conv(t, shape):
    x, k7 = _inputs(shape, t, 43)
    got = emulate_kernel(x, k7, t)
    want = tconv1.conv1_reference(x, k7, t, torch.float32)
    assert got.shape == want.shape == shape[:2] + (
        (shape[2] + 1) // 2, (shape[3] + 1) // 2, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    jwant = np.asarray(jconv1._conv1_reference(
        jnp.asarray(x.numpy()), jnp.asarray(k7.numpy()), t, jnp.float32))
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-4)


@pytest.mark.parametrize("t,tt", [(1, 1), (3, 4)])
def test_tf32_layout_matches_pallas_interpret(t, tt):
    x, k7 = _inputs((2, tt, 32, 48, 3), t, 44)
    want = np.asarray(jconv1.conv1_s2d_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(k7.numpy()), t, jnp.float32,
        True))
    np.testing.assert_allclose(emulate_kernel(x, k7, t).numpy(), want,
                               atol=1e-4)


@pytest.mark.parametrize("t", [1, 3])
def test_tf32_weights_slots(t):
    """Slot s < 21 of group (kt, ky) holds k7[kt, ky, kx, ci] for
    s = 3·kx + ci; slots 21..23 are zero; the matrix is (64, 24·7·t)."""
    k7 = torch.arange(t * 7 * 7 * 3 * 64, dtype=torch.float32).reshape(
        t, 7, 7, 3, 64)
    wk = tconv1.conv1_tf32_weights(k7)
    assert tuple(wk.shape) == (64, SLOTS * 7 * t) and wk.is_contiguous()
    g = wk.reshape(64, t, 7, SLOTS)
    assert not g[..., 21:].any()
    for kt, ky, kx, ci in ((0, 0, 0, 0), (t - 1, 6, 6, 2), (0, 3, 2, 1)):
        torch.testing.assert_close(g[:, kt, ky, 3 * kx + ci],
                                   k7[kt, ky, kx, ci], rtol=0, atol=0)


@pytest.mark.parametrize("t", [1, 3])
def test_tf32_non_finite_masks_equal(t):
    """+-inf and NaN planted in the clip, one at its right edge: the
    emulated kernel is non-finite exactly where the plain conv is (where
    the plain conv gives +-inf the split may give NaN); the finite outputs
    agree with the plain conv of the clip without them."""
    x, k7 = _inputs((1, 3, 21, 34, 3), t, 45)
    clean = tconv1.conv1_reference(x, k7, t, torch.float32)
    for (f, y, col, c), v in (((1, 5, 9, 0), "inf"), ((2, 17, 20, 2), "nan"),
                              ((0, 0, 33, 1), "-inf")):
        x[0, f, y, col, c] = float(v)
    plain = tconv1.conv1_reference(x, k7, t, torch.float32)
    got = emulate_kernel(x, k7, t)
    mask = torch.isfinite(plain)
    assert not mask.all()
    assert torch.equal(torch.isfinite(got), mask)
    np.testing.assert_allclose(got[mask].numpy(), clean[mask].numpy(),
                               atol=1e-5)


def test_conv1_bounds():
    """f32: the 3-pass TF32 bound (3 × 242.8 GFLOP at 495 TFLOP/s) is
    below the CUDA cores' (242.8 at 67) and above the bytes' (1.307 GB at
    3.35 TB/s); bf16 stays at the bf16 tensor-core peak."""
    shape = (2, 8, 800, 1344, 3)
    work = roofline.conv1_work(shape, 3, torch.float32)
    assert work.kind == "tf32"
    assert work.flops == pytest.approx(3 * 242.8e9, rel=1e-3)
    assert work.n_bytes == pytest.approx(1.307e9, rel=1e-3)
    ms, by = roofline.bound(work)
    assert by == "operations" and ms == pytest.approx(1.4713, abs=1e-4)
    assert 3 / roofline.H100_SXM.tf32_flops < 1 / roofline.H100_SXM.f32_flops
    ms, by = roofline.bound(roofline.conv1_work(shape, 3, torch.bfloat16))
    assert by == "operations" and ms == pytest.approx(0.2455, abs=1e-4)


def test_conv1_f32_bound_is_the_smaller():
    """On a card whose TF32 rate is under 3x its f32 rate the f32 bound is
    the CUDA cores' one product per multiply-add; an unknown operation kind
    has no peak."""
    slow_tf32 = roofline.Peaks("slow TF32", 989e12, 67e12, 3.35e12, 150e12)
    shape = (2, 8, 800, 1344, 3)
    work = roofline.conv1_work(shape, 3, torch.float32, slow_tf32)
    assert work.kind == "f32"
    assert work.flops == pytest.approx(242.8e9, rel=1e-3)
    ms, by = roofline.bound(work, slow_tf32)
    assert by == "operations" and ms == pytest.approx(3.624, abs=1e-3)
    with pytest.raises(ValueError, match="unknown operation kind"):
        roofline.H100_SXM.flops("fp32")
