"""The tensor-core conv1 kernel's arithmetic on the CPU: its A operand
(`conv1_tc_im2col` below, the input window read in the kernel's padded K
order) times the weight matrix the wrapper prepares (`conv1_tc_weights`) is
conv1.
Held in f32 to the port's plain conv (atol 1e-5) and to the JAX package's
plain conv and Pallas kernel in interpret mode (atol 1e-4), on the same
seeded numpy inputs, at odd and even H, W and t in {1, 3}."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detectandtrack_tpu.kernels import conv1 as jconv1
from detectandtrack_tpu_torch.kernels import conv1 as tconv1

TC_SLOTS = tconv1.TC_SLOTS


def conv1_tc_im2col(x: torch.Tensor, t: int) -> torch.Tensor:
    """The A operand of the tensor-core kernel as a matrix: x (B, T, H, W, 3)
    → (B, T, ceil(H/2), ceil(W/2), 24·7·t) in f32, K in
    `conv1_tc_weights`' order: slot s of group (kt, ky) of output (τ, oy,
    ox) is value 6·ox − 10 + s of clip row 2·oy − 3 + ky of frame
    τ + kt − (t−1)//2, the row flattened (x, c) and zero outside the clip.
    Times `conv1_tc_weights(k7)`, transposed, it is conv1."""
    b, nt, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    # Columns from x = -4 (slot 0 of ox = 0 is its last channel) to
    # 2·wo + 2; rows from -3 to 2·ho + 1.
    xp = F.pad(x.float(), (0, 0, 4, 2 * wo + 3 - w, 3, 2 * ho + 2 - h,
                           (t - 1) // 2, t // 2))
    rows = xp.reshape(b, nt + t - 1, 2 * ho + 5, -1)
    groups = [rows[:, kt:kt + nt, ky:ky + 2 * ho:2, 2:]
              .unfold(-1, TC_SLOTS, 6)[..., :wo, :]
              for kt in range(t) for ky in range(7)]
    return torch.stack(groups, -2).reshape(b, nt, ho, wo, -1)


def _inputs(shape, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k7 = (rng.normal(size=(t, 7, 7, 3, 64)) * 0.05).astype(np.float32)
    return x, k7


def _emulate(x, k7, t):
    a = conv1_tc_im2col(torch.from_numpy(x), t)
    return a @ tconv1.conv1_tc_weights(torch.from_numpy(k7)).t()


@pytest.mark.parametrize("t,shape", [
    (3, (1, 3, 13, 17, 3)), (1, (2, 2, 9, 11, 3)), (3, (1, 4, 37, 41, 3)),
    (1, (1, 1, 31, 33, 3)), (3, (2, 2, 16, 24, 3)), (1, (1, 2, 1, 1, 3)),
    (3, (1, 1, 65, 9, 3))])
def test_tc_layout_matches_plain_conv(t, shape):
    x, k7 = _inputs(shape, t, 31)
    got = _emulate(x, k7, t)
    want = tconv1.conv1_reference(torch.from_numpy(x), torch.from_numpy(k7),
                                  t, torch.float32)
    assert got.shape == want.shape == shape[:2] + (
        (shape[2] + 1) // 2, (shape[3] + 1) // 2, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    jwant = np.asarray(jconv1._conv1_reference(
        jnp.asarray(x), jnp.asarray(k7), t, jnp.float32))
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-4)


@pytest.mark.parametrize("t,tt", [(1, 1), (3, 4)])
def test_tc_layout_matches_pallas_interpret(t, tt):
    x, k7 = _inputs((2, tt, 32, 48, 3), t, 32)
    want = np.asarray(jconv1.conv1_s2d_pallas(
        jnp.asarray(x), jnp.asarray(k7), t, jnp.float32, True))
    np.testing.assert_allclose(_emulate(x, k7, t).numpy(), want, atol=1e-4)


@pytest.mark.parametrize("t", [1, 3])
def test_tc_weights_slots(t):
    """Slot s of group (kt, ky) holds k7[kt, ky, kx, ci] for s - 1 =
    3·kx + ci; slots 0, 22, 23 are zero; the matrix is (64, 24·7·t)."""
    k7 = torch.arange(t * 7 * 7 * 3 * 64, dtype=torch.float32).reshape(
        t, 7, 7, 3, 64)
    wk = tconv1.conv1_tc_weights(k7)
    assert tuple(wk.shape) == (64, tconv1.TC_SLOTS * 7 * t)
    assert wk.is_contiguous()
    g = wk.reshape(64, t, 7, tconv1.TC_SLOTS)
    assert not g[..., [0, 22, 23]].any()
    for kt, ky, kx, ci in ((0, 0, 0, 0), (t - 1, 6, 6, 2), (0, 3, 2, 1)):
        torch.testing.assert_close(g[:, kt, ky, 1 + 3 * kx + ci],
                                   k7[kt, ky, kx, ci], rtol=0, atol=0)
