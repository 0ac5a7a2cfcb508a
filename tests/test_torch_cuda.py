"""The port's CUDA kernels against their plain versions, on a CUDA card.

Skipped without one. On the card (no JAX there, so without the repository
conftest, which imports it):

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from detectandtrack_tpu_torch.kernels.conv1 import conv1, conv1_reference
from detectandtrack_tpu_torch.kernels.roi_align import (
    roi_align_multilevel, roi_align_multilevel_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(ref, dtype):
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(1.0, ref.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,shape", [(3, (2, 4, 32, 48, 3)),
                                     (1, (1, 2, 37, 41, 3)),
                                     (3, (1, 3, 65, 9, 3))])
def test_conv1_kernel_matches_plain(cuda, dtype, t, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen)
    k7 = torch.randn((t, 7, 7, 3, 64), device=cuda, generator=gen) * 0.05
    before = conv1.launches
    got = conv1(x, k7, t, dtype)
    assert conv1.launches == before + 1
    ref = conv1_reference(x, k7, t, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max().item() <= _tol(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_kernel_matches_plain(cuda, dtype, p):
    rng = np.random.default_rng(1)
    feats = [torch.from_numpy(rng.normal(size=(3, 80 // 2 ** i, 96 // 2 ** i,
                                               40)).astype(np.float32))
             .to(cuda, dtype) for i in range(3)]
    rois = rng.uniform(-30, 380, (3, 9, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(-1, 200, (3, 9, 2))
    rois[:, 0] = [40, 40, 40, 40]                  # degenerate
    rois[:, 1] = [-300, -200, -20, -10]            # outside the map
    rois = torch.from_numpy(rois).to(cuda)
    levels = torch.from_numpy(rng.integers(0, 3, (3, 9)).astype(
        np.int32)).to(cuda)
    before = roi_align_multilevel.launches
    got = roi_align_multilevel(feats, [4, 8, 16], rois, levels, p, 2)
    assert roi_align_multilevel.launches == before + 1
    ref = roi_align_multilevel_reference(feats, [4, 8, 16], rois, levels, p,
                                         2)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3, 9, p, p, 40)
    assert (got.float() - ref.float()).abs().max().item() <= _tol(ref, dtype)


def test_kernel_wrappers_reject_what_they_cannot_take(cuda):
    x = torch.zeros((1, 1, 8, 8, 3), device=cuda)
    with pytest.raises(TypeError):
        conv1(x, torch.zeros((1, 7, 7, 3, 64), device=cuda), 1, torch.float16)
    with pytest.raises(ValueError):
        conv1(x, torch.zeros((3, 7, 7, 3, 64), device=cuda), 1,
              torch.float32)
    feats = [torch.zeros((1, 8, 8, 4), device=cuda)]
    rois = torch.zeros((1, 2, 4), device=cuda)
    levels = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        roi_align_multilevel([feats[0].transpose(1, 2)], [4], rois, levels)
    with pytest.raises(ValueError):
        roi_align_multilevel(feats, [4], rois, levels.long())
