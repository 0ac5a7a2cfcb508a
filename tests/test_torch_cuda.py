"""The port's CUDA kernels against their plain versions, on a CUDA card.

Skipped without one. On the card (no JAX there, so without the repository
conftest, which imports it):

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from detectandtrack_tpu_torch.kernels import affine as ka
from detectandtrack_tpu_torch.kernels import diag_roialign as dr
from detectandtrack_tpu_torch.kernels import roi_align as ra
from detectandtrack_tpu_torch.kernels.conv1 import (conv1, conv1_autograd,
                                                    conv1_reference, conv1_tc,
                                                    conv1_tf32)
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
                                     (3, (1, 3, 65, 9, 3)),
                                     (3, (1, 2, 19, 1, 3))])
def test_conv1_kernel_matches_plain(cuda, dtype, t, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen)
    k7 = torch.randn((t, 7, 7, 3, 64), device=cuda, generator=gen) * 0.05
    before = (conv1.launches, conv1.launches_tc, conv1.launches_f32)
    got = conv1(x, k7, t, dtype)
    tc = dtype == torch.bfloat16
    assert (conv1.launches, conv1.launches_tc, conv1.launches_f32) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
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


@pytest.mark.parametrize("t,shape", [(3, (1, 2, 33, 35, 3)),
                                     (1, (2, 3, 17, 19, 3)),
                                     (3, (1, 4, 130, 140, 3)),
                                     (1, (1, 1, 1, 1, 3)),
                                     (3, (1, 2, 7, 8, 3))])
def test_conv1_tc_kernel_matches_plain_at_odd_sizes(cuda, t, shape):
    """The bf16 tensor-core kernel on its own: odd H and W (its W is padded
    to a multiple of 8), ragged tiles in both directions, t = 1 and 3."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    k7 = (torch.randn((t, 7, 7, 3, 64), device=cuda, generator=gen)
          * 0.05).to(torch.bfloat16)
    ref = conv1_reference(x, k7, t, torch.bfloat16)
    before = conv1.launches_tc
    got = conv1_tc(x, k7, t)
    assert conv1.launches_tc == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max().item() <= _tol(
        ref, torch.bfloat16)


@pytest.mark.parametrize("t,shape", [(3, (1, 2, 33, 35, 3)),
                                     (1, (2, 3, 17, 19, 3)),
                                     (3, (1, 4, 130, 140, 3)),
                                     (1, (1, 1, 1, 1, 3)),
                                     (3, (1, 2, 7, 8, 3)),
                                     (3, (1, 2, 37, 1, 3))])
def test_conv1_tf32_kernel_matches_plain_at_odd_sizes(cuda, t, shape):
    """The f32 3-pass TF32 kernel on its own: odd H and W (its W is padded
    to a multiple of 4), width 1, ragged tiles, t = 1 and 3; f32 plain conv
    with TF32 off, within 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(shape, device=cuda, generator=gen)
    k7 = torch.randn((t, 7, 7, 3, 64), device=cuda, generator=gen) * 0.05
    ref = conv1_reference(x, k7, t, torch.float32)
    before = conv1.launches_f32
    got = conv1_tf32(x, k7, t)
    assert conv1.launches_f32 == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("t", [1, 3])
def test_conv1_tf32_kernel_non_finite_masks_equal_plain(cuda, t):
    """An inf and a NaN planted in the clip (and a -inf at its edge): the
    kernel's output is non-finite exactly where a direct conv's is, the
    outputs whose window holds a planted value (the split of +-inf gives
    NaN where the plain conv may give +-inf); elsewhere it agrees with the
    plain conv of the clip without them within 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((1, 3, 40, 70, 3), device=cuda, generator=gen)
    k7 = torch.randn((t, 7, 7, 3, 64), device=cuda, generator=gen) * 0.05
    ref = conv1_reference(x, k7, t, torch.float32)
    planted = torch.zeros_like(x)
    for (f, y, col, c), v in (((1, 10, 20, 0), "inf"), ((2, 31, 45, 2), "nan"),
                              ((0, 0, 69, 1), "-inf")):
        x[0, f, y, col, c] = float(v)
        planted[0, f, y, col, c] = 1.0
    # A direct conv's non-finite outputs: those whose window reads a
    # planted value (inf * 0 is NaN too).
    finite = conv1_reference(planted, torch.ones_like(k7), t,
                             torch.float32) < 0.5
    assert not finite.all()
    got = conv1(x, k7, t, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(got), finite)
    assert (got[finite] - ref[finite]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("nan_bits", [0x7FC00000, 0x7FFFFFFF, 0xFFFFE001])
def test_conv1_tf32_kernel_nan_weight_stays_nan(cuda, nan_bits):
    """A NaN weight, whatever its payload (one whose rounding on the bits
    would carry into the sign included), makes its channel NaN wherever
    the plain conv does; the other channels keep within 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((1, 2, 20, 24, 3), device=cuda, generator=gen)
    k7 = torch.randn((3, 7, 7, 3, 64), device=cuda, generator=gen) * 0.05
    k7.view(torch.int32)[1, 3, 3, 2, 5] = int(
        np.array([nan_bits], np.uint32).view(np.int32)[0])
    ref = conv1_reference(x, k7, 3, torch.float32)
    got = conv1(x, k7, 3, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    assert not torch.isfinite(got[..., 5]).any()
    finite = torch.isfinite(ref)
    assert (got[finite] - ref[finite]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_conv1_raises_on_unsupported_dtype(cuda, dtype):
    x = torch.zeros((1, 1, 8, 8, 3), device=cuda)
    k7 = torch.zeros((1, 7, 7, 3, 64), device=cuda)
    before = conv1.launches
    with pytest.raises(TypeError):
        conv1(x, k7, 1, dtype)
    assert conv1.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [41, 12, 3])
def test_roi_align_kernel_channels_not_a_multiple_of_8(cuda, dtype, c):
    """K1 loads channel by channel where C % 8 != 0, in the same kernel."""
    rng = np.random.default_rng(8)
    feats = _maps(rng, cuda, dtype, c=c)
    rois = _pair_rois(rng, cuda, 27).reshape(3, 9, 4).contiguous()
    levels = torch.from_numpy(rng.integers(0, 3, (3, 9)).astype(
        np.int32)).to(cuda)
    for p in (7, 14):
        before = roi_align_multilevel.launches
        got = roi_align_multilevel(feats, [4, 8, 16], rois, levels, p, 2)
        assert roi_align_multilevel.launches == before + 1
        ref = roi_align_multilevel_reference(feats, [4, 8, 16], rois, levels,
                                             p, 2)
        torch.cuda.synchronize()
        assert got.shape == (3, 9, p, p, c)
        assert (got.float() - ref.float()).abs().max().item() <= _tol(
            ref, dtype)


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


def _maps(rng, cuda, dtype, s=3, c=40, hw=((80, 96), (37, 45), (19, 23))):
    return [torch.from_numpy(rng.normal(size=(s, h, w, c)).astype(
        np.float32)).to(cuda, dtype) for h, w in hw]


def _pair_rois(rng, cuda, n=23):
    rois = rng.uniform(-30, 380, (n, 4)).astype(np.float32)
    rois[:, 2:] = rois[:, :2] + rng.uniform(-1, 200, (n, 2))
    rois[0] = [40, 40, 40, 40]                     # degenerate
    rois[1] = [-300, -200, -20, -10]               # outside the map
    rois[2] = [10.3, 20.7, 10.9, 21.1]             # sub-pixel
    return torch.from_numpy(rois).to(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("per_roi_levels", [True, False])
def test_roi_align_pairs_kernel_matches_plain(cuda, dtype, p, per_roi_levels):
    rng = np.random.default_rng(2)
    feats = _maps(rng, cuda, dtype)
    rois = _pair_rois(rng, cuda)
    n = rois.shape[0]
    slabs = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(cuda)
    levels = (torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
              .to(cuda) if per_roi_levels else None)
    before = ra.roi_align_pairs.launches
    got = ra.roi_align_pairs(feats, [4, 8, 16], rois, slabs, levels, p, 2)
    assert ra.roi_align_pairs.launches == before + 1
    ref = ra.roi_align_pairs_reference(feats, [4, 8, 16], rois, slabs, levels,
                                       p, 2)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, p, p, 40)
    assert (got.float() - ref.float()).abs().max().item() <= _tol(ref, dtype)


def _bwd_rois(rng, cuda, n=23):
    """`_pair_rois` and the backward's special rois: NaN corners, 6:1 and
    1:6, larger than the image, image-sized, samples clamped to the last
    cell (the maps of `_maps` cover a 384x320 image at stride 4)."""
    nan = float("nan")
    extra = torch.tensor([
        [nan, 10, 40, 50], [10, 10, nan, 50], [nan, nan, nan, nan],
        [10, 100, 370, 160], [120, 5, 180, 305], [-500, -500, 2000, 2000],
        [0, 0, 383, 319], [378, 314, 383, 319]])
    return torch.cat([_pair_rois(rng, cuda, n), extra.to(cuda)])


@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_pairs_kernel_matches_plain_on_nan_rois(cuda, p):
    """A roi with a NaN corner pools zeros, as the plain version's samples
    are all invalid there (a NaN extent stays NaN through max(extent, 1))."""
    rng = np.random.default_rng(12)
    feats = _maps(rng, cuda, torch.float32)
    rois = _bwd_rois(rng, cuda)
    slabs = torch.from_numpy(rng.integers(0, 3, rois.shape[0]).astype(
        np.int32)).to(cuda)
    got = ra.roi_align_pairs(feats, [4, 8, 16], rois, slabs, None, p, 2)
    ref = ra.roi_align_pairs_reference(feats, [4, 8, 16], rois, slabs, None,
                                       p, 2)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4
    assert not got[rois.isnan().any(1)].any()


def _bwd_case(seed, cuda, dtype, p, c=40, per_roi_levels=True, n=23,
              hw=((80, 96), (37, 45), (19, 23))):
    rng = np.random.default_rng(seed)
    shapes = [(3, h, w, c) for h, w in hw]
    rois = _bwd_rois(rng, cuda, n) if n else torch.zeros((0, 4), device=cuda)
    n = rois.shape[0]
    slabs = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(cuda)
    levels = (torch.from_numpy(rng.integers(0, len(hw), n).astype(np.int32))
              .to(cuda) if per_roi_levels else None)
    grad = torch.from_numpy(rng.normal(size=(n, p, p, c)).astype(
        np.float32)).to(cuda, dtype)
    return shapes, [4, 8, 16][:len(hw)], rois, slabs, levels, grad


def _bwd_held(shapes, strides, rois, slabs, levels, grad, p, dtype, s=2):
    """One kernel call (counted) held to the plain version → its maps."""
    before = ra.roi_align_backward.launches
    got = ra.roi_align_backward(shapes, dtype, strides, rois, slabs, levels,
                                grad, p, s)
    assert ra.roi_align_backward.launches == before + 1
    ref = ra.roi_align_backward_reference(shapes, dtype, strides, rois, slabs,
                                          levels, grad, p, s)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert torch.isfinite(g.float()).all()
        assert (g.float() - r.float()).abs().max().item() <= _tol(r, dtype)
    return got, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("c,per_roi_levels", [(40, True), (40, False),
                                              (41, True), (12, True),
                                              (3, False)])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, p, c,
                                                 per_roi_levels):
    """The tile-owned gather against the plain index_add_ version at the
    forward's tolerances, with the special rois (NaN among them), C % 8 != 0
    (channel by channel) and levels=None."""
    case = _bwd_case(3, cuda, dtype, p, c, per_roi_levels)
    _, ref = _bwd_held(*case, p, dtype)
    assert any(r.abs().sum() > 0 for r in ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,s", [(5, 2), (7, 3), (14, 1)])
def test_roi_align_backward_kernel_other_output_sizes(cuda, dtype, p, s):
    """Output sizes and sampling ratios the kernel takes at run time (7 and
    14 at s=2 are compiled in)."""
    case = _bwd_case(11, cuda, dtype, p)
    _bwd_held(*case, p, dtype, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_at_1024_channels_and_no_rois(cuda, dtype):
    """One 1024-wide level (C4's res4: 8 channel slices per tile) at P=14,
    and N == 0, whose maps are all zeros."""
    case = _bwd_case(9, cuda, dtype, 14, 1024, True, hw=((50, 84),))
    _bwd_held(*case, 14, dtype)
    got, _ = _bwd_held(*_bwd_case(9, cuda, dtype, 7, n=0), 7, dtype)
    assert not any(g.any() for g in got)


def test_roi_align_backward_prep_matches_plain_footprints(cuda):
    """The prep kernel's keys and footprints equal the plain rule's."""
    shapes, strides, rois, slabs, levels, _ = _bwd_case(5, cuda,
                                                        torch.float32, 7)
    for lv in (levels, None):
        for p in (7, 14):
            keys, fp = ra.backward_prep(shapes, strides, rois, slabs, lv, p,
                                        2)
            want = ra.backward_prep(shapes, strides, rois.cpu(), slabs.cpu(),
                                    None if lv is None else lv.cpu(), p, 2)
            assert torch.equal(keys.cpu(), want[0])
            assert torch.equal(fp.cpu(), want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_is_bitwise_repeatable_on_poisoned_memory(
        cuda, dtype):
    """Every cell has one owner and a fixed order: two calls agree bit for
    bit. The output comes from torch.empty: a NaN-filled block of its size,
    freed just before the call, is what the allocator hands back, so an
    unwritten tile would show."""
    case = _bwd_case(7, cuda, dtype, 7)
    first = ra.roi_align_backward(case[0], dtype, *case[1:], 7, 2)
    size = sum(int(np.prod(sh)) for sh in case[0])
    poison = torch.full((size,), float("nan"), dtype=dtype, device=cuda)
    ptr = poison.data_ptr()
    del poison
    second, _ = _bwd_held(*case, 7, dtype)
    assert second[0].data_ptr() == ptr
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_roi_align_function_on_card_matches_cpu(cuda):
    """The slab-grouped autograd path: K1 forward, the gather kernel
    backward, against the CPU path's gradients."""
    rng = np.random.default_rng(4)
    cpu = [f.cpu().requires_grad_() for f in _maps(rng, cuda, torch.float32)]
    gpu = [f.detach().to(cuda).requires_grad_() for f in cpu]
    rois = _pair_rois(rng, cuda, 27).reshape(3, 9, 4).contiguous()
    levels = torch.from_numpy(rng.integers(0, 3, (3, 9)).astype(
        np.int32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(3, 9, 7, 7, 40)).astype(np.float32))
    fwd, bwd = roi_align_multilevel.launches, ra.roi_align_backward.launches
    out = ra.roi_align_multilevel_autograd(gpu, [4, 8, 16], rois, levels)
    got = torch.autograd.grad(out, gpu, g.to(cuda))
    assert roi_align_multilevel.launches == fwd + 1
    assert ra.roi_align_backward.launches == bwd + 1
    want = torch.autograd.grad(ra.roi_align_multilevel_autograd(
        cpu, [4, 8, 16], rois.cpu(), levels.cpu()), cpu, g)
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max().item() <= 1e-4


def test_conv1_function_gradients_match_plain(cuda):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 3, 37, 41, 3)).astype(
        np.float32)).to(cuda).requires_grad_()
    k7 = (torch.from_numpy(rng.normal(size=(3, 7, 7, 3, 64)).astype(
        np.float32)) * 0.05).to(cuda).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(1, 3, 19, 21, 64)).astype(
        np.float32)).to(cuda)
    got = torch.autograd.grad(conv1_autograd(x, k7, 3, torch.float32),
                              [x, k7], g)
    want = torch.autograd.grad(conv1_reference(x, k7, 3, torch.float32),
                               [x, k7], g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())


def test_box_loss_gradient_reaches_fpn_and_backbone_on_card(cuda):
    """The autograd repair on the card: the Fast R-CNN loss of a small
    f32 model reaches the FPN maps and the backbone through the RoIAlign
    Function, never the RPN head. Against the CPU path: losses 1e-4; the
    gradient at every FPN level and of the box head 1e-4 of its largest
    entry plus 1e-9. The backbone's weight gradients of this loss alone
    are only required to be nonzero: cuDNN's and the CPU's convolution
    backward part there by up to 3% of a gradient's largest entry (res3),
    with the pyramid gradients that feed them equal to 4e-6."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.train import (generator_draws,
                                                        train_forward)
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
    cfg = load_cfg(opts=[
        "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
        "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "RPN.PRE_NMS_TOP_N_TRAIN", 100, "RPN.POST_NMS_TOP_N_TRAIN", 32,
        "RPN.BATCH_SIZE_PER_IM", 32, "FAST_RCNN.BATCH_SIZE_PER_IM", 32,
        "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 32])
    rng = np.random.default_rng(6)
    valid = np.zeros((2, 10), bool)
    valid[:, :3] = True
    batch = {"clips": torch.from_numpy(rng.normal(size=(2, 2, 64, 96, 3))
                                       .astype(np.float32)),
             "gt_boxes": torch.from_numpy(make_realistic_tubes(
                 2, 10, 2, 64, 96, seed=8)),
             "gt_keypoints": torch.zeros((2, 10, 2, 15, 3)),
             "gt_valid": torch.from_numpy(valid)}
    runs = []
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, seed=0, train=True)
        pyramid = {}

        def features(clips, inner=model.features, pyramid=pyramid):
            out = inner(clips)
            for name, level in out.items():
                level.retain_grad()
                pyramid[name] = level
            return out

        model.features = features
        b = {k: v.to(dev) for k, v in batch.items()}
        _, m = train_forward(model, b["clips"], b["gt_boxes"],
                             b["gt_keypoints"], b["gt_valid"],
                             generator_draws(0, 0))
        (m["loss_cls"] + m["loss_bbox"]).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        grads.update({k: v.grad.cpu() for k, v in pyramid.items()
                      if v.grad is not None})
        runs.append(({k: float(v) for k, v in m.items()}, grads))
    (cpu_loss, cpu), (gpu_loss, gpu) = runs
    for k, v in cpu_loss.items():
        assert abs(gpu_loss[k] - v) <= 1e-4 * max(1.0, abs(v)), k
    assert set(cpu) == set(gpu)
    for prefix in ("p2", "fpn.posthoc_p2.", "fpn.lateral_res3.",
                   "backbone.res3_", "backbone.res5_"):
        keys = [k for k in gpu if k.startswith(prefix)]
        assert keys and any(gpu[k].abs().sum() > 0 for k in keys), prefix
    assert not any(k.startswith("rpn_head.") and gpu[k].any() for k in gpu)
    for k in cpu:
        if k.startswith(("p", "box_head.")):
            tol = 1e-4 * float(cpu[k].abs().max()) + 1e-9
            assert (gpu[k] - cpu[k]).abs().max().item() <= tol, k


@pytest.mark.parametrize("p", [3, 7, 14, 16])
@pytest.mark.parametrize("variant", dr.VARIANTS)
def test_diag_pool_kernel_matches_plain(cuda, variant, p):
    """The diagnostic kernel on clipped column offsets (x1 past 72 or below
    0) and out-of-range levels, C=64: full and noswitch within the bf16
    tolerance, nodma and nodot bit for bit; one launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    maps = [torch.randn((1, 64, 136, 64), device=cuda, generator=gen).to(
        torch.bfloat16) for _ in range(4)]
    n = 37
    rois = torch.rand((4 * n,), device=cuda, generator=gen) * 100.0 - 10.0
    levels = torch.randint(-2, 6, (n,), device=cuda, generator=gen,
                           dtype=torch.int32)
    before = dr.diag_pool.launches[variant]
    got = dr.diag_pool(maps, rois, levels, p, variant)
    assert dr.diag_pool.launches[variant] == before + 1
    ref = dr.diag_pool_reference(maps, rois, levels, p, variant)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (n, p, p, 64)
    if variant in ("nodma", "nodot"):
        assert torch.equal(got, ref)
    else:
        assert (got.float() - ref.float()).abs().max().item() <= _tol(
            ref, torch.bfloat16)


def test_prefetcher_hands_batches_to_the_consumer_stream(cuda):
    """The DeviceLoader copies on its side stream; each batch handed over
    is complete on the consumer's stream (it waits on the copy's event)
    and stays intact while the allocator is pressed to reuse freed
    blocks (the batch is recorded on the consumer's stream)."""
    from detectandtrack_tpu_torch.data.pipeline import DeviceLoader
    rng = np.random.default_rng(0)
    host = [{"clips": rng.normal(size=(1, 8, 96, 160, 3)).astype(np.float32),
             "gt_valid": rng.random((1, 16)) > 0.5} for _ in range(8)]
    with DeviceLoader(iter(host), cuda, prefetch=2) as loader:
        assert loader._stream != torch.cuda.current_stream(cuda)
        for want, batch in zip(host, loader):
            assert batch["clips"].is_cuda and batch["gt_valid"].is_cuda
            churn = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
            churn.fill_(255)
            total = batch["clips"].double().sum()
            del churn
            np.testing.assert_allclose(total.item(),
                                       want["clips"].astype(np.float64).sum(),
                                       rtol=1e-9)
            np.testing.assert_array_equal(batch["gt_valid"].cpu().numpy(),
                                          want["gt_valid"])


def test_checkpoint_round_trip_of_cuda_tensors(cuda, tmp_path):
    """A TrainState on the card is saved from an owned host snapshot (an
    update right after does not reach the file) and restored onto the
    card, bit for bit."""
    from detectandtrack_tpu_torch.engine.train import TrainState
    from detectandtrack_tpu_torch.utils import checkpoint as ckpt
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {k: torch.nn.Parameter(torch.randn(s, device=cuda,
                                                generator=gen))
              for k, s in (("a.weight", (64, 32, 3, 3, 3)), ("a.bias", (64,)))}
    state = TrainState(params, {"a.weight": torch.randn(
        (64, 32, 3, 3, 3), device=cuda, generator=gen)}, 7)
    want = {k: p.detach().clone() for k, p in params.items()}
    ckpt.save_checkpoint(str(tmp_path), state, 7)
    with torch.no_grad():
        for p in params.values():
            p.mul_(2.0)
    ckpt.wait_for_checkpoints(str(tmp_path))
    fresh = TrainState({k: torch.nn.Parameter(torch.zeros_like(p))
                        for k, p in params.items()}, {}, 0)
    restored, step = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert step == 7 == restored.step
    for k in want:
        assert restored.params[k].is_cuda
        torch.testing.assert_close(restored.params[k].detach(), want[k],
                                   rtol=0, atol=0)
    assert restored.momentum["a.weight"].is_cuda
    torch.testing.assert_close(restored.momentum["a.weight"],
                               state.momentum["a.weight"], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["mean", "center"])
def test_inflated_conv1_equals_2d_conv1_through_k2(cuda, mode):
    """conv1's 2D kernel inflated to t=3 (models/inflate.py) through the
    tensor-core K2 on a time-constant clip: frames 1-6 of the 8 equal the
    2D kernel's output through K2, within the bf16 tolerance."""
    from detectandtrack_tpu_torch.models.inflate import inflate_params
    gen = torch.Generator(device=cuda).manual_seed(1)
    k2d = torch.randn((1, 7, 7, 3, 64), device=cuda, generator=gen) * 0.05
    key = "backbone.conv1.conv.weight"
    k3d = inflate_params({key: k2d}, {key: torch.empty(
        (3, 7, 7, 3, 64), device=cuda)}, mode=mode)[key]
    frame = torch.randn((1, 1, 96, 160, 3), device=cuda, generator=gen)
    before = conv1.launches_tc
    y3 = conv1(frame.expand(1, 8, 96, 160, 3).contiguous(), k3d, 3,
               torch.bfloat16)
    y1 = conv1(frame, k2d, 1, torch.bfloat16)
    assert conv1.launches_tc == before + 2
    torch.cuda.synchronize()
    ref = y1.expand(1, 6, *y1.shape[2:]).float()
    assert (y3[:, 1:7].float() - ref).abs().max().item() <= _tol(
        ref, torch.bfloat16)


@pytest.mark.parametrize("case", ["random", "chain", "ties", "nonfinite"])
@pytest.mark.parametrize("n", [1, 63, 65, 1000, 2100, 2200, 4200])
def test_nms_keep_kernel_matches_plain(cuda, n, case):
    """Score-sorted boxes → keep mask, bit for bit. Past 32 words a row
    (N > 2048) a column's rows come in runs of 32 pieces: at 2100 the
    second run holds only the diagonal piece; at 2200 (35 words) it also
    ORs pieces 32-33 (kept bits shifted by 32); at 4200 (66 words) the
    kept bits of rows past 4096 sit in a second group of 64 words."""
    from detectandtrack_tpu_torch.kernels import nms as kn
    from detectandtrack_tpu_torch.utils.synthetic import greedy_nms_case
    rng = np.random.default_rng(n)
    boxes = torch.from_numpy(np.stack(
        [greedy_nms_case(case, n, rng)[0] for _ in range(3)])).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(3, n)) > 0.1).to(cuda)
    before = kn.nms_keep.launches
    got = kn.nms_keep(boxes, valid, 0.5)
    assert kn.nms_keep.launches == before + 1
    assert torch.equal(got, kn.nms_keep_reference(boxes, valid, 0.5))


def test_nms_keep_kernel_at_its_largest_n(cuda):
    """One lane of MAX_KEEP_N boxes (512 words a row, 8 groups of 64
    kept-bit words, every ring stage a full run), bit for bit."""
    from detectandtrack_tpu_torch.kernels import nms as kn
    n = kn.MAX_KEEP_N
    rng = np.random.default_rng(3)
    x1, y1 = rng.uniform(0, 1000, n), rng.uniform(0, 1000, n)
    w, h = rng.uniform(8, 60, n), rng.uniform(8, 60, n)
    boxes = torch.from_numpy(np.stack([x1, y1, x1 + w, y1 + h], 1).astype(
        np.float32)).to(cuda)[None]
    valid = torch.from_numpy(rng.uniform(size=(1, n)) > 0.1).to(cuda)
    got = kn.nms_keep(boxes, valid, 0.5)
    ref = kn.nms_keep_reference(boxes, valid, 0.5)
    assert 0 < int(ref.sum()) < int(valid.sum())
    assert torch.equal(got, ref)


def test_nms_keep_kernel_at_the_iou_threshold(cuda):
    """102400 box pairs with IoU within 4 f32 ulps of 0.7: a fused
    multiply-add in the kernel's IoU flips some of them."""
    from detectandtrack_tpu_torch.kernels import nms as kn
    from detectandtrack_tpu_torch.utils.synthetic import iou_threshold_pairs
    boxes = torch.from_numpy(iou_threshold_pairs(
        np.random.default_rng(0), 1600, 64, 0.7)).to(cuda)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=cuda)
    got = kn.nms_keep(boxes, valid, 0.7)
    ref = kn.nms_keep_reference(boxes, valid, 0.7)
    second = ref[:, 1::2]
    assert 0 < int((~second).sum()) < second.numel()
    assert torch.equal(got, ref)


def _spread_lane(rng, n, h=800, w=1344):
    """Boxes of 16-320 px over an h x w image: few overlaps a box."""
    x1, y1 = rng.uniform(0, w - 64, n), rng.uniform(0, h - 64, n)
    bw, bh = rng.uniform(16, 320, n), rng.uniform(16, 320, n)
    boxes = np.stack([x1, y1, np.minimum(x1 + bw, w - 1),
                      np.minimum(y1 + bh, h - 1)], 1).astype(np.float32)
    return boxes, rng.uniform(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "chain", "spread"])
@pytest.mark.parametrize("method", ["linear", "gaussian"])
@pytest.mark.parametrize("n", [1, 40, 300, 700, 1000])
def test_soft_nms_confirm_kernel_matches_plain(cuda, method, n, case):
    """Bit for bit. "random" and "chain" are dense (every box overlaps
    most others: the decays stay in global memory), "spread" is sparse
    (they are cached on chip); 700 boxes stage their overlaps in pieces,
    and 1000 are past the kernel's on-chip state (column words and chunk
    products in a global scratch)."""
    from detectandtrack_tpu_torch.kernels import nms as kn
    from detectandtrack_tpu_torch.ops.boxes import bbox_overlaps
    from detectandtrack_tpu_torch.utils.synthetic import soft_nms_case
    rng = np.random.default_rng(n)
    lanes = [_spread_lane(rng, n) if case == "spread"
             else soft_nms_case(case, rng, n)[:2] for _ in range(2)]
    boxes, scores = (torch.from_numpy(np.stack([x[k] for x in lanes])).to(
        cuda) for k in range(2))
    iou = bbox_overlaps(boxes, boxes)
    dmat = (torch.where(iou > 0.3, 1.0 - iou, torch.ones_like(iou))
            if method == "linear" else torch.exp(-(iou * iou) / 0.5))
    overlaps = (dmat < 1.0) & ~torch.eye(n, dtype=torch.bool, device=cuda)
    alive = torch.from_numpy(rng.uniform(size=(2, n)) > 0.2).to(cuda)
    before = kn.soft_nms_confirm.launches
    got = kn.soft_nms_confirm(scores, dmat, overlaps, alive, -1e10)
    assert kn.soft_nms_confirm.launches == before + 1
    ref = kn.soft_nms_confirm_reference(scores, dmat, overlaps, alive, -1e10)
    assert torch.equal(got, ref)


def test_graphed_detect_equals_eager_and_counts_replays(cuda):
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.graphs import GraphedFunction
    from detectandtrack_tpu_torch.engine.inference import make_detect_fn
    from detectandtrack_tpu_torch.kernels import nms as kn
    from detectandtrack_tpu_torch.models.detector import build_model
    cfg = load_cfg(opts=[
        "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "RESNETS.WIDTH_PER_GROUP", 8, "FPN.DIM", 32,
        "FAST_RCNN.MLP_HEAD_DIM", 64, "VIDEO.VIDEO_ON", True,
        "VIDEO.NUM_FRAMES", 2, "RPN.PRE_NMS_TOP_N_TEST", 50,
        "RPN.POST_NMS_TOP_N_TEST", 16, "TEST.DETECTIONS_PER_IM", 4,
        "TEST.SCORE_THRESH", -1.0, "TEST.SHAPE_BUCKETS", "[[64, 96]]",
        "KRCNN.NUM_STACKED_CONVS", 1, "KRCNN.CONV_HEAD_DIM", 16])
    model = build_model(cfg, device=cuda, seed=0)
    detect = make_detect_fn(model)
    assert isinstance(detect, GraphedFunction)
    gen = torch.Generator(device=cuda).manual_seed(0)
    clips = [torch.randn((1, 2, 64, 96, 3), device=cuda, generator=gen)
             for _ in range(3)]
    detect(clips[0])
    before = kn.nms_keep.launches
    outs = [detect(c) for c in clips[1:]]
    assert detect.replays == 2 and kn.nms_keep.launches == before + 4
    for c, out in zip(clips[1:], outs):
        want = detect.eager(c)
        for k in want:
            assert torch.equal(out[k], want[k]), k


AFFINE_MODES = ["bias", "affine", "shortcut", "shortcut_affine", "upsampled"]
# The main path's channel counts (conv1 and res2 64, the FPN 256, the
# stages' last convs up to 2048, the RPN's 3 logits) and one that is not a
# multiple of 8.
AFFINE_CHANNELS = [64, 256, 512, 1024, 2048, 3, 20]
MAIN_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "video", "3d_R50_T8_tubes_kps.yaml")


def _affine_operands(cuda, mode, dtype, c, shape=(2, 2, 6, 10), seed=0):
    """y (shape + (c,)), scale (None for a bias-only pass), bias, and the
    shortcut, its scale and bias as `mode` asks."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*size):
        return torch.randn(size, device=cuda, generator=g)

    y = (rand(*shape, c) * 3).to(dtype)
    s, b = rand(c).abs() + 0.5, rand(c)
    r = rs = rb = None
    if mode in ("shortcut", "shortcut_affine"):
        r = (rand(*shape, c) * 3).to(dtype)
    if mode == "upsampled":
        r = (rand(*shape[:-2], shape[-2] // 2, shape[-1] // 2, c) * 3).to(
            dtype)
    if mode == "shortcut_affine":
        rs, rb = rand(c).abs() + 0.5, rand(c)
    return y, (None if mode == "bias" else s), b, r, rs, rb


def _affine_equal(y, s, b, r, rs, rb, relu):
    want = ka.affine_epilogue_reference(y.clone(), s, b, r, rs, rb, relu)
    before = ka.affine_epilogue.launches
    got = ka.affine_epilogue(y, s, b, r, rs, rb, relu)
    assert ka.affine_epilogue.launches == before + 1 and got is y
    torch.cuda.synchronize()
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("mode", AFFINE_MODES)
def test_affine_kernel_matches_plain(cuda, mode, relu, dtype):
    """Bit for bit, at every channel count of AFFINE_CHANNELS."""
    for c in AFFINE_CHANNELS:
        assert _affine_equal(*_affine_operands(cuda, mode, dtype, c),
                             relu), (mode, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["shortcut_affine", "upsampled"])
def test_affine_kernel_matches_plain_at_a_main_path_size(cuda, mode, dtype):
    """P3 of one clip (8 x 100 x 168 x 256): many trips of the grid-stride
    loop."""
    assert _affine_equal(*_affine_operands(cuda, mode, dtype, 256,
                                           (1, 8, 100, 168)), True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_kernel_on_unaligned_operands(cuda, dtype):
    """A y and a shortcut 16-byte unaligned take the one-channel path."""
    y, s, b, r, rs, rb = _affine_operands(cuda, "shortcut_affine", dtype, 64)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16
        return out

    assert _affine_equal(unaligned(y), s, b, unaligned(r), rs, rb, True)


def test_affine_kernel_rejects_what_it_cannot_take(cuda):
    y, s, b, r, rs, rb = _affine_operands(cuda, "shortcut_affine",
                                          torch.float32, 8)
    with pytest.raises(TypeError, match="dtype"):
        ka.affine_epilogue(y.half(), s, b)
    with pytest.raises(ValueError, match="contiguous"):
        ka.affine_epilogue(y.transpose(1, 2), s, b)
    with pytest.raises(ValueError, match="scale"):
        ka.affine_epilogue(y, s.double(), b)
    with pytest.raises(ValueError, match="bias"):
        ka.affine_epilogue(y, s, b[:4].contiguous())
    with pytest.raises(ValueError, match="shortcut"):
        ka.affine_epilogue(y, s, b, r.transpose(1, 2))
    with pytest.raises(ValueError, match="shortcut"):
        ka.affine_epilogue(y, s, b, r.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shortcut"):
        ka.affine_epilogue(y, s, b, r[:, :, :5].contiguous())
    with pytest.raises(ValueError, match="together"):
        ka.affine_epilogue(y, s, b, r, rs, None)
    wide = torch.zeros((2, 1026), device=cuda)     # 1026 groups of 1
    with pytest.raises(ValueError, match="groups"):
        ka.affine_epilogue(wide, None, torch.zeros(1026, device=cuda))


def _main_model(cuda, opts, train=False):
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.models.detector import build_model
    cfg = load_cfg(MAIN_CFG, opts=["TEST.SHAPE_BUCKETS", "[[128, 192]]"]
                   + opts)
    return cfg, build_model(cfg, device=cuda, seed=0, train=train)


def test_graphed_detect_makes_one_affine_launch_a_site(cuda):
    """The main config at 128 x 192, graphed as the bench runs it: the
    warm-up (then the capture) and a replay each add the sites
    `epilogue_sites` counts from the model's modules."""
    from detectandtrack_tpu_torch.engine.inference import make_detect_fn
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
    from test_torch_affine import epilogue_sites
    cfg, model = _main_model(cuda, [])
    detect = make_detect_fn(model, with_proposals=True, run_rpn=True)
    t = cfg.VIDEO.NUM_FRAMES
    gen = torch.Generator(device=cuda).manual_seed(0)
    clip = torch.randn((1, t, 128, 192, 3), device=cuda, generator=gen)
    tubes = torch.as_tensor(make_realistic_tubes(
        1, cfg.RPN.POST_NMS_TOP_N_TEST, t, 128, 192), device=cuda)
    sites = epilogue_sites(model)
    for _ in range(2):
        before = ka.affine_epilogue.launches
        detect(clip, tubes)
        torch.cuda.synchronize()
        assert ka.affine_epilogue.launches == before + sites
    assert detect.replays == 1


@pytest.mark.parametrize("clip_norm", [10.0, 0.0])
def test_training_step_affine_launches(cuda, clip_norm):
    """A training step of the main config: none with the global-norm clip
    (every parameter needs its gradient), one a site of the frozen conv1
    and res2 without it."""
    from detectandtrack_tpu_torch.engine import train as ttrain
    from detectandtrack_tpu_torch.utils.synthetic import (
        make_realistic_tubes, train_batch)
    cfg, model = _main_model(cuda, ["SOLVER.CLIP_GRAD_NORM", clip_norm,
                                    "SOLVER.BASE_LR", 1e-4], train=True)
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_train_step(model, cfg)
    t = cfg.VIDEO.NUM_FRAMES
    batch = train_batch(np.random.default_rng(0), make_realistic_tubes(
        1, 4, t, 128, 192, seed=1), [2], (128, 192))
    before = ka.affine_epilogue.launches
    step(state, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    res2 = [n for n, _ in model.backbone.named_children()
            if n.startswith("res2_")]
    frozen = 1 + 3 * len(res2) if cfg.RESNETS.FREEZE_AT >= 2 else 0
    assert ka.affine_epilogue.launches - before == (
        0 if clip_norm > 0 else frozen)
