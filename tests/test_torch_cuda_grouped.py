"""The grouped 3x3 conv kernel (`kernels/grouped_conv.py`) on a CUDA card:
against its plain version and an f64 conv at the ResNeXt-101 64x4d body's
stage shapes, its epilogue bit for bit against the op chain, and its
launches on the graphed detect of the X-101 and of the main config.

Skipped without a card. On the card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_cuda_grouped.py
"""

import os

import pytest
import torch
import torch.nn.functional as F

from detectandtrack_tpu_torch.kernels import affine as ka
from detectandtrack_tpu_torch.kernels import grouped_conv as gc

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X101_CFG = os.path.join(REPO, "configs", "video", "2d_X101_64x4d_FPN_kps.yaml")
MAIN_CFG = os.path.join(REPO, "configs", "video", "3d_R50_T8_tubes_kps.yaml")

# (channels, stride, H, W) at 64 groups: the X-101 64x4d body's sites on an
# 800 x 1344 frame (each stage's stride-1 site and the stride-2 first sites
# of res3-res5), and odd sizes.
STAGE_SHAPES = [(256, 1, 200, 336), (512, 1, 100, 168), (1024, 1, 50, 84),
                (2048, 1, 25, 42), (512, 2, 200, 336), (1024, 2, 100, 168),
                (2048, 2, 50, 84)]
ODD_SHAPES = [(256, 1, 13, 37), (512, 2, 9, 17), (1024, 1, 5, 3),
              (2048, 2, 7, 1), (512, 1, 33, 19)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, c, h, w, n=2, seed=0, shortcut=False, stride=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((n, 1, h, w, c), device=cuda, generator=g).to(
        torch.bfloat16)
    cg = c // 64
    wt = torch.randn((c, cg, 1, 3, 3), device=cuda, generator=g) * (
        2.0 / (9 * cg)) ** 0.5
    s = torch.rand(c, device=cuda, generator=g) + 0.5
    b = torch.randn(c, device=cuda, generator=g) * 0.5
    r = None
    if shortcut:
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        r = torch.randn((n, 1, ho, wo, c), device=cuda, generator=g).to(
            torch.bfloat16)
    return x, wt, s, b, r


@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("c,stride,h,w", STAGE_SHAPES + ODD_SHAPES)
def test_grouped_kernel_matches_plain(cuda, c, stride, h, w, shortcut):
    """The conv (scale 1, bias 0, no ReLU: the rounded sums alone) within
    half a bf16 ulp of an f64 conv, plus the f32 summation's bound (9 · CG
    ≤ 288 terms, 2^-15 of their magnitudes' sum); the plain version (cuDNN
    in bf16) within a conv tolerance; the epilogue on the kernel's own conv
    output bit for bit the op chain's."""
    n = 2 if h * w <= 100 * 168 else 1
    x, wt, s, b, r = _operands(cuda, c, h, w, n, shortcut=shortcut,
                               stride=stride)
    ones, zeros = torch.ones_like(s), torch.zeros_like(b)
    before = gc.grouped_conv3x3.launches
    y0 = gc.grouped_conv3x3(x, wt, ones, zeros, stride)
    got = gc.grouped_conv3x3(x, wt, s, b, stride, r, relu=True)
    assert gc.grouped_conv3x3.launches == before + 2
    torch.cuda.synchronize()
    xd = x[:, 0].permute(0, 3, 1, 2).double()
    wd = wt[:, :, 0].to(torch.bfloat16).double()
    exact, mag = (F.conv2d(a, k, None, stride, 1, 1, 64).permute(
        0, 2, 3, 1)[:, None] for a, k in ((xd, wd), (xd.abs(), wd.abs())))
    assert y0.shape == exact.shape
    err = (y0.double() - exact).abs()
    assert (err <= 2.0 ** -8 * exact.abs() + 2.0 ** -15 * mag).all(), (
        err.max().item())
    chain = ka.affine_epilogue_reference(y0.clone(), s, b, r, relu=True)
    assert torch.equal(got, chain)
    plain = gc.grouped_conv3x3_reference(x, wt, s, b, stride, r, relu=True)
    tol = 2.0 ** -6 * max(1.0, plain.float().abs().max().item())
    assert (got.float() - plain.float()).abs().max().item() <= tol


def test_grouped_kernel_rejects_what_it_cannot_take(cuda):
    x, wt, s, b, _ = _operands(cuda, 256, 8, 8)
    with pytest.raises(ValueError):
        gc.grouped_conv3x3(x.float(), wt, s, b, 1)
    with pytest.raises(ValueError):
        gc.grouped_conv3x3(x.transpose(2, 3), wt, s, b, 1)
    with pytest.raises(ValueError):
        gc.grouped_conv3x3(x, wt, s, b, 3)
    with pytest.raises(ValueError):
        gc.grouped_conv3x3(x, wt[:, :2].contiguous(), s, b, 1)
    with pytest.raises(ValueError):
        gc.grouped_conv3x3(x, wt, s, b, 1, shortcut=x[:, :, :4])


def _graphed_launches(cuda, cfg_path, opts):
    """(grouped kernel launches, epilogue passes) of a warm-up and of a
    replay of the config's graphed detect at 128 x 192, the model, and its
    grouped 3x3 sites."""
    from detectandtrack_tpu_torch.core.config import load_cfg
    from detectandtrack_tpu_torch.engine.inference import make_detect_fn
    from detectandtrack_tpu_torch.models.backbone import Bottleneck
    from detectandtrack_tpu_torch.models.detector import build_model
    from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
    cfg = load_cfg(cfg_path, opts=["TEST.SHAPE_BUCKETS", "[[128, 192]]"]
                   + opts)
    model = build_model(cfg, device=cuda, seed=0)
    detect = make_detect_fn(model, with_proposals=True, run_rpn=True)
    t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
    gen = torch.Generator(device=cuda).manual_seed(0)
    clip = torch.randn((2, t, 128, 192, 3), device=cuda, generator=gen)
    tubes = torch.as_tensor(make_realistic_tubes(
        2, cfg.RPN.POST_NMS_TOP_N_TEST, t, 128, 192), device=cuda)
    counts = []
    for _ in range(2):
        before = (gc.grouped_conv3x3.launches, ka.affine_epilogue.launches)
        detect(clip, tubes)
        torch.cuda.synchronize()
        counts.append((gc.grouped_conv3x3.launches - before[0],
                       ka.affine_epilogue.launches - before[1]))
    assert detect.replays == 1
    blocks = [m for m in model.backbone.modules()
              if isinstance(m, Bottleneck) and m.b.conv.groups > 1]
    return counts, model, len(blocks)


def test_graphed_x101_detect_launches_it_once_a_routed_site(cuda):
    """Each of the 33 grouped 3x3 sites takes the kernel in place of its
    epilogue pass."""
    from test_torch_affine import epilogue_sites
    counts, model, grouped = _graphed_launches(
        cuda, X101_CFG, ["RESNETS.STRIDE_1X1", False])
    assert grouped == 33
    assert counts == [(33, epilogue_sites(model) - 33)] * 2


def test_graphed_main_detect_launches_it_never(cuda):
    from test_torch_affine import epilogue_sites
    counts, model, grouped = _graphed_launches(cuda, MAIN_CFG, [])
    assert grouped == 0
    assert counts == [(0, epilogue_sites(model))] * 2
