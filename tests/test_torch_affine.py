"""The conv epilogue in one pass (`kernels/affine.py`) on the CPU: its plain
version against the op chain the sites ran before, the model's modules
without a gradient (one pass after each conv) against the same modules with
one (the op chain), the gradients of the chain, and which calls take the
pass. No JAX here: `test_torch_cuda.py` imports `epilogue_sites`."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.engine import train as ttrain
from detectandtrack_tpu_torch.engine.inference import make_detect_fn
from detectandtrack_tpu_torch.kernels import affine
from detectandtrack_tpu_torch.models.backbone import (
    BasicBlock, Bottleneck, Conv3d, ConvAffine, ResNet, conv_epilogue)
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.models.fpn import FPN, upsample_nearest_2x
from detectandtrack_tpu_torch.models.heads import (KeypointHead, MaskHead,
                                                   Res5BoxHead)
from detectandtrack_tpu_torch.models.rpn import RPNHead
from detectandtrack_tpu_torch.utils.synthetic import (make_realistic_tubes,
                                                      train_batch)

MODES = ["bias", "affine", "shortcut", "shortcut_affine", "upsampled"]
DTYPES = [torch.float32, torch.bfloat16]
SMALL_OPTS = [
    "MODEL.CONV_BODY", "resnet50", "RESNETS.WIDTH_PER_GROUP", 4,
    "FPN.DIM", 16, "FAST_RCNN.MLP_HEAD_DIM", 32, "VIDEO.VIDEO_ON", True,
    "VIDEO.NUM_FRAMES", 2, "VIDEO.TIME_KERNEL_DIM", "[3, 3, 3, 3, 1]",
    "RPN.PRE_NMS_TOP_N_TEST", 50, "RPN.POST_NMS_TOP_N_TEST", 16,
    "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
    "TEST.SHAPE_BUCKETS", "[[64, 96]]", "KRCNN.NUM_STACKED_CONVS", 2,
    "KRCNN.CONV_HEAD_DIM", 16]


def epilogue_sites(model) -> int:
    """The epilogue passes one detect call of an FPN keypoint model makes,
    from its modules: conv1; each block's convs (a, b, c; a, b), the
    projection's affine riding on the last; every FPN conv (each has a
    bias); the RPN head's convs on every level it runs on; the keypoint
    head's convs."""
    cfg = model.cfg
    blocks = [m for m in model.backbone.modules()
              if isinstance(m, (Bottleneck, BasicBlock))]
    n = 1 + sum(3 if isinstance(m, Bottleneck) else 2 for m in blocks)
    n += sum(isinstance(m, Conv3d) for m in model.fpn.modules())
    levels = cfg.FPN.RPN_MAX_LEVEL - cfg.FPN.RPN_MIN_LEVEL + 1
    n += levels * sum(isinstance(m, Conv3d) for m in model.rpn_head.modules())
    return n + model.kps_head.num_convs


@pytest.fixture
def passes(monkeypatch):
    """Counts the plain version's calls (what a CPU tensor runs)."""
    calls = [0]
    plain = affine.affine_epilogue_reference

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(affine, "affine_epilogue_reference", counted)
    return calls


def _operands(mode, dtype, c=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn((2, 3, 6, 10, c), generator=g) * 3).to(dtype)
    s = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g)
    r = rs = rb = None
    if mode in ("shortcut", "shortcut_affine"):
        r = (torch.randn(y.shape, generator=g) * 3).to(dtype)
    if mode == "upsampled":
        r = (torch.randn((2, 3, 3, 5, c), generator=g) * 3).to(dtype)
    if mode == "shortcut_affine":
        rs, rb = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)
    return y, (None if mode == "bias" else s), b, r, rs, rb


def _chain(y, s, b, r, rs, rb, relu):
    """The ops the sites ran before, as the modules wrote them."""
    dt = y.dtype
    v = y * s.to(dt) + b.to(dt) if s is not None else y + b.to(dt)
    if r is not None:
        if r.shape != y.shape:
            r = upsample_nearest_2x(r)
        v = v + (r * rs.to(dt) + rb.to(dt) if rs is not None else r)
    return F.relu(v) if relu else v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_plain_equals_the_op_chain(mode, relu, dtype):
    """Bit for bit, at C = 64 and at C = 3 (the RPN's logits)."""
    for c in (64, 3):
        y, s, b, r, rs, rb = _operands(mode, dtype, c)
        want = _chain(y, s, b, r, rs, rb, relu)
        got = affine.affine_epilogue(y.clone(), s, b, r, rs, rb, relu)
        assert got.dtype == dtype and torch.equal(got, want), (mode, c)


def test_plain_writes_over_y_and_checks_the_shortcut_shape():
    y, s, b, _, _, _ = _operands("affine", torch.float32)
    out = affine.affine_epilogue(y, s, b, relu=True)
    assert out is y and (y >= 0).all()
    with pytest.raises(ValueError, match="shortcut"):
        affine.affine_epilogue(y, s, b, torch.zeros((2, 3, 6, 5, 64)))


def test_wants_grad():
    x = torch.zeros(2)
    p = torch.nn.Parameter(torch.zeros(2))
    assert affine.wants_grad(x, params=[p])
    assert not affine.wants_grad(x, None, params=[p.detach()])
    assert affine.wants_grad(None, p)
    with torch.no_grad():
        assert not affine.wants_grad(x, params=[p])
    with torch.inference_mode():
        assert not affine.wants_grad(p)


def _init(module, seed=0):
    """Non-trivial weights: random convs, affine scales near 1, biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.2, generator=g)
            elif name.endswith("scale"):
                p.uniform_(0.5, 1.5, generator=g)
            else:
                p.normal_(0.0, 0.3, generator=g)
    return module


def _module_case(name, dtype):
    """(module, its input, the epilogue passes one call makes)."""
    g = torch.Generator().manual_seed(1)

    def x(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    kw = dict(time_kernel=3, dtype=dtype)
    if name == "bottleneck_proj":
        return Bottleneck(16, 8, 32, spatial_stride=2, **kw), x(2, 3, 8, 10,
                                                                  16), 3
    if name == "bottleneck":
        return Bottleneck(32, 8, 32, **kw), x(2, 3, 8, 10, 32), 3
    if name == "basic_proj":
        return BasicBlock(16, 24, 24, spatial_stride=2, **kw), x(
            2, 3, 8, 10, 16), 2
    if name == "basic":
        return BasicBlock(24, 24, 24, **kw), x(2, 3, 8, 10, 24), 2
    if name == "resnet":
        m = ResNet("resnet18", (3, 1, 1, 1, 1), width_per_group=8,
                   dtype=dtype)
        return m, x(1, 2, 32, 48, 3), 1 + 8 * 2
    if name == "fpn":
        dims = {"res2": 8, "res3": 16, "res4": 24, "res5": 32}
        feats = {f"res{i + 2}": x(1, 2, 16 // 2 ** i, 24 // 2 ** i, d)
                 for i, d in enumerate(dims.values())}
        return FPN(dims, dim=16, extra_conv_levels=True, dtype=dtype), \
            feats, 9
    if name == "rpn_head":
        return RPNHead(16, 16, num_frames=2, dtype=dtype), x(
            1, 2, 10, 12, 16), 3
    if name == "kps_head":
        return KeypointHead(16, num_convs=3, conv_dim=24, dtype=dtype), x(
            3, 2, 7, 7, 16), 3
    if name == "mask_head":
        return MaskHead(16, dim=24, dtype=dtype), x(3, 2, 7, 7, 16), 4
    if name == "res5_head":
        return Res5BoxHead(16, width=8, num_frames=2, dtype=dtype), x(
            3, 2, 7, 7, 16), 9
    raise ValueError(name)


MODULES = ["bottleneck_proj", "bottleneck", "basic_proj", "basic", "resnet",
           "fpn", "rpn_head", "kps_head", "mask_head", "res5_head"]


def _tensors(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MODULES)
def test_module_without_grad_equals_the_op_chain(name, dtype, passes):
    """Under inference mode each module makes one pass after each conv and
    equals, bit for bit, its own forward with a gradient (the op chain:
    no pass)."""
    module, inp, sites = _module_case(name, dtype)
    _init(module)
    want = [t.detach() for t in _tensors(module(inp))]
    assert passes[0] == 0
    with torch.inference_mode():
        got = _tensors(module(inp))
    assert passes[0] == sites
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _chain_block(block, x):
    """A block's forward written out as the chain of its convs' raw outputs,
    frozen-BN affines, adds and ReLUs."""
    def bn(ca, y):
        return y * ca.bn.scale + ca.bn.bias

    if block.proj is not None:
        shortcut = bn(block.proj, block.proj.conv(x))
    else:
        shortcut = x
    convs = [block.a, block.b] + ([block.c] if hasattr(block, "c") else [])
    y = x
    for ca in convs[:-1]:
        y = F.relu(bn(ca, ca.conv(y)))
    return F.relu(bn(convs[-1], convs[-1].conv(y)) + shortcut)


@pytest.mark.parametrize("name", ["bottleneck_proj", "basic", "fpn",
                                  "kps_head"])
def test_gradients_are_the_op_chains(name, passes):
    """With a gradient the modules run the chain: no pass, and the same
    gradients as the chain written out (blocks) or as the chain's pieces
    called alone (FPN, keypoint head), bit for bit."""
    module, inp, _ = _module_case(name, torch.float32)
    _init(module)
    params = list(module.parameters())

    def grads(fn):
        out = _tensors(fn())
        g = torch.Generator().manual_seed(3)
        loss = sum((o * torch.randn(o.shape, generator=g)).sum()
                   for o in out)
        return torch.autograd.grad(loss, params, allow_unused=True)

    if name in ("bottleneck_proj", "basic"):
        reference = (lambda: _chain_block(module, inp))
    elif name == "fpn":
        def reference():
            td = module.lateral_res5(inp["res5"])
            outs = {"p5": td}
            for i, n in ((2, "res4"), (1, "res3"), (0, "res2")):
                td = getattr(module, f"lateral_{n}")(inp[n]) + \
                    upsample_nearest_2x(td)
                outs[f"p{i + 2}"] = td
            for lvl in ("p2", "p3", "p4", "p5"):
                outs[lvl] = getattr(module, f"posthoc_{lvl}")(outs[lvl])
            outs["p6"] = module.extra_p6(outs["p5"])
            return outs
    else:
        def reference():
            r, t, p, _, c = inp.shape
            x = inp.reshape(r * t, 1, p, p, c)
            for i in range(module.num_convs):
                x = F.relu(getattr(module, f"conv_fcn{i + 1}")(x))
            x = x[:, 0].float().permute(0, 3, 1, 2)
            return module.kps_score_lowres(x).permute(0, 2, 3, 1).reshape(
                r, t, 2 * p, 2 * p, module.num_keypoints)

    got = grads(lambda: module(inp))
    want = grads(reference)
    assert passes[0] == 0
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_epilogue_arguments_need_no_gradient(passes):
    """A conv's `relu` and `shortcut` are its one pass only where no
    gradient is needed; with one they run as the op chain. `conv_epilogue`
    equals the chain either way, a projection's affine riding in the
    pass."""
    conv = _init(Conv3d(4, 4, use_bias=True))
    x = torch.randn((1, 1, 5, 5, 4))
    want = F.relu(conv(x) + x)
    assert torch.equal(conv(x, relu=True, shortcut=x), want)
    assert passes[0] == 0
    with torch.no_grad():
        assert torch.equal(conv(x, relu=True, shortcut=x), want)
    assert passes[0] == 1
    ca, proj = _init(ConvAffine(4, 4)), _init(ConvAffine(4, 4), seed=1)
    want = F.relu(ca(x) + proj(x))
    assert torch.equal(
        conv_epilogue(ca, x, relu=True, shortcut=x, proj=proj), want)
    assert passes[0] == 1
    with torch.no_grad():
        assert torch.equal(
            conv_epilogue(ca, x, relu=True, shortcut=x, proj=proj), want)
    assert passes[0] == 2


def test_detect_makes_one_pass_a_site(passes):
    """One detect call of a small R-50 keypoint model makes exactly the
    passes `epilogue_sites` counts from its modules."""
    cfg = load_cfg(opts=SMALL_OPTS)
    model = build_model(cfg, device="cpu", seed=0)
    clip = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 64, 96, 3)).astype(np.float32))
    tubes = torch.as_tensor(make_realistic_tubes(
        1, cfg.RPN.POST_NMS_TOP_N_TEST, 2, 64, 96))
    make_detect_fn(model, with_proposals=True, run_rpn=True)(clip, tubes)
    assert passes[0] == epilogue_sites(model) == 1 + 16 * 3 + 8 + 5 * 3 + 2


@pytest.mark.parametrize("clip_norm,frozen_pass", [(10.0, False),
                                                   (0.0, True)])
def test_training_step_passes_only_where_nothing_needs_a_gradient(
        clip_norm, frozen_pass, passes):
    """A training step with every parameter requiring a gradient (the
    global-norm clip reads the frozen stages' too) makes no pass; without
    the clip the frozen conv1 and res2 need none, and each of their sites
    makes one."""
    cfg = load_cfg(opts=SMALL_OPTS + ["SOLVER.CLIP_GRAD_NORM", clip_norm,
                                      "RESNETS.FREEZE_AT", 2])
    model = build_model(cfg, device="cpu", seed=0, train=True)
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_train_step(model, cfg)
    batch = train_batch(np.random.default_rng(0), make_realistic_tubes(
        1, 4, 2, 64, 96, seed=1), [2], (64, 96))
    step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    res2 = [m for n, m in model.backbone.named_children()
            if n.startswith("res2_")]
    assert passes[0] == (1 + 3 * len(res2) if frozen_pass else 0)
