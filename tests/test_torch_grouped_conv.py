"""The grouped 3x3 conv with its epilogue (`kernels/grouped_conv.py`) and the
ResNeXt-101 64x4d configuration of the benchmark, on the CPU.

- The kernel's plain version equals F.conv2d with groups + the op chain
  (the module path with a gradient) bit for bit in f32.
- `takes` routes only grouped 3x3 convs of the kernel's widths on a bf16
  CUDA tensor: no conv of the main config, none on the CPU; building a
  model builds no kernel.
- The grouped reference (`benchmark/reference/resnext.py`) at one group
  with the stride on the 1x1 equals the frozen reference bit for bit; at a
  narrow X-101 the port's detect equals it on one seeded dict of weights.
- The kernel's name is read by neither the conv nor the elementwise reader
  of the benchmark; the configuration is the YAML as `load_cfg` resolves
  it but for the keys it states.
"""

import copy
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.drivers.offline_infer_x101 import make_weights
from benchmark.manifest import flatten_cfg
from benchmark.reference import model as ref_model
from benchmark.reference import resnext
from benchmark.reference.model import f32_mode
from benchmark.roofline_grouped import grouped_conv_work, sites
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.engine.inference import make_detect_fn
from detectandtrack_tpu_torch.kernels import grouped_conv as gc
from detectandtrack_tpu_torch.models.backbone import ConvAffine, _chain
from detectandtrack_tpu_torch.models.detector import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def _bench_cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def _small(cfg, frames):
    """The benchmark configuration cut to `frames` frames, 64 x 96 images
    and few rois (widths as they are)."""
    c = copy.deepcopy(cfg)
    c["VIDEO"]["NUM_FRAMES"] = frames
    c["MODEL"]["COMPUTE_DTYPE"] = "float32"
    c["RPN"]["POST_NMS_TOP_N_TEST"] = 30
    c["TEST"].update(DETECTIONS_PER_IM=10, SHAPE_BUCKETS=[[64, 96]])
    c["KRCNN"]["MAX_ROIS_PER_IM"] = 4
    return c


@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("stride,hw", [(1, (9, 13)), (2, (9, 13)),
                                       (2, (8, 12)), (1, (5, 1))])
@pytest.mark.parametrize("cg", [4, 8, 16, 32])
def test_plain_version_is_the_module_chain(cg, stride, hw, shortcut):
    c = 2 * cg * 4
    gen = torch.Generator().manual_seed(cg * 10 + stride)
    m = ConvAffine(c, c, (1, 3, 3), (1, stride, stride), groups=c // cg)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(generator=gen)
    x = torch.randn((2, 1) + hw + (c,), generator=gen)
    r = None
    if shortcut:
        ho, wo = [(v - 1) // stride + 1 for v in hw]
        r = torch.randn((2, 1, ho, wo, c), generator=gen)
    with torch.no_grad():
        got = gc.grouped_conv3x3_reference(x, m.conv.weight, m.bn.scale,
                                           m.bn.bias, stride, r, relu=True)
    want = _chain(m.bn(m.conv(x)), True, r)
    assert got.shape == want.shape and torch.equal(got, want.detach())


class _OnCard:
    """A stand-in for a bf16 CUDA activation of a shape (what `takes`
    reads)."""
    is_cuda = True
    dtype = torch.bfloat16

    def __init__(self, shape):
        self.shape = torch.Size(shape)


@pytest.mark.parametrize("cg,stride,want", [
    (4, 1, True), (8, 2, True), (16, 1, True), (32, 1, True),
    (32, 2, True), (2, 1, False)])
def test_takes_routes_the_grouped_sites_of_routed(cg, stride, want):
    c = 64 * cg if cg > 2 else 128
    m = ConvAffine(c, c, (1, 3, 3), (1, stride, stride), groups=c // cg)
    assert gc.takes(m.conv, _OnCard((2, 1, 16, 16, c))) is want
    cpu = torch.zeros((2, 1, 16, 16, c), dtype=torch.bfloat16)
    assert not gc.takes(m.conv, cpu)


def test_takes_no_conv_of_the_main_config():
    cfg = load_cfg(os.path.join(REPO, "configs", "video",
                                "3d_R50_T8_tubes_kps.yaml"))
    model = build_model(cfg, device="meta")
    convs = [m.conv for m in model.modules() if isinstance(m, ConvAffine)]
    assert convs and not any(
        gc.takes(cv, _OnCard((1, 8, 32, 32, cv.weight.shape[0])))
        for cv in convs)


def test_one_group_equals_the_frozen_reference():
    """Features, candidates and heatmaps bit for bit at r50_t8's
    configuration (one group, stride on the 1x1), T = 2 at 64 x 96."""
    cfg = _small(_bench_cfg("r50_t8")["cfg"], 2)
    assert resnext.param_spec(cfg) == ref_model.param_spec(cfg)
    params = inputs.make_weights(cfg, 2 ** 33 + 7, "cpu")
    clips = inputs.make_clips(5, 0, (1, 2, 64, 96, 3), "cpu")
    tubes = torch.as_tensor(inputs.make_realistic_tubes(1, 30, 2, 64, 96, 3))
    outs = []
    with torch.no_grad(), f32_mode():
        for det in (ref_model.Detector(cfg, params),
                    resnext.Detector(cfg, params)):
            pyr = det.features(clips)
            cand = det.candidates(pyr, tubes, (64.0, 96.0))
            outs.append([pyr[k] for k in sorted(pyr)] + list(cand)
                        + [det.heatmaps(pyr, cand[0][:, :4])])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_port_equals_the_grouped_reference_at_a_narrow_x101():
    """NUM_GROUPS 4 of width 4, the stride on the 3x3, one frame of 64 x 96,
    f32: the port's detect entry against the reference's, on one seeded
    dict of weights (tests/test_golden.py's tolerances)."""
    cfg = _small(_bench_cfg("x101_64x4d")["cfg"], 1)
    cfg["RESNETS"].update(NUM_GROUPS=4, WIDTH_PER_GROUP=4)
    assert not cfg["RESNETS"]["STRIDE_1X1"]
    params = make_weights(cfg, 2 ** 34 + 3, "cpu")
    model = build_model(load_cfg(opts=flatten_cfg(cfg)), device="meta")
    model = model.to_empty(device="cpu")
    model.load_state_dict(params)
    detect = make_detect_fn(model.eval(), with_proposals=True, run_rpn=True)
    clips = inputs.make_clips(9, 0, (2, 1, 64, 96, 3), "cpu")
    tubes = torch.as_tensor(inputs.make_realistic_tubes(2, 30, 1, 64, 96, 4))
    got = detect(clips, tubes)
    with torch.no_grad(), f32_mode():
        ref = resnext.Detector(cfg, params).detect(clips, tubes)
    v = ref["valid"]
    assert v.sum() > 4 and torch.equal(got["valid"], v)
    for k, tol in (("scores", 1e-4), ("boxes", 1e-2), ("keypoints", 1e-2)):
        np.testing.assert_allclose(got[k][v].numpy(), ref[k][v].numpy(),
                                   atol=tol, rtol=1e-4, err_msg=k)


def _pattern(metric):
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PATTERN


@pytest.mark.parametrize("metric", ["conv_gemm_ms_per_clip.infer",
                                    "elementwise_ms_per_clip.infer"])
def test_kernel_name_is_read_by_neither_time_reader(metric):
    """The name as the profiler shows it: the template's demangled name."""
    shown = (f"void (anonymous namespace)::{gc.KERNEL_NAME}<16, 1>("
             "CUtensorMap_st, float const*, float const*, float const*, "
             "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, "
             "int, int)")
    assert not re.search(_pattern(metric), shown)
    with open(os.path.join(REPO, "detectandtrack_tpu_torch", "csrc",
                           "grouped_conv.cu")) as f:
        assert f"{gc.KERNEL_NAME}(" in f.read()


def test_config_is_the_yaml_but_the_stated_keys():
    doc = _bench_cfg("x101_64x4d")
    cfg = load_cfg(os.path.join(REPO, doc["derived_from"]))
    stated = {("RESNETS", "STRIDE_1X1"): False,
              ("VIDEO", "TIME_KERNEL_DIM"): [1, 1, 1, 1, 1],
              ("MODEL", "COMPUTE_DTYPE"): "bfloat16"}
    for group, vals in doc["cfg"].items():
        if not isinstance(vals, dict):
            assert getattr(cfg, group) == vals
            continue
        for k, v in vals.items():
            want = getattr(getattr(cfg, group), k)
            want = json.loads(json.dumps(want))          # tuples → lists
            assert v == stated.get((group, k), want), (group, k)


def test_grouped_sites_and_their_bound():
    """The body's 33 grouped sites at 16 frames of 800 x 1344, with the
    stage shapes of the stride on the 3x3."""
    cfg = _bench_cfg("x101_64x4d")["cfg"]
    got = sites(cfg, 16, (800, 1344))
    assert len(got) == 33
    assert got[0] == ((16, 200, 336, 256), 64, 1)
    assert got[3] == ((16, 200, 336, 512), 64, 2)
    assert got[-3] == ((16, 50, 84, 2048), 64, 2)
    assert got[-1] == ((16, 25, 42, 2048), 64, 1)
    w = grouped_conv_work((16, 50, 84, 1024), 64, 1)
    assert w.kind == "bf16" and w.flops == 2.0 * 16 * 50 * 84 * 1024 * 144
    assert w.n_bytes == 2 * (2 * 16 * 50 * 84 * 1024) + (1024 * 16 * 9
                                                         + 2048) * 4


def test_building_a_model_builds_no_kernel(monkeypatch):
    """The grouped kernel is built at its first launch, alone: building a
    model, grouped or not, compiles and loads nothing."""
    from detectandtrack_tpu_torch.kernels import _build
    asked = []
    monkeypatch.setattr(_build, "build", asked.append)
    monkeypatch.setattr(_build, "load_library", asked.append)
    for name in ("3d_R50_T8_tubes_kps", "2d_X101_64x4d_FPN_kps"):
        build_model(load_cfg(os.path.join(REPO, "configs", "video",
                                          f"{name}.yaml")), device="meta")
    assert asked == []
