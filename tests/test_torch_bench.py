"""The port's bench (`detectandtrack_tpu_torch/bench.py`) against the root
bench.py, and its FLOP count (`utils/flops.py`), on the CPU.

(a) For each mode, the opts each bench passes to its package's `load_cfg`
    are equal, and so are the two configs, field by field (both loaders
    replaced by a recorder that stops the bench).
(b) Each mode at a small size (R-18 narrowed, T=2, 64x96, B=1, one
    iteration, 4 frames a video) on `device="cpu"` prints one JSON line
    whose keys are bench.py's for that mode (read from its source) plus
    `card` and `flops_source`; its numbers are finite, and its MFU, a
    device metric, is null.
(c) `count_flops` on a narrow model equals an independent sum: 2·MACs of
    every conv and linear layer from forward hooks, plus `utils/roofline`'s
    FLOPs for each conv1 and RoIAlign call; the count is the same when
    those calls compute nothing torch can count (as their kernels do on
    the card), a forward + backward counts each part once, and the
    diagnostic kernel's call counts its roofline work in every variant.
(d) The stream percentiles drop the first frames by dispatch order.
(e) `launch --mode bench --device cpu` runs at the small size; with the
    default device and no CUDA the bench raises after its error line."""

import ast
import dataclasses
import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

import bench as jbench
import detectandtrack_tpu.core.config as jconfig
from detectandtrack_tpu_torch import bench as tbench
from detectandtrack_tpu_torch.cli import launch as tlaunch
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.engine.inference import make_detect_fn
from detectandtrack_tpu_torch.kernels import conv1 as conv1_mod
from detectandtrack_tpu_torch.kernels import roi_align as ra
from detectandtrack_tpu_torch.models import backbone, heads
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils import roofline
from detectandtrack_tpu_torch.utils.flops import count_flops
from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KNOBS = ("BENCH_MODE", "BENCH_BATCH", "BENCH_ITERS", "BENCH_BODY",
          "BENCH_T", "BENCH_BUCKET", "BENCH_KPS_BUDGET",
          "BENCH_SKIP_DEGENERATE", "BENCH_TRAIN_BATCH",
          "BENCH_STREAM_BATCH", "BENCH_STREAM_FRAMES")
_FUNCS = {"infer": "bench_infer", "train": "bench_train",
          "stream": "bench_stream"}
# The small size of (b) and (e): the bench's own knobs, and the widths
# its configs leave at their defaults narrowed through its load_cfg.
SMALL_ENV = {"BENCH_BODY": "resnet18", "BENCH_T": "2",
             "BENCH_BUCKET": "64x96", "BENCH_BATCH": "1",
             "BENCH_ITERS": "1", "BENCH_STREAM_FRAMES": "4"}
NARROW = ["RESNETS.WIDTH_PER_GROUP", 8, "FPN.DIM", 32,
          "FAST_RCNN.MLP_HEAD_DIM", 64, "KRCNN.NUM_STACKED_CONVS", 1,
          "KRCNN.CONV_HEAD_DIM", 16, "RPN.PRE_NMS_TOP_N_TEST", 64,
          "RPN.POST_NMS_TOP_N_TEST", 16, "RPN.PRE_NMS_TOP_N_TRAIN", 100,
          "RPN.POST_NMS_TOP_N_TRAIN", 32, "RPN.BATCH_SIZE_PER_IM", 32,
          "FAST_RCNN.BATCH_SIZE_PER_IM", 32]


class _Stop(Exception):
    pass


def _env(monkeypatch, values):
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for knob, value in values.items():
        monkeypatch.setenv(knob, value)


def _recorder(seen):
    def load(*args, **kwargs):
        seen.append(list(kwargs.get("opts", args[1] if len(args) > 1
                                    else ())))
        raise _Stop
    return load


@pytest.mark.parametrize("mode,env", [
    ("infer", {}),
    ("infer", {"BENCH_T": "1", "BENCH_BODY": "resnet101",
               "BENCH_KPS_BUDGET": "20", "BENCH_BUCKET": "480x640"}),
    ("train", {}),
    ("train", {"BENCH_T": "4", "BENCH_BUCKET": "480x640"}),
    ("stream", {}),
    ("stream", {"BENCH_BODY": "resnet101", "BENCH_BUCKET": "480x640"}),
])
def test_bench_cfg_equals_bench_py(mode, env, monkeypatch):
    _env(monkeypatch, env)
    jax_opts, port_opts = [], []
    monkeypatch.setattr(jconfig, "load_cfg", _recorder(jax_opts))
    monkeypatch.setattr(tbench, "load_cfg", _recorder(port_opts))
    with pytest.raises(_Stop):
        getattr(jbench, _FUNCS[mode])()
    with pytest.raises(_Stop):
        getattr(tbench, _FUNCS[mode])(device="cpu")
    assert len(jax_opts) == len(port_opts) == 1
    assert port_opts == jax_opts
    monkeypatch.undo()
    assert dataclasses.asdict(load_cfg(opts=port_opts[0])) == \
        dataclasses.asdict(jconfig.load_cfg(opts=jax_opts[0]))


def _json_keys(mode):
    """The keys of the dicts bench.py's `mode` function prints: dict
    literals passed to json.dumps or assigned to the name it dumps, and
    that name's subscript assignments."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == _FUNCS[mode])
    dumped, dicts, keys = set(), [], set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "dumps"):
            arg = node.args[0]
            if isinstance(arg, ast.Dict):
                dicts.append(arg)
            elif isinstance(arg, ast.Name):
                dumped.add(arg.id)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if (isinstance(target, ast.Name) and target.id in dumped
                    and isinstance(node.value, ast.Dict)):
                dicts.append(node.value)
            elif (isinstance(target, ast.Subscript)
                  and isinstance(target.value, ast.Name)
                  and target.value.id in dumped):
                keys.add(target.slice.value)
    for d in dicts:
        keys.update(k.value for k in d.keys)
    return keys


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The bench at the small size: SMALL_ENV, NARROW through its
    load_cfg, the stream's set under tmp_path."""
    _env(monkeypatch, SMALL_ENV)
    monkeypatch.setattr(tbench, "load_cfg",
                        lambda opts: load_cfg(opts=list(opts) + NARROW))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _one_line(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("mode", ["infer", "train", "stream"])
def test_bench_modes_print_bench_py_keys(mode, small, capsys):
    keys = _json_keys(mode)
    assert {"metric", "value", "unit"} <= keys
    result = getattr(tbench, _FUNCS[mode])(device="cpu")
    line = _one_line(capsys)
    assert line == json.loads(json.dumps(result))
    assert set(line) == keys | {"card", "flops_source"}
    numbers = {k: v for k, v in line.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    assert all(math.isfinite(v) for v in numbers.values()), numbers
    assert line["value"] > 0 and line["card"] == "cpu (no card)"
    for k in ("mfu_pct", "mfu_pct_degenerate"):
        assert line.get(k) is None, line
    if mode == "infer":
        assert line["model_tflops_per_clip"] >= 0
        assert line["vs_baseline_is_estimate"] is True
    if mode == "train":
        assert "loss_total" in numbers
    if mode == "stream":
        assert line["frames"] == 2 * int(SMALL_ENV["BENCH_STREAM_FRAMES"])


def _small_model():
    cfg = load_cfg(opts=[
        "MODEL.CONV_BODY", "resnet18", "VIDEO.VIDEO_ON", True,
        "VIDEO.NUM_FRAMES", 2, "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "TEST.SHAPE_BUCKETS", "[[64, 96]]", "TEST.SCORE_THRESH", 0.0,
        "KRCNN.NUM_STACKED_CONVS", 2] + NARROW)
    clip = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 64, 96, 3)).astype(np.float32))
    tubes = torch.as_tensor(make_realistic_tubes(
        1, cfg.RPN.POST_NMS_TOP_N_TEST, 2, 64, 96))
    return build_model(cfg, device="cpu", seed=0), clip, tubes


def _hook_flops(model, detect, args, monkeypatch):
    """2·MACs of every conv and linear layer from forward hooks, plus the
    roofline FLOPs of each conv1 and K1 call, over one call."""
    total = []

    def hook(m, inputs, out):
        w = getattr(m, "weight", None)
        if isinstance(m, torch.nn.Linear):
            total.append(2 * out.numel() * w.shape[1])
        elif isinstance(m, torch.nn.ConvTranspose2d):
            total.append(2 * inputs[0].numel() * int(np.prod(w.shape[1:])))
        elif isinstance(m, backbone.Conv3d):
            total.append(2 * out.numel() * int(np.prod(w.shape[1:])))
        elif isinstance(m, heads.BoxHead2MLP):       # fc6, fc7 via F.linear
            total.append(2 * inputs[0].shape[0] * sum(
                fc.in_features * fc.out_features for fc in (m.fc6, m.fc7)))
        elif isinstance(m, backbone.Conv1):
            total.append(roofline.conv1_flops(inputs[0].shape,
                                              m.time_kernel))

    handles = [m.register_forward_hook(hook) for m in model.modules()]
    k1 = ra.roi_align_multilevel

    def k1_recorded(features, strides, rois, levels, output_size=7,
                    sampling_ratio=2):
        total.append(roofline.roi_align_flops(
            rois.numel() // 4, output_size, features[0].shape[-1],
            sampling_ratio))
        return k1(features, strides, rois, levels, output_size,
                  sampling_ratio)

    monkeypatch.setattr(ra, "roi_align_multilevel", k1_recorded)
    try:
        detect(*args)
    finally:
        for h in handles:
            h.remove()
        monkeypatch.setattr(ra, "roi_align_multilevel", k1)
    return float(sum(total))


def test_count_flops_equals_layer_sum_and_ignores_the_implementation(
        monkeypatch):
    model, clip, tubes = _small_model()
    for detect, args in ((make_detect_fn(model, with_proposals=True,
                                         run_rpn=True), (clip, tubes)),
                         (make_detect_fn(model), (clip,))):
        counted = count_flops(detect, *args)
        assert counted == _hook_flops(model, detect, args, monkeypatch)
        # The kernels' work is invisible to torch on the card: with plain
        # versions that compute nothing countable, the count is the same.
        with monkeypatch.context() as m:
            m.setattr(conv1_mod, "conv1_reference",
                      lambda x, k7, t, dtype: torch.zeros(
                          x.shape[:2] + ((x.shape[2] + 1) // 2,
                                         (x.shape[3] + 1) // 2, 64),
                          dtype=dtype))
            m.setattr(ra, "roi_align_multilevel_reference",
                      lambda f, s, rois, lv, p=7, sr=2: torch.zeros(
                          rois.shape[:2] + (p, p, f[0].shape[-1]),
                          dtype=f[0].dtype))
            assert count_flops(detect, *args) == counted


def test_count_flops_counts_forward_and_backward_once():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 2, 16, 24, 3), generator=gen)
    k7 = torch.randn((3, 7, 7, 3, 64), generator=gen).requires_grad_()
    fwd = roofline.conv1_flops(x.shape, 3)

    def conv1_step():
        conv1_mod.conv1_autograd(x, k7, 3, torch.float32).sum().backward()

    # forward (the entry's roofline FLOPs), then the backward's recomputed
    # plain forward and its weight gradient (FlopCounterMode's).
    assert count_flops(conv1_step) == 3 * fwd
    assert count_flops(conv1_mod.conv1, x, k7, 3, torch.float32) == fwd

    maps = [torch.randn((2, 16, 24, 8), generator=gen).requires_grad_(),
            torch.randn((2, 8, 12, 8), generator=gen).requires_grad_()]
    rois = torch.tensor([[[1.0, 2.0, 30.0, 40.0], [0.0, 0.0, 60.0, 50.0]],
                         [[5.0, 5.0, 9.0, 9.0], [10.0, 4.0, 90.0, 60.0]]])
    levels = torch.tensor([[0, 1], [0, 1]], dtype=torch.int32)

    def roi_step():
        ra.roi_align_multilevel_autograd(maps, [4, 8], rois, levels,
                                         7, 2).sum().backward()

    assert count_flops(roi_step) == (roofline.roi_align_flops(4, 7, 8)
                                     + roofline.backward_flops(4 * 49 * 8))
    with pytest.raises(RuntimeError, match="already in progress"):
        count_flops(count_flops, roi_step)


def test_stream_percentiles_drop_frames_by_dispatch_order():
    # Frames sunk in one order, dispatched in another; the early-dispatched
    # frames are the slowest, the late ones the fastest.
    dispatch = {("v", 3): 0.0, ("v", 0): 1.0, ("v", 2): 2.0, ("v", 1): 3.0,
                ("w", 0): 4.0}
    lat = {("v", 0): 0.9, ("v", 1): 0.1, ("v", 2): 0.5, ("v", 3): 1.0,
           ("w", 0): 0.05}
    got = tbench.warm_latencies_ms(lat, dispatch, 2)
    np.testing.assert_allclose(got, [500.0, 100.0, 50.0])
    np.testing.assert_allclose(tbench.warm_latencies_ms(lat, dispatch, 9),
                               [50.0])
    assert tbench.warm_latencies_ms({}, {}, 2).size == 0


def test_launch_mode_bench_runs_and_the_bench_refuses_a_missing_card(
        small, monkeypatch, capsys):
    assert tlaunch.main(["--mode", "bench", "--device", "cpu"]) == 0
    line = _one_line(capsys)
    assert line["metric"].startswith("PoseTrack inference") and \
        line["value"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([])
    line = _one_line(capsys)
    assert line["value"] is None and "no CUDA device" in line["error"]


@pytest.mark.parametrize("variant", ["full", "noswitch", "nodma", "nodot"])
def test_count_flops_of_the_diagnostic_kernel_is_its_roofline_work(variant):
    from detectandtrack_tpu_torch.kernels import diag_roialign as dr
    gen = torch.Generator().manual_seed(0)
    maps = [torch.randn((1, 64, 128, 32), generator=gen).to(torch.bfloat16)
            for _ in range(2)]
    rois = torch.rand((12,), generator=gen) * 60.0
    levels = torch.tensor([0, 1, 1], dtype=torch.int32)
    want = roofline.diag_work(0, 3, 5, 32, variant).flops
    assert count_flops(dr.diag_pool, maps, rois, levels, 5, variant) == want
