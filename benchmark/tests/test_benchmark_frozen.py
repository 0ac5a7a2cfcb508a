"""Golden values of the benchmark's frozen copies: the traffic generators,
the peaks and work formulas, the FLOP-count rule and the trace arithmetic.
They hold the copies still; none compares with the system under test."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from benchmark import flops, inputs, roofline, trace
from benchmark.reference import ops


def test_realistic_tubes_golden():
    t = inputs.make_realistic_tubes(2, 20, 3, 800, 1344, seed=7)
    assert t.shape == (2, 20, 12) and t.dtype == np.float32
    assert float(t.sum()) == pytest.approx(265864.25, rel=1e-6)
    np.testing.assert_allclose(t[1, 19, :4], [937.16626, 0.0, 1246.4443,
                                              424.41486], rtol=1e-6)
    # Clipped to the image, and person-shaped (taller than wide).
    assert t[..., 0::2].max() <= 1343 and t[..., 1::2].max() <= 799
    w = t[..., 2] - t[..., 0]
    h = t[..., 3] - t[..., 1]
    assert (h >= w).mean() > 0.8


def test_level_shares():
    t = inputs.make_realistic_tubes(1, 300, 1, 8000, 8000, seed=1)[0]
    side = np.sqrt((t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1]))
    counts = np.histogram(side, [32, 112, 224, 448, 720])[0]
    # 105 / 105 / 60 / 30 drawn; a few boxes at the border are clipped.
    np.testing.assert_array_equal(counts, [106, 105, 63, 26])


def test_seed_streams():
    assert inputs.derive(5, "weights") == 4888676636438521914
    assert inputs.derive(2 ** 40 + 3, "clips", 1) == 7466550765339562940
    assert inputs.derive(5, "weights") != inputs.derive(5, "clips")
    u, _ = inputs.make_draws(9, 2)("rpn", 1, 5)
    np.testing.assert_allclose(u[0].numpy(), [0.12277836, 0.38949871,
                                              0.40542114, 0.61889529,
                                              0.23257649], rtol=1e-6)


def test_ground_truth():
    g = inputs.make_ground_truth(3, 0, 4, 16, 2, (562, 1000), (2, 12))
    n = g["gt_valid"].sum(1)
    assert ((n >= 2) & (n <= 12)).all()
    b = g["gt_boxes"].reshape(4, 16, 2, 4)
    k = g["gt_keypoints"]
    assert (k[..., 0] >= b[..., None, 0] - 1e-3).all()
    assert (k[..., 0] <= b[..., None, 2] + 1e-3).all()
    assert set(np.unique(k[..., 2])) <= {0.0, 1.0, 2.0}


def test_weights_recipe():
    cfg = {"MODEL": {"CONV_BODY": "resnet50", "NUM_CLASSES": 2},
           "VIDEO": {"NUM_FRAMES": 2, "TIME_KERNEL_DIM": [3, 3, 3, 3, 1]},
           "RESNETS": {"WIDTH_PER_GROUP": 64, "NUM_GROUPS": 1},
           "FPN": {"DIM": 256}, "RPN": {"ASPECT_RATIOS": [0.5, 1, 2]},
           "FAST_RCNN": {"ROI_XFORM_RESOLUTION": 7, "MLP_HEAD_DIM": 1024},
           "KRCNN": {"NUM_STACKED_CONVS": 8, "CONV_HEAD_DIM": 512,
                     "CONV_HEAD_KERNEL": 3, "NUM_KEYPOINTS": 15}}
    w = inputs.make_weights(cfg, 11, "cpu")
    k = w["backbone.res3_0.b.conv.weight"]
    assert k.shape == (128, 128, 3, 3, 3)
    assert float(k.std()) == pytest.approx((2 / (27 * 128)) ** 0.5, rel=0.02)
    assert float(w["box_head.cls_score.weight"].std()) == pytest.approx(
        0.01, rel=0.1)
    assert (w["backbone.res2_0.a.bn.scale"] == 1).all()
    assert (w["backbone.res2_0.c.bn.scale"] == 0.2).all()
    assert sum(v.numel() for v in w.values()) == 80_527_868
    again = inputs.make_weights(cfg, 11, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)


def test_anchors_published():
    """Detectron's anchors for stride 16, size 32."""
    np.testing.assert_array_equal(
        ops.generate_anchors(16, [32], [0.5, 1, 2]),
        [[-15, -4, 30, 19], [-8, -8, 23, 23], [-3, -14, 18, 29]])


def test_peaks_and_work():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3").bf16_flops == 989e12
    with pytest.raises(ValueError):
        roofline.peaks_for("NVIDIA H100 PCIe")
    w = roofline.conv1_work((4, 8, 800, 1344, 3), 3)
    assert w.flops == 2.0 * 4 * 8 * 400 * 672 * 64 * 3 * 49 * 3
    assert w.n_bytes == (4 * 8 * 800 * 1344 * 3 + 3 * 49 * 3 * 64
                         + 4 * 8 * 400 * 672 * 64) * 2
    assert roofline.bound_ms(w) == pytest.approx(0.49094349524772496)
    b = roofline.roi_align_backward_work(
        4096, 7, 256, [(8, 200, 336, 256), (8, 100, 168, 256)])
    assert b.n_bytes == 447102976.0 and b.flops == 1645314048.0
    rois = torch.tensor([[10., 20., 110., 220.], [0., 0., 40., 40.]])
    f = roofline.roi_align_work([(2, 50, 84, 256)], [4], rois,
                                torch.tensor([0, 1]), torch.tensor([0, 0]), 7)
    assert (f.n_bytes, f.flops) == (432168.0, 802816.0)


def test_flop_rule():
    """Convolutions and matrix products at 2 per multiply-add, forward
    and backward; RoIAlign at 2 per corner tap; elementwise at 0."""
    x = torch.empty(2, 3, 8, 8, device="meta", requires_grad=True)
    conv = nn.Conv2d(3, 4, 3, padding=1).to("meta")
    assert flops.count(lambda: torch.relu(conv(x))) == 2 * 2 * 4 * 64 * 27
    fwd = 2 * 2 * 4 * 64 * 27
    assert flops.count(lambda: conv(x).sum().backward()) == 3 * fwd
    feats = [torch.empty(2, 10, 10, 8, device="meta")]
    n = flops.count(lambda: ops.roi_align(
        feats, [4], torch.empty(5, 4, device="meta"),
        torch.zeros(5, dtype=torch.long, device="meta"),
        torch.zeros(5, dtype=torch.long, device="meta"), 7, 2))
    assert n == roofline.roi_align_flops(5, 7, 8) == 5 * 49 * 8 * 32


def test_trace_arithmetic():
    assert trace.group("void (anonymous namespace)::roi_align_fwd_kernel"
                       "<__nv_bfloat16>(Params)") == "roi_align_fwd_kernel"
    assert trace.group("void at::native::vectorized_elementwise_kernel<4, "
                       "at::native::FillFunctor<float>>(int, F)") == \
        "vectorized_elementwise_kernel"
    tr = trace.Trace(
        kernels=[("a", 0.0, 10.0), ("b", 5.0, 10.0), ("a", 40.0, 10.0),
                 ("c", 95.0, 20.0)],
        spans=[("bench/dispatch", 14.0, 36.0), ("bench/read_back", 52.0,
                                                 90.0)],
        window=(0.0, 100.0))
    assert tr.busy_us() == 15.0 + 10.0 + 5.0
    assert tr.groups == {"a": 20.0, "b": 10.0, "c": 20.0}
    assert tr.kernel_us("a|b") == 30.0
    assert tr.top_ops(2) == [["a", 20e-6], ["c", 20e-6]]
    assert tr.idle_gaps(3) == [["bench/read_back", 45e-6],
                               ["bench/dispatch", 25e-6]]
    assert tr.span_us("bench/dispatch") == [22.0]


def _event(name, device, start, end, annotation=False, activity=None):
    return SimpleNamespace(
        name=name, device_type=f"DeviceType.{device}",
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation, activity_type=activity)


class _Profiler:
    """A stand-in for a finished `torch.profiler.profile`: two kernels and
    a memory set on the card; the host scopes `bench/window`, `bench/step`
    and, inside it, the program's `x/phase`, whose device shadow covers
    the idle gap between the kernels. `bench/step`'s shadow carries only
    its activity type, `x/phase`'s only the annotation flag."""

    def events(self):
        return [
            _event("bench/window", "CPU", 0.0, 100.0, True,
                   "user_annotation"),
            _event("bench/step", "CPU", 5.0, 90.0, True, "user_annotation"),
            _event("x/phase", "CPU", 8.0, 65.0, True, "user_annotation"),
            _event("aten::add", "CPU", 30.0, 31.0, False, "cpu_op"),
            _event("bench/step", "CUDA", 10.0, 72.0, False,
                   "gpu_user_annotation"),
            _event("x/phase", "CUDA", 10.0, 70.0, True),
            _event("void k1<float>(P)", "CUDA", 10.0, 20.0, False, "kernel"),
            _event("void k2<float>(P)", "CUDA", 60.0, 70.0, False, "kernel"),
            _event("Memset (Device)", "CUDA", 70.0, 72.0, False,
                   "gpu_memset"),
        ]


def test_program_scopes_are_no_device_work():
    """A scope's device shadow is not device work, whatever its name;
    memory sets are; host scopes name the idle time, which
    `idle_us_by_span` cuts at their edges."""
    tr = trace.from_profiler(_Profiler(), "bench/window")
    assert tr.window == (0.0, 100.0)
    assert tr.busy_us() == 10.0 + 10.0 + 2.0
    assert [n for n, *_ in tr.top_ops()] == ["k1", "k2", "Memset"]
    assert [n for n, _, _ in tr.spans] == ["bench/step", "x/phase"]
    assert tr.idle_gaps(3) == [["x/phase", 40e-6], ["bench/step", 28e-6],
                               ["bench/step", 10e-6]]
    # [0, 10]: 5 outside every span, 3 in bench/step, 2 in x/phase;
    # [20, 60] in x/phase; [72, 100]: 18 in bench/step, 10 outside.
    assert tr.idle_us_by_span() == {"idle": 15.0, "bench/step": 21.0,
                                    "x/phase": 42.0}
    assert sum(tr.idle_us_by_span().values()) == tr.window_us - tr.busy_us()
