"""The port's profiling and kernel-diagnostic tools on the CPU:
utils/profiling (device_time, force_outputs, trace), utils/env, the bounds
of utils/roofline, tools/trace_summary and tools/conv_roofline on a small
hand-written chrome trace with CUDA kernel events, and each tool's main()
with --device cpu at a tiny size."""

import gzip
import json
import os

import pytest
import torch

from detectandtrack_tpu_torch.tools import (bench_conv, bench_roialign,
                                            capture_trace, conv_roofline,
                                            diag_roialign, trace_summary)
from detectandtrack_tpu_torch.utils import env, profiling, roofline


def test_device_time_and_force_outputs_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return {"a": (x + 1, [x * 2]), "b": torch.empty(0)}

    x = torch.ones(3)
    profiling.force_outputs(fn(x))
    t = profiling.time_call(fn, x, iters=4, warmup=2)
    assert t.device == "cpu" and t.seconds > 0 and t.seconds == t.host_seconds
    assert len(calls) == 1 + 2 + 4
    assert profiling.device_time(fn, x, iters=2, warmup=0) > 0


def test_device_time_needs_a_cpu_or_cuda_tensor():
    with pytest.raises(ValueError, match="no tensor"):
        profiling.device_time(lambda: 3, iters=1, warmup=0)
    meta = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="meta"):
        profiling.device_time(lambda v: v, meta, iters=1, warmup=0)


def test_trace_writes_a_chrome_trace_that_trace_summary_reads(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with torch.profiler.record_function("stage_a"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].endswith(".json.gz")
    events = trace_summary.load_trace(str(tmp_path))
    assert any(e.get("cat") == "user_annotation" and e["name"] == "stage_a"
               for e in events)
    assert trace_summary.kernel_events(events) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            with profiling.trace(str(tmp_path)):
                pass


def test_runtime_info_on_cpu():
    info = env.get_runtime_info()
    assert info["torch"] == torch.__version__
    assert set(info) >= {"python", "platform", "cuda", "cudnn", "numpy",
                         "device", "device_count", "card"}
    if not torch.cuda.is_available():
        assert info["device"] == "cpu" and info["device_count"] == "0"
        assert info["card"] == "n/a"
    logged = []

    class Log:
        def info(self, fmt, k, v):
            logged.append(k)

    env.log_runtime_info(Log())
    assert logged == list(info)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::roi_align_fwd_kernel<__nv_bfloat16>("
     "(anonymous namespace)::LevelTable, float const*, int)",
     "roi_align_fwd_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(int, "
     "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"),
    ("conv1_tc_kernel(__nv_bfloat16 const*, int)", "conv1_tc_kernel"),
    ("fusion.105", "fusion"),
])
def test_trace_summary_folds_kernel_names(name, group):
    assert trace_summary.group(name) == group


def _hand_trace(path):
    """Two traced iterations: a conv kernel and an elementwise kernel per
    iteration, launched from inside `record_function` scopes; 50 µs of
    the 150 µs window idle."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "backbone",
           "tid": 1, "ts": 0, "dur": 50},
          {"ph": "X", "cat": "user_annotation", "name": "heads/kps_head",
           "tid": 1, "ts": 100, "dur": 50}]
    for i, (scope_ts, k_ts) in enumerate([(10, 0), (110, 100)]):
        for j, (name, dur) in enumerate(
                [("sm90_xmma_fprop_implicit_gemm_bf16", 40.0),
                 ("void at::native::vectorized_elementwise_kernel<4, "
                  "at::native::relu>(int)", 10.0)]):
            corr = 10 * i + j
            ev.append({"ph": "X", "cat": "cuda_runtime", "tid": 1,
                       "name": "cudaLaunchKernel", "ts": scope_ts + j,
                       "dur": 1, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "name": name, "tid": 7,
                       "ts": k_ts + 40 * j, "dur": dur,
                       "args": {"correlation": corr,
                                "External id": 100 + i if j == 0 else -1}})
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::convolution",
                   "tid": 1, "ts": scope_ts, "dur": 1,
                   "args": {"External id": 100 + i}})
    with gzip.open(path / "trace_1_1.json.gz", "wt") as f:
        json.dump({"traceEvents": ev}, f)
    work = {"iters": 2, "device": "NVIDIA H100 80GB HBM3",
            "card": "NVIDIA H100 80GB HBM3, 700.00 W",
            "kernels": {"sm90_xmma_fprop_implicit_gemm_bf16": {
                "flops": 19.78e9, "bytes": 0.03e9, "kind": "bf16",
                "source": "torch op counters"}}}
    with open(path / "work.json", "w") as f:
        json.dump(work, f)


def test_trace_summary_groups_busy_share_and_stages(tmp_path, capsys):
    _hand_trace(tmp_path)
    events = trace_summary.load_trace(str(tmp_path))
    kernels = trace_summary.kernel_events(events)
    groups = trace_summary.by_group(kernels)
    assert groups == {"sm90_xmma_fprop_implicit_gemm_bf16": (80.0, 2),
                      "vectorized_elementwise_kernel": (20.0, 2)}
    assert trace_summary.busy_share(kernels) == (100.0, 150.0)
    assert trace_summary.by_stage(events, kernels) == {
        "backbone": 50.0, "heads/kps_head": 50.0}
    # The 50 µs gap between the iterations lies outside both scopes.
    assert trace_summary.idle_by_stage(events, kernels) == {"(none)": 50.0}
    assert trace_summary.by_op(events, kernels) == {
        ("sm90_xmma_fprop_implicit_gemm_bf16", "aten::convolution"): 80.0,
        ("vectorized_elementwise_kernel", "?"): 20.0}
    trace_summary.main([str(tmp_path), "5"])
    out = capsys.readouterr().out
    assert "66.7%" in out and "heads/kps_head" in out


def test_conv_roofline_rows(tmp_path, capsys):
    _hand_trace(tmp_path)
    rows = conv_roofline.main([str(tmp_path), "--min-us-per-iter", "0"])
    conv, relu = rows
    assert conv["name"].startswith("sm90") and conv["us_per_iter"] == 40.0
    # 19.78 GFLOP in 40 µs: 494.5 TFLOP/s, 50% of the H100 SXM's 989; the
    # bound is 20 µs of operations.
    assert conv["tflops"] == pytest.approx(494.5)
    assert conv["pct_peak"] == pytest.approx(50.0)
    assert conv["bound"] == "operations"
    assert conv["eff"] == pytest.approx(0.5)
    assert relu["eff"] is None and relu["us_per_iter"] == 10.0
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in capsys.readouterr().out


def test_roofline_bounds():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") is roofline.H100_SXM
    for name in ("NVIDIA H100 PCIe", "cpu"):
        with pytest.raises(ValueError):
            roofline.peaks_for(name)
    ms, by = roofline.bound(roofline.conv1_work((2, 8, 800, 1344, 3), 3,
                                                torch.bfloat16))
    assert by == "operations" and ms == pytest.approx(0.2455, abs=1e-4)
    # 16.29 MFLOP a pair at p=7, 35.8 at p=14 (C=256).
    assert roofline.diag_work(0, 1, 7, 256, "full").flops == pytest.approx(
        16.29e6, rel=1e-3)
    assert roofline.diag_work(0, 1, 14, 256, "full").flops == pytest.approx(
        35.8e6, rel=1e-3)
    nodma = roofline.diag_work(64 * 128, 10, 7, 256, "nodma")
    assert nodma.n_bytes == 10 * (49 * 256 * 2 + 20)
    assert roofline.diag_work(64 * 128, 10, 7, 256, "nodot").kind == "f32"


def test_diag_roialign_tool_on_cpu(capsys):
    rows = diag_roialign.main(["3", "7", "--device", "cpu", "--iters", "1",
                               "--warmup", "0", "--hw", "64x128"])
    assert [r["variant"] for r in rows] == list(diag_roialign.VARIANTS)
    assert all(r["ms"] > 0 and r["bound_ms"] is None for r in rows)
    assert "cpu, plain version" in capsys.readouterr().out


def test_bench_roialign_tool_on_cpu():
    rows = bench_roialign.main(["1", "--device", "cpu", "--size", "64x96",
                                "--slabs", "2", "--channels", "16",
                                "--box-k", "5", "--kps-k", "3"])
    assert [(r["stage"], r["p"]) for r in rows] == [("box", 7), ("kps", 14)]


def test_bench_conv_tool_on_cpu():
    rows = bench_conv.main(["all", "1", "--device", "cpu", "--n", "2",
                            "--batch", "1", "--size", "32x48"])
    assert len(rows) == 6 and all(r["tflops"] is None for r in rows)


def test_capture_trace_tool_on_cpu(tmp_path):
    """The tiny R-18 model through capture_trace on the CPU: a chrome trace
    with the model's stage scopes, and work.json beside it."""
    out = capture_trace.main([
        "64x96", "1", str(tmp_path), "realistic", "--device", "cpu",
        "--iters", "1", "--warmup", "1", "--opts",
        "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "RESNETS.WIDTH_PER_GROUP", "8", "FPN.DIM", "32",
        "FAST_RCNN.MLP_HEAD_DIM", "64", "VIDEO.NUM_FRAMES", "2",
        "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "RPN.PRE_NMS_TOP_N_TEST", "50", "RPN.POST_NMS_TOP_N_TEST", "16",
        "TEST.DETECTIONS_PER_IM", "4", "KRCNN.NUM_STACKED_CONVS", "1",
        "KRCNN.CONV_HEAD_DIM", "16"])
    events = trace_summary.load_trace(out)
    scopes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert scopes >= {"backbone", "fpn", "rpn", "nms", "roi_transform",
                      "heads/box_head", "heads/kps_head", "decode"}
    with open(os.path.join(out, "work.json")) as f:
        work = json.load(f)
    assert work["iters"] == 1 and work["device"] == "cpu"
    # The hand kernels' work of one request: conv1 (f32 here) and K1 at
    # the box and keypoint stages.
    assert {"conv1_tf32_kernel", "roi_align_fwd_kernel"} <= set(
        work["kernels"])
    assert work["kernels"]["roi_align_fwd_kernel"]["source"] == (
        "utils/roofline")
    # The stage scopes come off after the trace.
    from detectandtrack_tpu_torch.models import detector
    from detectandtrack_tpu_torch.ops.nms import nms_fixed
    assert detector.nms_fixed is nms_fixed


class _Ev:
    """The fields of torch.profiler's FunctionEvent that torch_op_work
    reads."""

    def __init__(self, name, shapes=(), concrete=(), flops=0, kernels=(),
                 children=()):
        self.name, self.input_shapes = name, list(shapes)
        self.concrete_inputs, self.flops = list(concrete), flops
        self.kernels, self.cpu_children = list(kernels), list(children)
        self.cpu_parent = None
        for c in self.cpu_children:
            c.cpu_parent = self


class _K:
    def __init__(self, name, duration):
        self.name, self.duration = name, duration


def test_capture_trace_gives_torch_ops_work_to_their_longest_kernel():
    """A 3x3 conv (its work from the shapes, to the GEMM kernel, not the
    layout copy beside it) and a matrix product (torch's FLOP count)."""
    conv = _Ev("aten::conv2d", flops=999, children=[_Ev(
        "aten::convolution", [[2, 8, 16, 16], [4, 8, 3, 3], [], [], [], [],
                              [], [], []],
        [None, None, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1],
        kernels=[_K("void nchwToNhwcKernel<float>(int)", 2.0),
                 _K("sm90_xmma_fprop_implicit_gemm_f32", 9.0)])])
    mm = _Ev("aten::linear", children=[_Ev(
        "aten::addmm", [[16], [32, 64], [64, 16], [], []], flops=65536,
        kernels=[_K("void cutlass::Kernel2<cutlass_80_gemm>(Params)", 3.0)])])
    work = capture_trace.torch_op_work([_Ev("backbone", children=[conv]),
                                        mm], 2)
    assert set(work) == {"sm90_xmma_fprop_implicit_gemm_f32", "Kernel2"}
    w = work["sm90_xmma_fprop_implicit_gemm_f32"]
    assert w.flops == 2 * 2 * 16 * 16 * 4 * 8 * 9 and w.kind == "bf16"
    assert w.n_bytes == 2 * (2 * 8 * 16 * 16 + 4 * 8 * 9 + 2 * 4 * 16 * 16)
    assert work["Kernel2"].flops == 65536
    assert work["Kernel2"].n_bytes == 2 * (16 + 32 * 64 + 64 * 16 + 32 * 16)


def test_smoke_learn_tool_on_cpu(tmp_path, capsys):
    """The learning recipe's runner: 2 training steps, test and track
    through the port's CLI on the CPU, on a small set made beforehand (the
    tool makes the demo-data set only where none is) → one JSON line with
    finite metrics."""
    import math

    from detectandtrack_tpu_torch.data.synthetic import (
        generate_synthetic_posetrack)
    from detectandtrack_tpu_torch.tools import smoke_learn
    generate_synthetic_posetrack(str(tmp_path / "data" / "synthetic"),
                                 num_videos=1, frames_per_video=4,
                                 image_hw=(64, 96), seed=2)
    small = ["MODEL.CONV_BODY", "resnet18", "RESNETS.WIDTH_PER_GROUP", "8",
             "FPN.DIM", "32", "FAST_RCNN.MLP_HEAD_DIM", "64",
             "KRCNN.NUM_STACKED_CONVS", "1", "KRCNN.CONV_HEAD_DIM", "16",
             "TRAIN.SCALES", "[64]", "TRAIN.MAX_SIZE", "96",
             "TEST.SCALE", "64", "TEST.MAX_SIZE", "96",
             "TEST.SHAPE_BUCKETS", "[[64, 96]]"]
    rows = smoke_learn.main(["--steps", "2", "--device", "cpu", "--out",
                             str(tmp_path)] + small)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rows[0]
    assert (line["seed"], line["steps"], line["device"]) == (3, 2, "cpu")
    assert all(math.isfinite(line[k]) for k in ("mAP", "MOTA", "box_AP50",
                                                 "train_s"))
    assert sorted(os.listdir(tmp_path / "seed3_2" / "checkpoints")) == [
        "2.pt"]
