"""Capture a torch.profiler trace of the main inference path.

    python3 -m detectandtrack_tpu_torch.tools.capture_trace [HxW] [batch]
        [outdir] [mix] [--device cuda|cpu] [--iters 3]
        [--warmup 2] [--eager] [--opts KEY VALUE ...]

Port of tools/capture_trace.py. It builds the main configuration
(configs/video/3d_R50_T8_tubes_kps.yaml: 3D R-50, T=8, bf16) with seeded
random weights, runs `warmup` requests of `batch` clips at the bucket
HxW (default 800x1344, B=2), then traces `iters` more (default 3) with
`utils/profiling.trace` into `outdir` (default
out_trace/trace_<HxW>_b<batch>_<mix>). `mix` is "realistic" (default:
`utils/synthetic.make_realistic_tubes` proposal tubes through
`detect_with_proposals(run_rpn=True)`, the RPN and its NMS kept running)
or "degenerate" (the model's own random-weight RPN proposals).

On a CUDA model the requests go through `make_detect_fn`'s captured
function (`engine/graphs.py`): the traced requests are graph replays, one
device program each, and the trace shows the card's kernels and idle gaps
but no host op or stage scope. `--eager` traces the uncaptured function
instead (`.eager`), as a request ran before the port captured it: the
trace then shows the model's own stage scopes (`utils/profiling.scope`,
entered only while a profiler runs): model/backbone, model/fpn, model/rpn,
model/nms, model/roi_transform, model/<head> and model/decode. They map
each kernel back to the code that launched it, the role tools/dump_hlo.py
played for XLA (that tool has no counterpart here: there is no compiled
graph to dump).

Beside the trace it writes work.json: per CUDA kernel group, the FLOP and
bytes of one request, which tools/conv_roofline.py turns into a roofline
table. The hand-written kernels' work comes from `utils/roofline` (conv1
and K1 at the shapes and rois of the last warm-up request, which the
traced requests repeat; that request runs uncaptured); cuDNN's and
cuBLAS's from torch's op counters (`with_flops`, `record_shapes`):
convolutions from their shapes, matrix products from torch's count, each
op's work given to the longest kernel it launched (with `--eager` only: a
replay shows the counters no op).

Keep this out of chip_smoke.py: a profiling run on the card once left the
machine unresponsive after it exited. Run it by hand, once, as its own
command; then tools/trace_summary.py and tools/conv_roofline.py on its
output directory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
from typing import Dict

import torch

from ..core.config import load_cfg
from ..engine.inference import make_detect_fn
from ..kernels import roi_align as ra
from ..models import backbone as backbone_mod
from ..models import detector as det_mod
from ..models.backbone import compute_dtype
from ..models.detector import build_model
from ..utils import roofline
from ..utils.env import card_line
from ..utils.profiling import force_outputs, trace
from ..utils.synthetic import make_realistic_tubes
from .trace_summary import group

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MAIN_CFG = "configs/video/3d_R50_T8_tubes_kps.yaml"


@contextlib.contextmanager
def hand_kernel_work(work: Dict[str, roofline.Work]):
    """Add the work (utils/roofline) of each hand-kernel call the model
    makes to `work`, keyed by the CUDA kernel's name: conv1 (bf16: the
    tensor-core kernel, f32: the 3-pass TF32 kernel) and K1. It wraps the
    autograd entry points the backbone and the detector call."""
    saved = [(backbone_mod, "conv1_autograd", backbone_mod.conv1_autograd),
             (det_mod, "roi_align_multilevel_autograd",
              det_mod.roi_align_multilevel_autograd)]

    def add(key, w):
        work[key] = work[key] + w if key in work else w

    def conv1_autograd(x, k7, t, dtype):
        add("conv1_tc_kernel" if dtype == torch.bfloat16
            else "conv1_tf32_kernel",
            roofline.conv1_work(x.shape, t, dtype))
        return saved[0][2](x, k7, t, dtype)

    def roi_align_multilevel_autograd(features, strides, rois, levels,
                                      output_size=7, sampling_ratio=2):
        s_dim, k = rois.shape[:2]
        add("roi_align_fwd_kernel", roofline.roi_align_work(
            [tuple(f.shape) for f in features], strides, rois.reshape(-1, 4),
            ra.slab_of_rows(s_dim, k, "cpu"), levels.reshape(-1),
            output_size, features[0].dtype))
        return saved[1][2](features, strides, rois, levels, output_size,
                           sampling_ratio)

    backbone_mod.conv1_autograd = conv1_autograd
    det_mod.roi_align_multilevel_autograd = roi_align_multilevel_autograd
    try:
        yield work
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _conv_work(shapes, concrete, size: int) -> roofline.Work:
    """aten::convolution(input, weight, bias, stride, padding, dilation,
    transposed, output_padding, groups) from its recorded shapes."""
    x, w = shapes[0], shapes[1]
    stride, pad, dil, transposed = concrete[3:7]
    n, spatial = x[0], x[2:]
    if transposed:                     # weight (Cin, Cout/g, *k)
        out = [(i - 1) * s - 2 * p + d * (k - 1) + 1 for i, s, p, d, k in
               zip(spatial, stride, pad, dil, w[2:])]
        flops = 2 * n * math.prod(spatial) * math.prod(w)
        cout = w[1] * concrete[8]
    else:                              # weight (Cout, Cin/g, *k)
        out = [(i + 2 * p - d * (k - 1) - 1) // s + 1 for i, s, p, d, k in
               zip(spatial, stride, pad, dil, w[2:])]
        flops = 2 * n * math.prod(out) * math.prod(w)
        cout = w[0]
    elems = math.prod(x) + math.prod(w) + n * cout * math.prod(out)
    return roofline.Work(elems * size, flops, "bf16" if size == 2 else "f32")


def _mm_work(shapes, flops, size: int) -> roofline.Work:
    """Matrix products: torch's FLOP count; operands read and the product
    written once."""
    mats = [s for s in shapes if len(s) >= 2]
    out = 0
    if len(mats) >= 2:
        a, b = mats[-2], mats[-1]
        out = math.prod(a[:-1]) * b[-1]
    elems = sum(math.prod(s) for s in shapes if s) + out
    return roofline.Work(elems * size, flops, "bf16" if size == 2 else "f32")


_MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
           "aten::matmul", "aten::linear")


def torch_op_work(events, size: int) -> Dict[str, roofline.Work]:
    """Per kernel group, the work of the cuDNN / cuBLAS ops (convolutions
    and matrix products) in the profiler's `events`: each op's work goes to
    the longest kernel it or its children launched."""
    work: Dict[str, roofline.Work] = {}

    def kernels(e):
        out = list(getattr(e, "kernels", []))
        for c in e.cpu_children:
            out += kernels(c)
        return out

    def visit(e):
        w = None
        if e.name == "aten::convolution" and e.concrete_inputs:
            w = _conv_work(e.input_shapes, e.concrete_inputs, size)
        elif e.name in _MM_OPS and e.flops:
            w = _mm_work(e.input_shapes, e.flops, size)
        if w is None:
            for c in e.cpu_children:
                visit(c)
            return
        ks = kernels(e)
        if ks:
            key = group(max(ks, key=lambda k: k.duration).name)
            work[key] = work[key] + w if key in work else w

    for e in events:
        if e.cpu_parent is None:
            visit(e)
    return work


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("bucket", nargs="?", default="800x1344")
    ap.add_argument("batch", nargs="?", type=int, default=2)
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("mix", nargs="?", default="realistic",
                    choices=("realistic", "degenerate"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--eager", action="store_true",
                    help="trace the uncaptured entry point, stage by stage")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="config overrides, KEY VALUE ...")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("capture_trace: no CUDA device (--device cpu "
                         "traces the CPU path)")
    bh, bw = (int(v) for v in args.bucket.split("x"))
    outdir = args.outdir or os.path.join(
        "out_trace", f"trace_{args.bucket}_b{args.batch}_{args.mix}")
    cfg = load_cfg(os.path.join(_REPO, MAIN_CFG), opts=list(args.opts) + [
        "TEST.SHAPE_BUCKETS", f"[[{bh}, {bw}]]"])
    t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
    dev = args.device
    model = build_model(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    clips = torch.randn((args.batch, t, bh, bw, 3), generator=gen, device=dev)
    if args.mix == "realistic":
        tubes = torch.as_tensor(make_realistic_tubes(
            args.batch, cfg.RPN.POST_NMS_TOP_N_TEST, t, bh, bw)).to(dev)
        detect = make_detect_fn(model, with_proposals=True, run_rpn=True)
        inputs = (clips, tubes)
    else:
        detect = make_detect_fn(model)
        inputs = (clips,)
    eager = getattr(detect, "eager", detect)
    traced = eager if args.eager else detect

    def request():
        return traced(*inputs)

    hand: Dict[str, roofline.Work] = {}
    for i in range(args.warmup):
        if i == args.warmup - 1:
            with hand_kernel_work(hand):
                force_outputs(eager(*inputs))
        else:
            force_outputs(request())
    with trace(outdir, device=dev, record_shapes=True,
               with_flops=True) as prof:
        for _ in range(args.iters):
            force_outputs(request())
    size = torch.finfo(compute_dtype(cfg)).bits // 8
    ops = torch_op_work(prof.events(), size)
    kernels = {k: {"flops": w.flops / args.iters,
                   "bytes": w.n_bytes / args.iters, "kind": w.kind,
                   "source": "torch op counters"} for k, w in ops.items()}
    kernels.update({k: {"flops": w.flops, "bytes": w.n_bytes, "kind": w.kind,
                        "source": "utils/roofline"} for k, w in hand.items()})
    doc = {"iters": args.iters, "config": MAIN_CFG, "opts": args.opts,
           "captured": traced is not eager,
           "bucket": args.bucket, "batch": args.batch, "mix": args.mix,
           "device": (torch.cuda.get_device_name(0) if dev == "cuda"
                      else "cpu"),
           "card": card_line() if dev == "cuda" else "n/a",
           "kernels": kernels}
    with open(os.path.join(outdir, "work.json"), "w") as f:
        json.dump(doc, f, indent=1)
    print(f"trace written to {outdir} ({doc['card']}); {len(kernels)} "
          "kernel groups with work", flush=True)
    return outdir


if __name__ == "__main__":
    main(sys.argv[1:])
