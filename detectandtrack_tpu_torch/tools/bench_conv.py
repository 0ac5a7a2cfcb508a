"""Time the main path's hot convolutions alone.

    python3 -m detectandtrack_tpu_torch.tools.bench_conv [kps|conv1|res2|all]
        [iters] [--device cuda|cpu] [--batch B] [--n N] [--size HxW]

Port of tools/bench_conv.py, model-faithful variants only, bf16, each
through the module the port's model runs:

  kps    the keypoint head's 3x3 conv, (N, 14, 14, 512) -> 512 with bias
         (N = B·T·rois: 2 clips x 8 frames x the top 20 detections = 320
         on the main path), through cuDNN: as is (`asis`), and with a
         frozen-BN affine and ReLU after it (`affine_relu`);
  conv1  conv1 on a (B, 8, 800, 1344, 3) clip at t=3: the port's
         tensor-core kernel (K2, `kernels/conv1.py`), one F.conv3d call
         (cuDNN) on the padded input, and K2 followed by the model's
         frozen-BN affine and ReLU (`Conv1` + relu, the backbone's stem);
         the last two rows' difference is what fusing that epilogue into
         K2 could save at most;
  res2   res2's 3x3x3 temporal conv, (B, 8, 200, 336, 64) -> 64, through
         cuDNN (the port's `Conv3d`);
  grouped  the ResNeXt-101 64x4d body's grouped 3x3 convs with their
         frozen-BN affine and ReLU, on B frames (default 16) of the size:
         each stage's stride-1 site (groups of 4, 8, 16, 32 channels) and
         the stride-2 first sites of res3-res5, as `grouped_conv3x3`'s
         kernel (`kernel`), cuDNN's grouped conv + the epilogue pass
         (`cudnn+pass`, what the sites ran before) and the plain version
         (`plain`); each row adds its bound (`utils/roofline.
         grouped_conv_work`) and share.

Each row prints milliseconds per call (CUDA events, `utils/profiling`),
achieved TFLOP/s and the % of the card's dense bf16 peak (by device name,
`utils/roofline.peaks_for`: 989 TFLOP/s on an H100 SXM), beside the card's
`nvidia-smi` name and power limit. The JAX tool's pad16, plane and dots9
forms and its space-to-depth conv1 variants were TPU matrix-unit
reformulations and have no counterpart. `--device cpu` runs the same
modules small (host times, no peak share).
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from ..kernels.affine import affine_epilogue
from ..kernels.conv1 import conv1
from ..kernels.grouped_conv import (grouped_conv3x3,
                                    grouped_conv3x3_reference)
from ..models.backbone import AffineChannel, Conv1, Conv3d
from ..utils import roofline
from ..utils.env import card_line
from ..utils.profiling import time_call

BF16 = torch.bfloat16


def _init(module, seed):
    """Seeded random parameters (on the CPU, before the move)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return module


def _rows(variants, iters, peaks):
    rows = []
    for name, fn, args, flops, *work in variants:
        with torch.inference_mode():
            t = time_call(fn, *args, iters=iters, warmup=2)
        row = {"name": name, "ms": t.seconds * 1e3, "tflops": None,
               "pct_peak": None}
        line = f"{name:>24}: {row['ms']:8.3f} ms"
        if peaks is not None:         # rates of the card only
            row["tflops"] = flops / t.seconds / 1e12
            row["pct_peak"] = 100 * flops / t.seconds / peaks.bf16_flops
            line += (f" {row['tflops']:8.2f} TFLOP/s {row['pct_peak']:5.1f}%"
                     " of peak")
            if work:
                row["bound_ms"], row["bound_by"] = roofline.bound(work[0],
                                                                  peaks)
                row["pct_bound"] = 100 * row["bound_ms"] / row["ms"]
                line += (f"; bound {row['bound_ms']:.3f} ms "
                         f"({row['bound_by']}) {row['pct_bound']:5.1f}%")
        print(line, flush=True)
        rows.append(row)
    return rows


def bench_kps(dev, n, gen):
    conv = _init(Conv3d(512, 512, (1, 3, 3), use_bias=True, dtype=BF16),
                 1).to(dev)
    affine = _init(AffineChannel(512, BF16), 2).to(dev)
    x = torch.randn((n, 1, 14, 14, 512), generator=gen, device=dev).to(BF16)
    flops = 2.0 * n * 14 * 14 * 512 * 512 * 9
    return [(f"kps asis N={n}", conv, (x,), flops),
            (f"kps affine_relu N={n}", lambda v: F.relu(affine(conv(v))),
             (x,), flops)]


def bench_conv1(dev, b, hw, gen):
    h, w = hw
    stem = _init(Conv1(3, BF16), 3).to(dev)
    x = torch.randn((b, 8, h, w, 3), generator=gen, device=dev)
    k7 = stem.conv.weight
    xp = F.pad(x.to(BF16).permute(0, 4, 1, 2, 3), (3, 3, 3, 3, 1, 1))
    wt = k7.to(BF16).permute(4, 3, 0, 1, 2).contiguous()
    flops = roofline.conv1_work(x.shape, 3, BF16).flops
    return [(f"conv1 K2 B={b}", lambda v: conv1(v, k7, 3, BF16), (x,), flops),
            (f"conv1 F.conv3d B={b}", lambda v: F.conv3d(v, wt,
                                                          stride=(1, 2, 2)),
             (xp.contiguous(),), flops),
            (f"conv1 K2+affine+relu B={b}", lambda v: F.relu(stem(v)), (x,),
             flops)]


def bench_res2(dev, b, hw, gen):
    h, w = hw[0] // 4, hw[1] // 4
    conv = _init(Conv3d(64, 64, (3, 3, 3), dtype=BF16), 4).to(dev)
    x = torch.randn((b, 8, h, w, 64), generator=gen, device=dev).to(BF16)
    flops = 2.0 * b * 8 * h * w * 64 * 64 * 27
    return [(f"res2 3x3x3 B={b}", conv, (x,), flops)]


# (stage, channels, stride, input H and W as a share of the frame's) of the
# ResNeXt-101 64x4d body's grouped 3x3 sites at 64 groups: each stage's
# stride-1 site, then the stride-2 first sites of res3-res5.
GROUPED_SITES = [("res2", 256, 1, 4), ("res3", 512, 1, 8),
                 ("res4", 1024, 1, 16), ("res5", 2048, 1, 32),
                 ("res3_0", 512, 2, 4), ("res4_0", 1024, 2, 8),
                 ("res5_0", 2048, 2, 16)]


def bench_grouped(dev, b, hw, gen):
    out = []
    for i, (name, c, s, div) in enumerate(GROUPED_SITES):
        h, w = -(-hw[0] // div), -(-hw[1] // div)
        conv = _init(Conv3d(c, c, (1, 3, 3), (1, s, s), dtype=BF16,
                            groups=64), 10 + i).to(dev)
        bn = _init(AffineChannel(c, BF16), 20 + i).to(dev)
        x = torch.randn((b, 1, h, w, c), generator=gen, device=dev).to(BF16)
        work = roofline.grouped_conv_work((b, h, w, c), 64, s)
        args = (conv.weight, bn.scale, bn.bias, s)
        tag = f"{name} {c // 64}/group s={s} B={b}"
        out += [
            (f"{tag} kernel", lambda v, a=args: grouped_conv3x3(
                v, *a, relu=True), (x,), work.flops, work),
            (f"{tag} cudnn+pass", lambda v, m=conv, n=bn: affine_epilogue(
                m(v), n.scale, n.bias, relu=True), (x,), work.flops, work),
            (f"{tag} plain", lambda v, a=args: grouped_conv3x3_reference(
                v, *a, relu=True), (x,), work.flops, work)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("kps", "conv1", "res2", "grouped", "all"))
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=None,
                    help="clips (default 2), or frames for grouped "
                    "(default 16)")
    ap.add_argument("--n", type=int, default=320,
                    help="keypoint-head rois (B·T·top detections)")
    ap.add_argument("--size", default="800x1344")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_conv: no CUDA device (--device cpu runs the "
                         "modules on the CPU)")
    dev = args.device
    hw = tuple(int(v) for v in args.size.split("x"))
    peaks = (roofline.peaks_for(torch.cuda.get_device_name(0))
             if dev == "cuda" else None)
    where = (f"{card_line()}; {peaks.name} bf16 peak "
             f"{peaks.bf16_flops / 1e12:.0f} TFLOP/s" if peaks else
             "cpu: host times, conv1 through its plain version")
    print(f"bench_conv: bf16 ({where})", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    variants = []
    batch = args.batch or 2
    if args.which in ("kps", "all"):
        variants += bench_kps(dev, args.n, gen)
    if args.which in ("conv1", "all"):
        variants += bench_conv1(dev, batch, hw, gen)
    if args.which in ("res2", "all"):
        variants += bench_res2(dev, batch, hw, gen)
    if args.which == "grouped":
        variants += bench_grouped(dev, args.batch or 16, hw, gen)
    return _rows(variants, args.iters, peaks)


if __name__ == "__main__":
    main(sys.argv[1:])
