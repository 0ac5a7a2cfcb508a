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
         cuDNN (the port's `Conv3d`).

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

from ..kernels.conv1 import conv1
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
    for name, fn, args, flops in variants:
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("kps", "conv1", "res2", "all"))
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=2)
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
    if args.which in ("kps", "all"):
        variants += bench_kps(dev, args.n, gen)
    if args.which in ("conv1", "all"):
        variants += bench_conv1(dev, args.batch, hw, gen)
    if args.which in ("res2", "all"):
        variants += bench_res2(dev, args.batch, hw, gen)
    return _rows(variants, args.iters, peaks)


if __name__ == "__main__":
    main(sys.argv[1:])
