"""The card's peak rates and the least time ("bound") a kernel's work takes.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate, and
the operations it does over the card's peak rate for their type. Where the
work depends on the data (the RoIAlign corners a run's rois touch, the
patches the diagnostic kernel's pairs read), the bytes are what this run's
data needs. `chip_smoke.py` and the tools under `tools/` compute every bound
here, so a kernel's bound is the same number wherever it is printed.

The peaks are published dense rates (NVIDIA's data sheets) at the card's
full power limit; a card set below it runs slower under load, so every
share is printed beside the card's `nvidia-smi` name and power limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch


@dataclass(frozen=True)
class Peaks:
    name: str
    bf16_flops: float         # dense bf16 tensor-core FLOP/s
    f32_flops: float          # f32 FLOP/s on the CUDA cores
    bytes_per_s: float        # device memory bandwidth
    tf32_flops: float         # dense TF32 tensor-core FLOP/s

    def flops(self, kind: str) -> float:
        """The peak FLOP/s of one operation kind (see `Work`)."""
        rates = {"bf16": self.bf16_flops, "tf32": self.tf32_flops,
                 "f32": self.f32_flops}
        if kind not in rates:
            raise ValueError(f"unknown operation kind {kind!r}")
        return rates[kind]


H100_SXM = Peaks("H100 SXM", 989e12, 67e12, 3.35e12, 495e12)


def peaks_for(device_name: str) -> Peaks:
    """The peaks of the card `torch.cuda.get_device_name` names: an H100
    SXM ("NVIDIA H100 80GB HBM3"); raises for any other card (the PCIe and
    NVL parts have other peaks)."""
    if "H100" in device_name and not any(
            v in device_name for v in ("PCIe", "NVL")):
        return H100_SXM
    raise ValueError(f"no published peaks for {device_name!r}")


@dataclass(frozen=True)
class Work:
    """What one call must do: bytes moved and operations of one kind
    ("bf16": tensor-core eligible bf16 products, "tf32": TF32 tensor-core
    products, "f32": CUDA-core f32)."""
    n_bytes: float
    flops: float
    kind: str = "f32"

    def __add__(self, other: "Work") -> "Work":
        if self.kind != other.kind:
            raise ValueError(f"cannot add {self.kind} and {other.kind} work")
        return Work(self.n_bytes + other.n_bytes, self.flops + other.flops,
                    self.kind)


def bound(work: Work, peaks: Peaks = H100_SXM) -> Tuple[float, str]:
    """(least milliseconds the card could take, "bytes" or "operations")."""
    by_bytes = work.n_bytes / peaks.bytes_per_s * 1e3
    by_ops = work.flops / peaks.flops(work.kind) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def _size(dtype) -> int:
    return 2 if str(dtype).endswith("bfloat16") else 4


def conv1_flops(shape: Sequence[int], t: int) -> float:
    """The model FLOPs of conv1 on a (B, T, H, W, 3) clip at t temporal
    taps: 2 per multiply-add, the count of the plain F.conv3d."""
    b, nt, h, w, _ = shape
    return 2.0 * b * nt * ((h + 1) // 2) * ((w + 1) // 2) * 64 * t * 49 * 3


def roi_align_flops(n: int, p: int, c: int, s: int = 2) -> float:
    """K1's / K3's forward FLOPs for n rois at P x P bins of C channels:
    2 per bilinear corner of each of the s x s samples of a bin."""
    return float(n * p * p * c * s * s * 4 * 2)


def backward_flops(grad_elems: int, s: int = 2) -> float:
    """The RoIAlign backward's FLOPs: 2 per corner tap of each of the
    s x s samples behind every grad element."""
    return float(grad_elems * s * s * 4 * 2)


def conv1_work(shape: Sequence[int], t: int, dtype,
               peaks: Peaks = H100_SXM) -> Work:
    """conv1 on a (B, T, H, W, 3) clip: x and k7 read once, the output
    written once; 2 FLOP per multiply-add. bf16 runs on the tensor cores.
    f32 takes the smaller of two operation bounds on `peaks`: three TF32
    products per multiply-add (the 3-pass split big*big + big*small +
    small*big that keeps f32 accuracy) or one f32 FMA on the CUDA cores
    (on an H100 3 / 495 TFLOP/s is below 1 / 67: TF32)."""
    b, nt, h, w, _ = shape
    size = _size(dtype)
    outs = b * nt * ((h + 1) // 2) * ((w + 1) // 2) * 64
    n_bytes = (b * nt * h * w * 3 + t * 49 * 3 * 64 + outs) * size
    flops = conv1_flops(shape, t)
    if size == 2:
        return Work(n_bytes, flops, "bf16")
    return min(Work(n_bytes, 3 * flops, "tf32"), Work(n_bytes, flops, "f32"),
               key=lambda w: w.flops / peaks.flops(w.kind))


def affine_work(y_elems: int, c: int, dtype, shortcut_elems: int = 0,
                scale: bool = True, shortcut_affine: bool = False) -> Work:
    """The conv epilogue (`kernels/affine.py`) over y_elems values of C
    channels: y read and written, a shortcut of shortcut_elems values read,
    each f32 (C,) parameter read once; 2 FLOP a value for the affine (1 for
    a bias alone), 1 for the add, 2 more for a shortcut's affine, on the
    CUDA cores (the ReLU's compare is not counted)."""
    size = _size(dtype)
    params = 1 + scale + 2 * shortcut_affine
    n_bytes = (2 * y_elems + shortcut_elems) * size + params * c * 4
    flops = y_elems * (1 + scale + (shortcut_elems > 0)
                       + 2 * shortcut_affine)
    return Work(n_bytes, float(flops), "f32")


def roi_align_work(shapes: Sequence[Sequence[int]], strides: Sequence[int],
                   rois: torch.Tensor, slabs: torch.Tensor,
                   levels: torch.Tensor, p: int, dtype) -> Work:
    """K1's / K3's forward on this run's rois: the distinct map cells
    their samples' bilinear corners need (nonzero weight), each read once,
    the rois and levels, and the output written once; 2 FLOP per corner of
    each sample (s=2), on the CUDA cores."""
    from ..kernels import roi_align as ra
    taps = ra._taps(shapes, strides, rois.cpu().float(), slabs.cpu(),
                    levels.cpu(), p, 2)
    cells = torch.unique(torch.cat([idx[w != 0] for idx, w in taps]))
    n, c = rois.shape[0], shapes[0][3]
    size = _size(dtype)
    n_bytes = (cells.numel() + n * p * p) * c * size + n * 5 * 4
    return Work(n_bytes, roi_align_flops(n, p, c))


def backward_work(grad: torch.Tensor, shapes: Sequence[Sequence[int]],
                  dtype) -> Work:
    """The RoIAlign backward: grad read once, the level maps written once
    in `dtype`, the pairs' rois, slabs and levels read once; 2 FLOP per
    corner tap (16 taps per grad element at s=2) on the CUDA cores."""
    n_bytes = (grad.numel() * grad.element_size()
               + sum(a * b * c * d for a, b, c, d in shapes) * _size(dtype)
               + grad.shape[0] * 24)
    return Work(n_bytes, backward_flops(grad.numel()))


def backward_prep_work(n: int, p: int) -> Work:
    """The backward's prep kernel: n pairs' rois, slabs and levels read and
    their keys and footprints written once; ~10 FLOP per sample position."""
    return Work(n * (24 + 20), n * 2 * p * 2 * 10)


def diag_work(patch_cells: int, n: int, p: int, c: int,
              variant: str) -> Work:
    """The diagnostic kernel (kernels/diag_roialign.py) on n pairs:
    `patch_cells` distinct (level, row, column) map cells its pairs' 64x64
    patches cover, each read once (none for "nodma", which reads no map),
    the rois (4n f32) and levels (n int32) read once, the (n, p, p, c) bf16
    output written once. The contractions are bf16 products (tensor-core
    eligible): per pair 2·p·64·64·c + 2·p·64·p·c FLOP; "nodot" adds once
    per output element."""
    n_bytes = (0 if variant == "nodma" else patch_cells * c * 2) + (
        n * p * p * c * 2 + n * 20)
    if variant == "nodot":
        return Work(n_bytes, n * p * p * c)
    return Work(n_bytes, n * (2 * p * 64 * 64 * c + 2 * p * 64 * p * c),
                "bf16")


IOU_OPS = 15       # bbox_overlaps' f32 operations a pair and the compare:
                   # 4 max/min, 2 sub, 2 add, 2 clamp, 1 mul, 1 add,
                   # 1 sub, 1 div, 1 compare (areas counted per box)


def nms_keep_work(lanes: int, n: int) -> Work:
    """Greedy NMS from score-sorted boxes to the keep mask over `lanes`
    lanes of n boxes: the boxes (16 bytes) and validity read once, the keep
    mask written once; the IoU test of every earlier-later pair (IOU_OPS
    each) and every box's area (4). The sweep's OR words are bit
    operations on the decided boxes, not counted."""
    return Work(lanes * n * 18, lanes * (n * (n - 1) // 2 * IOU_OPS + 4 * n),
                "f32")


def soft_nms_confirm_work(lanes: int, n: int, decays: int, compares: int,
                          multiplies: int) -> Work:
    """Soft-NMS's confirmation over `lanes` lanes of n boxes, as this run's
    data needs it (counted by the caller, round by round): scores (f32),
    alive and overlaps (bytes) read once, final scores written once, and of
    dmat only the `decays` entries the rounds multiply in (4 bytes each:
    a newly confirmed box's decay of an alive overlapper still
    unconfirmed); `compares` outrank tests of an unconfirmed alive box
    against its unconfirmed alive overlappers, `multiplies` decay and
    chunk-product multiplications of the chunk products a newly confirmed
    box changes."""
    return Work(lanes * n * (n + 9) + 4 * decays, compares + multiplies,
                "f32")
