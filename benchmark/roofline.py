"""Published peaks of the card and the least time a kernel's work takes
(frozen copy of the system's `utils/roofline.py` as it stood when the
benchmark was written, with the benchmark's own RoIAlign taps).

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the memory rate, and its
operations over the peak rate of their kind. Where the work depends on the
data (the map cells RoIAlign's corners touch), the bytes are what these
inputs need. The peaks are NVIDIA's published dense rates at the full
700 W; a card set lower runs slower, so every share is printed with the
card's power limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from .reference import ops


@dataclass(frozen=True)
class Peaks:
    name: str
    bf16_flops: float
    f32_flops: float
    bytes_per_s: float
    tf32_flops: float

    def flops(self, kind: str) -> float:
        return {"bf16": self.bf16_flops, "tf32": self.tf32_flops,
                "f32": self.f32_flops}[kind]


H100_SXM = Peaks("H100 SXM", 989e12, 67e12, 3.35e12, 495e12)


def peaks_for(device_name: str) -> Peaks:
    """The H100 SXM's peaks; raises for any other card."""
    if "H100" in device_name and not any(v in device_name
                                         for v in ("PCIe", "NVL")):
        return H100_SXM
    raise ValueError(f"no published peaks for {device_name!r}")


@dataclass(frozen=True)
class Work:
    n_bytes: float
    flops: float
    kind: str = "f32"

    def __add__(self, other: "Work") -> "Work":
        if self.kind != other.kind:
            raise ValueError(f"cannot add {self.kind} and {other.kind} work")
        return Work(self.n_bytes + other.n_bytes, self.flops + other.flops,
                    self.kind)


def bound_ms(work: Work, peaks: Peaks = H100_SXM) -> float:
    """The least milliseconds the card could take for `work`."""
    return max(work.n_bytes / peaks.bytes_per_s,
               work.flops / peaks.flops(work.kind)) * 1e3


def conv1_flops(shape: Sequence[int], t: int) -> float:
    """conv1 on a (B, T, H, W, 3) clip at t temporal taps: 2 per
    multiply-add of its 7 x 7 x 3 x 64 kernel at stride 2."""
    b, nt, h, w, _ = shape
    return 2.0 * b * nt * ((h + 1) // 2) * ((w + 1) // 2) * 64 * t * 49 * 3


def conv1_work(shape: Sequence[int], t: int, elem_bytes: int = 2) -> Work:
    """conv1 in bf16 on the tensor cores: the clip and the kernel read once,
    the output written once."""
    b, nt, h, w, _ = shape
    outs = b * nt * ((h + 1) // 2) * ((w + 1) // 2) * 64
    n_bytes = (b * nt * h * w * 3 + t * 49 * 3 * 64 + outs) * elem_bytes
    return Work(n_bytes, conv1_flops(shape, t), "bf16")


def roi_align_flops(n: int, p: int, c: int, s: int = 2) -> float:
    """2 per bilinear corner of each of the s x s samples of a bin."""
    return float(n * p * p * c * s * s * 4 * 2)


def roi_align_work(shapes: Sequence[Sequence[int]], strides: Sequence[int],
                   rois: torch.Tensor, slabs: torch.Tensor,
                   levels: torch.Tensor, p: int, elem_bytes: int = 2
                   ) -> Work:
    """The forward on these rois: the distinct map cells their samples'
    corners need (nonzero weight) read once, the rois and levels read once,
    the output written once; on the CUDA cores."""
    taps = ops.roi_taps(shapes, strides, rois.float(), slabs, levels, p, 2)
    cells = torch.unique(torch.cat([idx[w != 0] for idx, w in taps]))
    n, c = rois.shape[0], shapes[0][3]
    n_bytes = (cells.numel() + n * p * p) * c * elem_bytes + n * 5 * 4
    return Work(float(n_bytes), roi_align_flops(n, p, c))


def roi_align_backward_work(n: int, p: int, c: int,
                            shapes: Sequence[Sequence[int]],
                            elem_bytes: int = 2) -> Work:
    """The backward of n rois: the gradient read once, the level maps
    written once, each pair's roi, slab and level read once (24 bytes) and
    its key and footprint written once (20 bytes); 2 FLOP per corner tap of
    each sample and ~10 a sample position for the keys and footprints."""
    maps = sum(a * b * h * w for a, b, h, w in shapes)
    n_bytes = (n * p * p * c + maps) * elem_bytes + n * (24 + 24 + 20)
    return Work(float(n_bytes), roi_align_flops(n, p, c) + n * 2 * p * 2 * 10)
