"""Anchor generation — 2D grids and T-frame tube anchors (the port's copy
of detectandtrack_tpu/ops/anchors.py, held equal to it by
`tests/test_torch_port_copies.py`).

Reference parity: `lib/modeling/generate_anchors.py` (SURVEY.md §2.1): the
classic Faster R-CNN scale/aspect enumeration, extended for DetectAndTrack's
tube proposals where each anchor spans T frames (the same spatial box
replicated per frame; the RPN then regresses 4·T per-frame deltas → a tube).

Everything here is host-side numpy executed once at model-build time; the
resulting constant anchor fields become tensors on the model's device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def generate_anchors(
    stride: int = 16,
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """Anchor windows (A, 4) centered on a stride×stride cell, x1y1x2y2.

    Matches the Detectron-lineage enumeration: base anchor [0, 0, s-1, s-1],
    aspect-ratio enumeration with rounding, then scale enumeration.
    """
    return _generate_anchors(
        stride,
        np.asarray(sizes, dtype=np.float64) / stride,
        np.asarray(aspect_ratios, dtype=np.float64),
    )


def _generate_anchors(base_size, scales, aspect_ratios):
    anchor = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    anchors = _ratio_enum(anchor, aspect_ratios)
    anchors = np.vstack(
        [_scale_enum(anchors[i, :], scales) for i in range(anchors.shape[0])]
    )
    return anchors.astype(np.float32)


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, np.newaxis]
    hs = hs[:, np.newaxis]
    return np.hstack(
        [
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        ]
    )


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = w * scales
    hs = h * scales
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def shifted_anchor_field(
    anchors: np.ndarray, stride: int, fm_height: int, fm_width: int
) -> np.ndarray:
    """Tile cell anchors over an H×W feature map → (H·W·A, 4).

    Row-major over (y, x, anchor) — this ordering is the contract shared with
    the RPN head's output reshape (see models/rpn.py).
    """
    shift_x = np.arange(fm_width, dtype=np.float32) * stride
    shift_y = np.arange(fm_height, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    field = anchors[np.newaxis, :, :] + shifts[:, np.newaxis, :]
    return field.reshape(-1, 4).astype(np.float32)


def fpn_anchor_fields(
    sizes: Sequence[float],
    aspect_ratios: Sequence[float],
    min_level: int,
    max_level: int,
    image_hw: Tuple[int, int],
) -> Tuple[Tuple[np.ndarray, ...], Tuple[int, ...]]:
    """Per-FPN-level anchor fields for a fixed image shape.

    Level l has stride 2**l and one anchor size `sizes[l - min_level]` with
    all aspect ratios (Detectron FPN convention: one octave per level).
    Returns (fields, strides); fields[i] is ((H_l·W_l·A), 4).
    """
    h, w = image_hw
    fields = []
    strides = []
    for i, lvl in enumerate(range(min_level, max_level + 1)):
        stride = 2 ** lvl
        cell = generate_anchors(stride, [sizes[i]], aspect_ratios)
        fh = -(-h // stride)  # ceil — matches conv feature-map sizing
        fw = -(-w // stride)
        fields.append(shifted_anchor_field(cell, stride, fh, fw))
        strides.append(stride)
    return tuple(fields), tuple(strides)


def tube_anchors(anchors_2d: np.ndarray, num_frames: int) -> np.ndarray:
    """Extend (A, 4) spatial anchors to (A, 4·T) tube anchors.

    DetectAndTrack tube proposals (paper §3.2): an anchor is the same box in
    every one of the T frames; the regressor predicts per-frame deltas.
    """
    return np.tile(anchors_2d, (1, num_frames))
