"""Tube-RPN head and fixed-budget proposal helpers (port of
detectandtrack_tpu/models/rpn.py). Anchors come from the port's numpy
module `ops/anchors.py`."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops.anchors import generate_anchors
from .backbone import Conv3d


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ties broken toward the lower index, as
    `jax.lax.top_k` does (`torch.topk` does not promise an order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class RPNHead(nn.Module):
    """Shared 3x3 trunk on time-mean-pooled features + objectness / 4T tube
    delta predictors; weights shared across FPN levels. `in_dim` is the
    feature width, `dim` the trunk's (FPN: both FPN.DIM; C4: res4's width
    into a 1024-wide trunk)."""

    def __init__(self, in_dim: int, dim: int = 256, num_anchors: int = 3,
                 num_frames: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3d(in_dim, dim, (1, 3, 3), use_bias=True, dtype=dtype,
                           init_std=0.01)
        self.logits = Conv3d(dim, num_anchors, (1, 1, 1), use_bias=True,
                             dtype=dtype, init_std=0.01)
        self.deltas = Conv3d(dim, num_anchors * 4 * num_frames, (1, 1, 1),
                             use_bias=True, dtype=dtype, init_std=0.01)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, H, W, C) → logits (B, H, W, A), deltas (B, H, W, A·4T)."""
        x = x.mean(dim=1, keepdim=True)
        h = F.relu(self.conv(x))
        return self.logits(h)[:, 0], self.deltas(h)[:, 0]


def flatten_rpn_outputs(logits: torch.Tensor, deltas: torch.Tensor,
                        num_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,H,W,A), (B,H,W,A·4T) → (B, H·W·A), (B, H·W·A, 4T), row-major
    (y, x, anchor) to match `anchors.shifted_anchor_field`."""
    b = logits.shape[0]
    return logits.reshape(b, -1), deltas.reshape(b, -1, 4 * num_frames)


def decode_tube_proposals(anchors: torch.Tensor, deltas: torch.Tensor,
                          image_hw: Tuple[float, float], num_frames: int
                          ) -> torch.Tensor:
    """Per-frame decode against replicated anchors (..., N, 4) with deltas
    (..., N, 4T) → clipped tubes (..., N, 4T)."""
    tube_anchors = anchors.repeat((1,) * (anchors.dim() - 1) + (num_frames,))
    boxes = box_ops.bbox_transform(tube_anchors, deltas)
    return box_ops.clip_boxes(boxes, image_hw[0], image_hw[1])


def center_frame_box(tubes: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Representative 2D box of a tube (center frame) for NMS."""
    c = (num_frames // 2) * 4
    return tubes[..., c:c + 4]


def anchor_cell_for_level(cfg, level_index: int, stride: int):
    """Per-level anchor cell: one RPN.SIZES entry per FPN level, or the
    whole RPN.SIZES set on the single C4 level."""
    sizes = ([cfg.RPN.SIZES[level_index]] if cfg.FPN.FPN_ON
             else cfg.RPN.SIZES)
    return generate_anchors(stride, sizes, cfg.RPN.ASPECT_RATIOS)


def collect_fpn_proposals(tubes: Sequence[torch.Tensor],
                          scores: Sequence[torch.Tensor],
                          valid: Sequence[torch.Tensor], max_out: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge per-level (B, K_l, ...) proposals and keep the global top
    `max_out` per batch row → (tubes, scores, valid)."""
    tubes = torch.cat(list(tubes), dim=1)
    scores = torch.cat(list(scores), dim=1)
    valid = torch.cat(list(valid), dim=1)
    masked = torch.where(valid, scores,
                         torch.full_like(scores, float("-inf")))
    k = min(max_out, masked.shape[1])
    top_scores, idx = topk_stable(masked, k)
    top_tubes = torch.gather(
        tubes, 1, idx[..., None].expand(-1, -1, tubes.shape[-1]))
    top_valid = torch.gather(valid, 1, idx) & torch.isfinite(top_scores)
    return top_tubes, top_scores, top_valid
