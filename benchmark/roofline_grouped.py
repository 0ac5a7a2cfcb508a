"""The least time of a ResNeXt bottleneck's grouped 3x3 conv with its
epilogue (`roofline.py`'s rule, peaks and `bound_ms`): the same work
whatever implements the conv.

`grouped_conv_work(shape, groups, stride)`: the input (N, H, W, C) read
once, the f32 weights (C, C / groups, 3, 3) and the frozen-BN scale and
bias read once, the output (N, Ho, Wo, C) written once, in bfloat16; 2
FLOP per multiply-add, 9 · C / groups of them per output, on the bf16
tensor cores. Same-padding: Ho = (H - 1) // stride + 1.

`sites(cfg, n, hw)`: (shape, groups, stride) of each grouped 3x3 conv of
the configuration's body on n frames of hw, in the order they run.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .reference.model import STAGE_BLOCKS
from .roofline import Work


def grouped_conv_work(shape: Sequence[int], groups: int, stride: int
                      ) -> Work:
    n, h, w, c = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    outs = n * ho * wo * c
    n_bytes = (n * h * w * c + outs) * 2 + (c * (c // groups) * 9
                                            + 2 * c) * 4
    return Work(float(n_bytes), 2.0 * outs * 9 * (c // groups), "bf16")


def sites(cfg: Dict, n: int, hw: Tuple[int, int]
          ) -> List[Tuple[Tuple[int, int, int, int], int, int]]:
    res = cfg["RESNETS"]
    groups = res["NUM_GROUPS"]
    width = res["WIDTH_PER_GROUP"] * groups
    # conv1 (7x7, stride 2, pad 3), then the 3x3 stride-2 max-pool
    h, w = [((v + 1) // 2 - 1) // 2 + 1 for v in hw]
    out = []
    for stage, blocks in enumerate(STAGE_BLOCKS[cfg["MODEL"]["CONV_BODY"]]):
        inner = width * 2 ** stage
        for bi in range(blocks):
            s = 2 if stage > 0 and bi == 0 else 1
            if res["STRIDE_1X1"] and s == 2:
                h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
                s = 1
            out.append(((n, h, w, inner), groups, s))
            h, w = (h - 1) // s + 1, (w - 1) // s + 1
    return out
