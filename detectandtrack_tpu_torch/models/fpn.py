"""Feature Pyramid Network on (B, T, H, W, C) activations (port of
detectandtrack_tpu/models/fpn.py): 1x1 laterals, nearest ×2 top-down, 3x3
posthoc convs, and P6 as a stride-2 subsample of P5 or, with
FPN.EXTRA_CONV_LEVELS, a stride-2 3x3 conv on P5."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .backbone import Conv3d

_STAGES = ("res2", "res3", "res4", "res5")       # strides 4..32


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) → (B, T, 2H, 2W, C) nearest."""
    b, t, h, w, c = x.shape
    x = x[:, :, :, None, :, None, :].expand(b, t, h, 2, w, 2, c)
    return x.reshape(b, t, 2 * h, 2 * w, c)


class FPN(nn.Module):
    """{res2..res5} → {p2..p6}; every level has `dim` channels."""

    def __init__(self, in_dims: Dict[str, int], dim: int = 256,
                 zero_init_lateral: bool = False,
                 extra_conv_levels: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.extra_p6 = (Conv3d(dim, dim, (1, 3, 3), (1, 2, 2), use_bias=True,
                                dtype=dtype) if extra_conv_levels else None)
        for n in _STAGES:
            self.add_module(f"lateral_{n}", Conv3d(
                in_dims[n], dim, (1, 1, 1), use_bias=True, dtype=dtype,
                init_std=0.0 if zero_init_lateral else None))
        for lvl in ("p2", "p3", "p4", "p5"):
            self.add_module(f"posthoc_{lvl}", Conv3d(
                dim, dim, (1, 3, 3), use_bias=True, dtype=dtype))

    def forward(self, feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        laterals = [getattr(self, f"lateral_{n}")(feats[n]) for n in _STAGES]
        td = laterals[-1]
        outs = {"p5": td}
        for i in range(len(_STAGES) - 2, -1, -1):
            td = laterals[i] + upsample_nearest_2x(td)
            outs[f"p{i + 2}"] = td
        for lvl in ("p2", "p3", "p4", "p5"):
            outs[lvl] = getattr(self, f"posthoc_{lvl}")(outs[lvl])
        outs["p6"] = (self.extra_p6(outs["p5"]) if self.extra_p6 is not None
                      else outs["p5"][:, :, ::2, ::2])
        return outs
