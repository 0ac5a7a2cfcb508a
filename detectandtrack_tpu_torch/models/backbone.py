"""ResNet backbones, 2D and inflated-3D, as torch modules.

Port of detectandtrack_tpu/models/backbone.py with one exact path per op.
Activations are (B, T, H, W, C) at every module boundary, as in the JAX
package. Inside, a conv views them as NCHW (t = 1: batch B·T) or NCTHW —
both zero-copy channels-last views — and runs F.conv2d / F.conv3d. Params
stay f32 and are cast to the compute dtype at use, like the flax modules.

The elementwise work after each conv — its frozen-BN affine or bias, the
residual or top-down add, the ReLU — runs through `conv_epilogue`: where no
gradient is needed (`kernels/affine.py::wants_grad`) it is one pass of
`affine_epilogue` over the conv's output, or, for a ResNeXt block's grouped
3x3 conv on the card, part of the conv's own kernel
(`kernels/grouped_conv.py`); with a gradient it is the op chain as autograd
sees it, each module's output the JAX module's of the same name.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import grouped_conv
from ..kernels.affine import affine_epilogue, wants_grad
from ..kernels.conv1 import conv1_autograd
from ..utils.profiling import scope

# Per-depth stage block counts (res2..res5).
STAGE_BLOCKS = {
    "resnet18": (2, 2, 2, 2),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}
BASIC_ARCHS = ("resnet18",)


def compute_dtype(cfg) -> torch.dtype:
    return (torch.bfloat16 if cfg.MODEL.COMPUTE_DTYPE == "bfloat16"
            else torch.float32)


def _msra_std(weight_shape_thwio: Sequence[int]) -> float:
    """flax variance_scaling(2.0, "fan_out", "normal") std for a kernel of
    shape (..., ci, co)."""
    receptive = math.prod(weight_shape_thwio[:-2])
    return math.sqrt(2.0 / (receptive * weight_shape_thwio[-1]))


class AffineChannel(nn.Module):
    """Frozen BatchNorm as per-channel scale + bias over the last axis."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(self.dtype) + self.bias.to(self.dtype)


def _chain(y: torch.Tensor, relu: bool = False,
           shortcut: Optional[torch.Tensor] = None,
           shortcut_affine: Optional[nn.Module] = None) -> torch.Tensor:
    """The op chain after a conv's bias or affine: + the shortcut (through
    `shortcut_affine`; nearest-upsampled ×2 where it is at half y's H and
    W), then the ReLU."""
    if shortcut is not None:
        if shortcut_affine is not None:
            shortcut = shortcut_affine(shortcut)
        if shortcut.shape != y.shape:          # the FPN's top-down add
            from .fpn import upsample_nearest_2x
            shortcut = upsample_nearest_2x(shortcut)
        y = y + shortcut
    return F.relu(y) if relu else y


class Conv3d(nn.Module):
    """(B, T, H, W, Cin) → (B, T', H', W', Cout) conv with window (t, kh, kw)
    and same-padding ((k-1)·d // 2, ((k-1)·d + 1) // 2) per axis.

    `init_std` None is MSRA fan_out (the backbone default), a float a
    gaussian of that std. The weight is (Cout, Cin/groups, t, kh, kw).
    `relu` and `shortcut` (at the output's shape, or at half its H and W
    for a nearest ×2 upsample) are its epilogue: with a bias and no
    gradient needed, one pass with the bias (`affine_epilogue`).
    """

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int, int] = (1, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 init_std: Optional[float] = None,
                 dilation: Tuple[int, int, int] = (1, 1, 1), groups: int = 1):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.dilation = tuple(dilation)
        self.groups = groups
        self.dtype = dtype
        self.init_std = init_std
        self.weight = nn.Parameter(
            torch.empty((features, cin // groups) + self.kernel))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.pads = [((k - 1) * d // 2, ((k - 1) * d + 1) // 2)
                     for k, d in zip(self.kernel, self.dilation)]

    def init_parameters(self, generator: torch.Generator) -> None:
        co, ci, t, kh, kw = self.weight.shape
        std = (self.init_std if self.init_std is not None
               else _msra_std((t, kh, kw, ci, co)))
        nn.init.normal_(self.weight, 0.0, std, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, relu: bool = False,
                shortcut: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        b, tt = x.shape[:2]
        per_frame = self.kernel[0] == 1 and self.strides[0] == 1
        if per_frame:           # a 4-D conv over the B·T frames
            xc = x.reshape((b * tt,) + x.shape[2:]).permute(0, 3, 1, 2)
            w, conv = w[:, :, 0], F.conv2d
            pads, strides, dil = self.pads[1:], self.strides[1:], \
                self.dilation[1:]
        else:
            xc = x.permute(0, 4, 1, 2, 3)
            conv = F.conv3d
            pads, strides, dil = self.pads, self.strides, self.dilation
        # Same-padding is (lo, lo) or (lo, lo + 1): the conv pads lo on both
        # sides, an explicit F.pad adds the odd one.
        extra = [v for lo, hi in reversed(pads) for v in (0, hi - lo)]
        if any(extra):
            xc = F.pad(xc, extra)
        y = conv(xc, w, None, strides, [lo for lo, _ in pads], dil,
                 self.groups).movedim(1, -1)
        if per_frame:
            y = y.reshape((b, tt) + y.shape[1:])
        if self.bias is None:
            return _chain(y, relu, shortcut)
        if not wants_grad(y, self.bias, shortcut):
            return affine_epilogue(y, None, self.bias, shortcut, relu=relu)
        return _chain(y + self.bias.to(self.dtype), relu, shortcut)


class ConvAffine(nn.Module):
    """conv → frozen-BN affine, then the `relu` and `shortcut` epilogue (a
    `shortcut_affine`, the projection's AffineChannel, applied to the
    shortcut); without a gradient one pass after the conv, or, for the
    grouped 3x3 convs `kernels/grouped_conv.takes`, one kernel that writes
    the epilogue itself."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int, int] = (1, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32,
                 dilation: Tuple[int, int, int] = (1, 1, 1), groups: int = 1):
        super().__init__()
        self.conv = Conv3d(cin, features, kernel, strides, dtype=dtype,
                           dilation=dilation, groups=groups)
        self.bn = AffineChannel(features, dtype)

    def forward(self, x: torch.Tensor, relu: bool = False,
                shortcut: Optional[torch.Tensor] = None,
                shortcut_affine: Optional[AffineChannel] = None
                ) -> torch.Tensor:
        if (shortcut_affine is None and grouped_conv.takes(self.conv, x,
                                                           shortcut)
                and not wants_grad(x, shortcut, params=self.parameters())):
            return grouped_conv.grouped_conv3x3(
                x, self.conv.weight, self.bn.scale, self.bn.bias,
                self.conv.strides[1], shortcut, relu)
        y = self.conv(x)
        sa = shortcut_affine
        rs, rb = (sa.scale, sa.bias) if sa is not None else (None, None)
        if not wants_grad(y, self.bn.scale, self.bn.bias, shortcut, rs, rb):
            return affine_epilogue(y, self.bn.scale, self.bn.bias, shortcut,
                                   rs, rb, relu)
        return _chain(self.bn(y), relu, shortcut, shortcut_affine)


class Conv1Kernel(nn.Module):
    """Holds conv1's canonical (t, 7, 7, 3, 64) kernel, the layout of the
    JAX package's `_Conv1Kernel` and of the conv1 kernel's input."""

    def __init__(self, time_kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(time_kernel, 7, 7, 3, 64))

    def init_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, 0.0, _msra_std(self.weight.shape),
                        generator=generator)


class Conv1(nn.Module):
    """conv1 (the hand-written kernel on CUDA) → frozen-BN affine → ReLU if
    `relu`; without a gradient one pass after the conv."""

    def __init__(self, time_kernel: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.time_kernel = time_kernel
        self.dtype = dtype
        self.conv = Conv1Kernel(time_kernel)
        self.bn = AffineChannel(64, dtype)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        y = conv1_autograd(x, self.conv.weight, self.time_kernel, self.dtype)
        if not wants_grad(y, self.bn.scale, self.bn.bias):
            return affine_epilogue(y, self.bn.scale, self.bn.bias,
                                   relu=relu)
        return _chain(self.bn(y), relu)


def conv_epilogue(conv: nn.Module, x: torch.Tensor, relu: bool = False,
                  shortcut: Optional[torch.Tensor] = None,
                  proj: Optional[ConvAffine] = None) -> torch.Tensor:
    """`conv(x)` (a Conv3d, ConvAffine or Conv1) + `shortcut` (`proj(
    shortcut)` with a projection; nearest-upsampled ×2 where it is at half
    the output's H and W), then the ReLU if `relu`. Where no gradient is
    needed, the conv's bias or affine and all of that are its one pass
    (the projection runs only its conv, its affine rides in the pass);
    with one, `conv` and `proj` return their own outputs and the rest is
    the op chain."""
    params = [conv.parameters()] + (
        [proj.parameters()] if proj is not None else [])
    if wants_grad(x, shortcut, params=itertools.chain(*params)):
        r = proj(shortcut) if proj is not None else shortcut
        return _chain(conv(x), relu, r)
    if shortcut is None:
        return conv(x, relu=relu)
    if proj is None:
        return conv(x, relu=relu, shortcut=shortcut)
    return conv(x, relu=relu, shortcut=proj.conv(shortcut),
                shortcut_affine=proj.bn)


class Bottleneck(nn.Module):
    """1x1 → t×3×3 → 1x1 bottleneck; stride on the 1x1 (STRIDE_1X1) or on
    the 3x3; the temporal kernel sits on the middle conv."""

    def __init__(self, cin: int, features: int, out_features: int,
                 spatial_stride: int = 1, time_kernel: int = 1,
                 stride_1x1: bool = True, dtype: torch.dtype = torch.float32,
                 spatial_dilation: int = 1, time_dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        s = (1, spatial_stride, spatial_stride)
        s1, s2 = (s, (1, 1, 1)) if stride_1x1 else ((1, 1, 1), s)
        dil = (time_dilation, spatial_dilation, spatial_dilation)
        self.proj = (ConvAffine(cin, out_features, (1, 1, 1), s, dtype=dtype)
                     if cin != out_features or spatial_stride != 1 else None)
        self.a = ConvAffine(cin, features, (1, 1, 1), s1, dtype=dtype)
        self.b = ConvAffine(features, features, (time_kernel, 3, 3), s2,
                            dtype=dtype, dilation=dil, groups=groups)
        self.c = ConvAffine(features, out_features, (1, 1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_epilogue(self.a, x, relu=True)
        y = conv_epilogue(self.b, y, relu=True)
        return conv_epilogue(self.c, y, relu=True, shortcut=x, proj=self.proj)


class BasicBlock(nn.Module):
    """Two t×3×3 convs (ResNet-18/34 transform)."""

    def __init__(self, cin: int, features: int, out_features: int,
                 spatial_stride: int = 1, time_kernel: int = 1,
                 stride_1x1: bool = True, dtype: torch.dtype = torch.float32,
                 spatial_dilation: int = 1, time_dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        s = (1, spatial_stride, spatial_stride)
        dil = (time_dilation, spatial_dilation, spatial_dilation)
        self.proj = (ConvAffine(cin, out_features, (1, 1, 1), s, dtype=dtype)
                     if cin != out_features or spatial_stride != 1 else None)
        self.a = ConvAffine(cin, out_features, (time_kernel, 3, 3), s,
                            dtype=dtype, dilation=dil)
        self.b = ConvAffine(out_features, out_features, (time_kernel, 3, 3),
                            dtype=dtype, dilation=dil)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_epilogue(self.a, x, relu=True)
        return conv_epilogue(self.b, y, relu=True, shortcut=x, proj=self.proj)


class ResNet(nn.Module):
    """ResNet body → {res2..res5}, each (B, T, H/s, W/s, C).

    `time_kernels` gives the temporal kernel of (conv1, res2..res5).
    `res5_dilation` 2 gives res5 stride 1 and dilation-2 3x3s, so res5 stays
    at stride 16 (RESNETS.RES5_DILATION).
    """

    def __init__(self, depth: str = "resnet50",
                 time_kernels: Sequence[int] = (1, 1, 1, 1, 1),
                 num_groups: int = 1, width_per_group: int = 64,
                 stride_1x1: bool = True, dtype: torch.dtype = torch.float32,
                 res5_dilation: int = 1, dilate_time: bool = False):
        super().__init__()
        blocks = STAGE_BLOCKS[depth]
        basic = depth in BASIC_ARCHS
        block_cls = BasicBlock if basic else Bottleneck
        expansion = 1 if basic else 4
        self.conv1 = Conv1(time_kernels[0], dtype)
        self.stage_names = []
        width = width_per_group * num_groups
        cin = 64
        for stage, n_blocks in enumerate(blocks):
            inner = width * 2 ** stage
            out = 64 * expansion * 2 ** stage
            tk = time_kernels[stage + 1]
            is_res5 = stage == len(blocks) - 1
            sdil = res5_dilation if is_res5 else 1
            tdil = 2 if (is_res5 and dilate_time and tk > 1) else 1
            stride = 1 if stage == 0 or sdil > 1 else 2
            names = []
            for bi in range(n_blocks):
                name = f"res{stage + 2}_{bi}"
                self.add_module(name, block_cls(
                    cin, inner, out, spatial_stride=stride if bi == 0 else 1,
                    time_kernel=tk, stride_1x1=stride_1x1, dtype=dtype,
                    spatial_dilation=sdil, time_dilation=tdil,
                    groups=1 if basic else num_groups))
                names.append(name)
                cin = out
            self.stage_names.append(names)

    def forward(self, x: torch.Tensor, last_stage: int = 5
                ) -> Dict[str, torch.Tensor]:
        """clips → {res2..res<last_stage>}; the later stages keep their
        parameters but do not run (C4 reads res4 only)."""
        with scope("model/backbone"):
            y = conv_epilogue(self.conv1, x, relu=True)
            b, t, h, w, c = y.shape
            y = F.max_pool2d(y.reshape(b * t, h, w, c).permute(0, 3, 1, 2),
                             3, 2, 1)
            y = y.permute(0, 2, 3, 1).reshape(b, t, y.shape[2], y.shape[3], c)
            feats = {}
            for stage, names in enumerate(self.stage_names[:last_stage - 1]):
                for name in names:
                    y = getattr(self, name)(y)
                feats[f"res{stage + 2}"] = y
            return feats


def backbone_from_cfg(cfg) -> ResNet:
    """The ResNet of a Config (MODEL.CONV_BODY + VIDEO.*)."""
    tks = cfg.VIDEO.TIME_KERNEL_DIM if cfg.VIDEO.VIDEO_ON else (1, 1, 1, 1, 1)
    return ResNet(depth=cfg.MODEL.CONV_BODY, time_kernels=tuple(tks),
                  num_groups=cfg.RESNETS.NUM_GROUPS,
                  width_per_group=cfg.RESNETS.WIDTH_PER_GROUP,
                  stride_1x1=cfg.RESNETS.STRIDE_1X1, dtype=compute_dtype(cfg),
                  res5_dilation=cfg.RESNETS.RES5_DILATION,
                  dilate_time=(cfg.VIDEO.DILATE_TIME if cfg.VIDEO.VIDEO_ON
                               else False))
