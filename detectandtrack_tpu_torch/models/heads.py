"""RoI heads (port of detectandtrack_tpu/models/heads.py): the 2-FC box
head, the res5 box head of the C4 models, the v1convX keypoint head and the
1up4convs mask head. Every head takes its input width from the pooled map
(FPN.DIM with FPN, res4's width in C4)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .backbone import Bottleneck, Conv3d


class BoxHead2MLP(nn.Module):
    """Flatten (T, P, P, C) → fc6 → fc7 → (cls logits, per-class per-frame
    deltas, fc7). cls and bbox run in f32; fc7 is the tracker's appearance
    feature."""

    def __init__(self, in_dim: int, num_classes: int = 2,
                 num_frames: int = 1, hidden_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc6 = nn.Linear(in_dim, hidden_dim)
        self.fc7 = nn.Linear(hidden_dim, hidden_dim)
        self.cls_score = nn.Linear(hidden_dim, num_classes)
        self.bbox_pred = nn.Linear(hidden_dim, num_classes * 4 * num_frames)

    def init_parameters(self, generator: torch.Generator) -> None:
        for fc in (self.fc6, self.fc7):
            nn.init.xavier_uniform_(fc.weight, generator=generator)
        nn.init.normal_(self.cls_score.weight, 0.0, 0.01, generator=generator)
        nn.init.normal_(self.bbox_pred.weight, 0.0, 0.001,
                        generator=generator)
        for fc in (self.fc6, self.fc7, self.cls_score, self.bbox_pred):
            nn.init.zeros_(fc.bias)

    def _dense(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, fc.weight.to(self.dtype), fc.bias.to(self.dtype))

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        r = roi_feats.shape[0]
        x = roi_feats.reshape(r, -1).to(self.dtype)
        x = F.relu(self._dense(self.fc6, x))
        x = F.relu(self._dense(self.fc7, x)).float()
        return self.cls_score(x), self.bbox_pred(x), x


class KeypointHead(nn.Module):
    """N stacked convs → one 4×4/s2 deconv → K heatmap logits at 2P.

    Input (R, T, P, P, C); T folds into the RoI batch → (R, T, 2P, 2P, K).
    The deconv runs in f32; its weight is torch's (Cin, K, 4, 4) layout.
    """

    def __init__(self, in_dim: int, num_keypoints: int = 15,
                 num_convs: int = 8, conv_dim: int = 512, conv_kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.num_convs = num_convs
        cin = in_dim
        for i in range(num_convs):
            self.add_module(f"conv_fcn{i + 1}", Conv3d(
                cin, conv_dim, (1, conv_kernel, conv_kernel), use_bias=True,
                dtype=dtype))
            cin = conv_dim
        self.kps_score_lowres = nn.ConvTranspose2d(cin, num_keypoints, 4,
                                                   stride=2, padding=1)

    def init_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.kps_score_lowres.weight, 0.0, 0.001,
                        generator=generator)
        nn.init.zeros_(self.kps_score_lowres.bias)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        r, t, p, _, c = roi_feats.shape
        x = roi_feats.reshape(r * t, 1, p, p, c)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = x[:, 0].float().permute(0, 3, 1, 2)          # (R·T, C, P, P)
        logits = self.kps_score_lowres(x).permute(0, 2, 3, 1)
        size = logits.shape[1]
        return logits.reshape(r, t, size, size, self.num_keypoints)


class Res5BoxHead(nn.Module):
    """res5_head: three res5 bottlenecks (first at stride 2, or stride 1
    with dilated 3x3s when `dilation` > 1) on pooled (R, T, P, P, C) rois,
    a spatial mean, then cls/bbox predictors on the (T·2048) f32 feature,
    which is also the appearance feature."""

    def __init__(self, in_dim: int, num_classes: int = 2,
                 num_frames: int = 1, time_kernel: int = 1, width: int = 512,
                 stride_1x1: bool = True, dtype: torch.dtype = torch.float32,
                 groups: int = 1, dilation: int = 1):
        super().__init__()
        cin = in_dim
        for b in range(3):
            first = 1 if dilation > 1 else 2
            self.add_module(f"res5_{b}", Bottleneck(
                cin, width, 2048, spatial_stride=first if b == 0 else 1,
                time_kernel=time_kernel, stride_1x1=stride_1x1, dtype=dtype,
                spatial_dilation=dilation, groups=groups))
            cin = 2048
        self.cls_score = nn.Linear(num_frames * 2048, num_classes)
        self.bbox_pred = nn.Linear(num_frames * 2048,
                                   num_classes * 4 * num_frames)

    def init_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.cls_score.weight, 0.0, 0.01, generator=generator)
        nn.init.normal_(self.bbox_pred.weight, 0.0, 0.001,
                        generator=generator)
        nn.init.zeros_(self.cls_score.bias)
        nn.init.zeros_(self.bbox_pred.bias)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = roi_feats
        for b in range(3):
            x = getattr(self, f"res5_{b}")(x)
        flat = x.mean(dim=(2, 3)).reshape(x.shape[0], -1).float()
        return self.cls_score(flat), self.bbox_pred(flat), flat


class MaskHead(nn.Module):
    """1up4convs: four 3x3 convs → 2x2/s2 deconv → relu → 1x1 per-class
    logits at 2P. Input (R, T, P, P, C); T folds into the roi batch →
    (R, T, 2P, 2P, num_classes). The deconv runs in the compute dtype with
    torch's (Cin, Cout, 2, 2) weight, the logits in f32."""

    def __init__(self, in_dim: int, num_classes: int = 2, dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        cin = in_dim
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}", Conv3d(
                cin, dim, (1, 3, 3), use_bias=True, dtype=dtype))
            cin = dim
        self.conv5_mask = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.mask_fcn_logits = nn.Conv2d(dim, num_classes, 1)

    def init_parameters(self, generator: torch.Generator) -> None:
        # flax's ConvTranspose default: lecun_normal (truncated, fan_in).
        fan_in = self.conv5_mask.weight.shape[0] * 4
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.conv5_mask.weight, 0.0, std, -2 * std,
                              2 * std, generator=generator)
        nn.init.normal_(self.mask_fcn_logits.weight, 0.0, 0.001,
                        generator=generator)
        nn.init.zeros_(self.conv5_mask.bias)
        nn.init.zeros_(self.mask_fcn_logits.bias)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        r, t, p, _, c = roi_feats.shape
        x = roi_feats.reshape(r * t, 1, p, p, c)
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = x[:, 0].to(self.dtype).permute(0, 3, 1, 2)     # (R·T, C, P, P)
        up = self.conv5_mask
        x = F.relu(F.conv_transpose2d(x, up.weight.to(self.dtype),
                                      up.bias.to(self.dtype), stride=2))
        logits = self.mask_fcn_logits(x.float()).permute(0, 2, 3, 1)
        size = logits.shape[1]
        return logits.reshape(r, t, size, size, self.num_classes)
