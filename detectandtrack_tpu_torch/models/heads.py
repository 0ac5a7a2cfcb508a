"""RoI heads (port of detectandtrack_tpu/models/heads.py): the 2-FC box
head and the v1convX keypoint head."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .backbone import Conv3d


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
