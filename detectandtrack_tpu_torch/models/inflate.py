"""2D → 3D weight inflation over the port's parameters (port of
detectandtrack_tpu/models/inflate.py; paper arXiv:1712.09184 §3.1).

2D k×k conv kernels become t×k×k, replicated along time and divided by t
so the 3D model reproduces the 2D activations on a temporally-constant
clip ("mean" init); "center" puts the 2D kernel at the center time step
and zeros elsewhere (identity at initialization).

It maps one state_dict onto another of the same keys: a conv kernel whose
shape differs from the template's only on the time axis, where the 2D
kernel has one tap, is inflated; every other tensor must match exactly.
The time axis is 2 of a Conv3d weight (co, ci, t, kh, kw) and 0 of
conv1's canonical (t, 7, 7, 3, 64) kernel.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

# conv1's kernel keeps the (t, kh, kw, ci, co) layout of the conv1 kernel's
# input (models/backbone.py::Conv1Kernel).
_CONV1_KERNEL = "backbone.conv1.conv.weight"


def time_axis(key: str) -> int:
    """The time axis of the 5-D kernel `key` of the port's state_dict."""
    return 0 if key == _CONV1_KERNEL else 2


def _inflate_kernel(k2d: torch.Tensor, t: int, axis: int,
                    mode: str) -> torch.Tensor:
    """One tap on `axis` → `t` taps."""
    if mode == "mean":
        return k2d.repeat_interleave(t, dim=axis) / float(t)
    if mode == "center":
        shape = list(k2d.shape)
        shape[axis] = t
        out = torch.zeros(shape, dtype=k2d.dtype, device=k2d.device)
        out.narrow(axis, t // 2, 1).copy_(k2d)
        return out
    raise ValueError(f"Unknown inflate mode {mode!r}")


def _inflatable(key: str, v2: torch.Tensor, v3: torch.Tensor) -> bool:
    if v2.ndim != 5 or v3.ndim != 5:
        return False
    axis = time_axis(key)
    rest = [i for i in range(5) if i != axis]
    return v2.shape[axis] == 1 and all(v2.shape[i] == v3.shape[i]
                                       for i in rest)


def _inflate(sd_2d: Mapping[str, torch.Tensor],
             sd_3d_template: Mapping[str, torch.Tensor], mode: str,
             strict: bool) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    if set(sd_2d) != set(sd_3d_template):
        raise ValueError("2D and 3D parameter sets differ; inflation "
                         "requires matching architectures")
    out: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    for key, v3 in sd_3d_template.items():
        v2 = sd_2d[key]
        if v2.shape == v3.shape:
            out[key] = v2
        elif _inflatable(key, v2, v3):
            axis = time_axis(key)
            out[key] = _inflate_kernel(v2, v3.shape[axis], axis, mode)
        elif strict:
            raise ValueError(f"Cannot inflate {key}: {tuple(v2.shape)} → "
                             f"{tuple(v3.shape)}")
        else:
            skipped.append(key)
            out[key] = v3
    return out, skipped


def inflate_params(sd_2d: Mapping[str, torch.Tensor],
                   sd_3d_template: Mapping[str, torch.Tensor],
                   mode: str = "mean",
                   strict: bool = True) -> Dict[str, torch.Tensor]:
    """Map a 2D model's state_dict onto the 3D model's keys and shapes
    (`sd_3d_template`, e.g. the 3D model's own state_dict).

    `strict=False` matches the paper's fine-tuning recipe: tensors that
    cannot map (head fc layers sized by T, per-frame regressors, ...) keep
    the template's values instead of raising; `inflate_params_report`
    names them."""
    return _inflate(sd_2d, sd_3d_template, mode, strict)[0]


def inflate_params_report(sd_2d: Mapping[str, torch.Tensor],
                          sd_3d_template: Mapping[str, torch.Tensor],
                          mode: str = "mean"
                          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Non-strict inflation → (state_dict, keys kept from the template)."""
    return _inflate(sd_2d, sd_3d_template, mode, strict=False)
