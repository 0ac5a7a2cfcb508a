"""Weight bridge between the JAX package's flax param tree and the port.

The flax tree is taken as nested dicts of numpy arrays
(`jax.tree.map(np.asarray, params)`); a leaf at `a/b/c/kernel` becomes the
port's `a.b.c.weight` (any other leaf name is kept), transposed by the kind
of module that owns it:

  Conv3d            (t, kh, kw, ci, co) → (co, ci, t, kh, kw)
  nn.Linear         (in, out)           → (out, in)
  nn.Conv2d         (kh, kw, ci, co)    → (co, ci, kh, kw)
  nn.ConvTranspose2d (kh, kw, ci, co)   → (ci, co, kh, kw), spatially flipped
                    (flax's transposed conv does not flip its kernel; the
                    keypoint 4x4/s2 and the mask 2x2/s2 deconvs alike)
  everything else   unchanged (conv1's canonical (t, 7, 7, 3, 64) kernel,
                    affine scales, biases)

Both directions raise on any leaf they cannot place and on any parameter
left unset, so a renamed or missing weight fails loudly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.backbone import Conv3d


def _to_port(module: nn.Module, arr: np.ndarray) -> np.ndarray:
    if isinstance(module, Conv3d) and arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    if isinstance(module, nn.Linear) and arr.ndim == 2:
        return arr.T
    if isinstance(module, nn.Conv2d) and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if isinstance(module, nn.ConvTranspose2d) and arr.ndim == 4:
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr


def _to_jax(module: nn.Module, arr: np.ndarray) -> np.ndarray:
    if isinstance(module, Conv3d) and arr.ndim == 5:
        return arr.transpose(2, 3, 4, 1, 0)
    if isinstance(module, nn.Linear) and arr.ndim == 2:
        return arr.T
    if isinstance(module, nn.Conv2d) and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if isinstance(module, nn.ConvTranspose2d) and arr.ndim == 4:
        return arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    return arr


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, value in tree.items():
        path = prefix + (str(name),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _port_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax leaf path → (owning module path, port parameter key)."""
    leaf = "weight" if path[-1] == "kernel" else path[-1]
    mod = ".".join(path[:-1])
    return mod, f"{mod}.{leaf}"


def flax_path(key: str) -> Tuple[str, ...]:
    """Port parameter key → the path of its flax leaf (`a.b.weight` →
    ("a", "b", "kernel")), the inverse of the bridge's naming."""
    *mod, leaf = key.split(".")
    return tuple(mod) + ("kernel" if leaf == "weight" else leaf,)


def jax_params_to_state_dict(params: Mapping, model: nn.Module
                             ) -> Dict[str, torch.Tensor]:
    """flax params (with or without the top "params" key) → a complete f32
    state_dict for `model`."""
    tree = params["params"] if "params" in params else params
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    errors = []
    for path, leaf in _flatten(tree):
        mod_path, key = _port_key(path)
        name = "/".join(path)
        if key not in target:
            errors.append(f"{name}: no port parameter {key!r}")
            continue
        if key in out:
            errors.append(f"{name}: {key!r} set twice")
            continue
        arr = _to_port(model.get_submodule(mod_path), np.asarray(leaf))
        if tuple(arr.shape) != tuple(target[key].shape):
            errors.append(f"{name}: shape {arr.shape} → {key!r} "
                          f"{tuple(target[key].shape)}")
            continue
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    errors += [f"port parameter {k!r} left unset"
               for k in sorted(set(target) - set(out))]
    if errors:
        raise ValueError("weight bridge failed:\n  " + "\n  ".join(errors))
    return out


def state_dict_to_jax_params(state_dict: Mapping[str, torch.Tensor],
                             model: nn.Module) -> Dict[str, Any]:
    """The inverse: a complete state_dict of `model` → {"params": tree}."""
    target = model.state_dict()
    missing = sorted(set(target) - set(state_dict))
    extra = sorted(set(state_dict) - set(target))
    if missing or extra:
        raise ValueError(f"weight bridge failed: missing {missing}, "
                         f"unknown {extra}")
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *mod, leaf = flax_path(key)
        arr = _to_jax(model.get_submodule(".".join(mod)),
                      value.detach().float().cpu().numpy())
        node = tree
        for part in mod:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}
