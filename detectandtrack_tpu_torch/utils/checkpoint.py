"""`.npz` weights in the JAX package's flat naming (port of
`save_weights_npz` / `load_weights_npz` in
detectandtrack_tpu/utils/checkpoint.py).

A file holds one array per flax leaf, named by its '/'-joined path in the
model's variables (`params/backbone/conv1/kernel`), in flax's layouts. The
bridge of `utils/params.py` maps it onto the port's state_dict and back, so
a JAX `model_final.npz` loads into the port and the port's loads into JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
from torch import nn

from .params import jax_params_to_state_dict, state_dict_to_jax_params


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, key + "/"))
        else:
            flat[key] = np.asarray(value)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def save_weights_npz(path: str, model: nn.Module) -> None:
    """The model's weights → `path` in the flax naming and layouts."""
    np.savez(path, **_flatten(state_dict_to_jax_params(model.state_dict(),
                                                       model)))


def load_weights_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a flax-named `.npz` into `model` in place (on its device).
    Raises on any leaf the bridge cannot place and on any parameter the
    file leaves unset."""
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    model.load_state_dict(jax_params_to_state_dict(tree, model))
    return model
