"""Checkpoint / resume of the full train state, and `.npz` weights in the
JAX package's flat naming (port of detectandtrack_tpu/utils/checkpoint.py,
with `torch.save` in place of orbax).

Full-state checkpoints: `save_checkpoint(ckpt_dir, state, step)` writes the
`TrainState` of `engine/train.py` (parameters by port name, the momentum
dict, the step) to `ckpt_dir/<step>.pt`. The snapshot is an owned host
copy taken before the call returns (the optimizer updates the parameters
in place); the file is written on a background thread, at most one save
in flight per directory, under a temporary name renamed when complete, so
a save cut off mid-write never becomes the latest. The last `max_to_keep`
steps are kept. `restore_checkpoint` reads the latest step back, or gives
`(None, None)`; it raises on any missing or extra key or shape mismatch
and never resumes part of a state. Saves still in flight are drained by
`wait_for_checkpoints` and at exit.

`.npz` weights: a file holds one array per flax leaf, named by its
'/'-joined path in the model's variables (`params/backbone/conv1/kernel`),
in flax's layouts. The bridge of `utils/params.py` maps it onto the port's
state_dict and back, so a JAX `model_final.npz` loads into the port and the
port's loads into JAX.
"""

from __future__ import annotations

import atexit
import os
import re
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .params import jax_params_to_state_dict, state_dict_to_jax_params

_STEP_FILE = re.compile(r"^(\d+)\.pt$")

# One writer per checkpoint directory, at most one in flight: the next
# save (or a restore) of that directory drains it first.
_WRITERS: Dict[str, "_Writer"] = {}
_WRITERS_LOCK = threading.Lock()


def _snapshot(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Owned host copies (a CPU tensor's `.cpu()` is the same storage)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _step_files(ckpt_dir: str) -> Dict[int, str]:
    if not os.path.isdir(ckpt_dir):
        return {}
    return {int(m.group(1)): os.path.join(ckpt_dir, name)
            for name in os.listdir(ckpt_dir)
            if (m := _STEP_FILE.match(name))}


class _Writer(threading.Thread):
    """Writes one snapshot to `<step>.pt` (through `<step>.pt.tmp`), then
    drops the steps beyond the newest `max_to_keep`; `join` re-raises
    what the write raised."""

    def __init__(self, ckpt_dir: str, payload: Dict[str, Any],
                 max_to_keep: int):
        super().__init__(daemon=False)
        self.ckpt_dir, self.payload = ckpt_dir, payload
        self.max_to_keep = max_to_keep
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            path = os.path.join(self.ckpt_dir, f"{self.payload['step']}.pt")
            torch.save(self.payload, f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
            for old in sorted(_step_files(self.ckpt_dir))[:-self.max_to_keep]:
                os.remove(os.path.join(self.ckpt_dir, f"{old}.pt"))
        except Exception as e:  # noqa: BLE001 — re-raised by join()
            self.error = e

    def join(self, timeout=None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise RuntimeError(f"checkpoint save to {self.ckpt_dir} "
                               "failed") from self.error


def save_checkpoint(ckpt_dir: str, state, step: int,
                    max_to_keep: int = 5) -> None:
    """Snapshot `state` (a `TrainState`) to host memory now, then write it
    as step `step` on a background thread. The previous save of the
    directory is drained first. Call `wait_for_checkpoints()` before
    reading the files back or exiting."""
    key = os.path.abspath(ckpt_dir)
    wait_for_checkpoints(key)
    payload = {"params": _snapshot(state.params),
               "momentum": _snapshot(state.momentum), "step": int(step)}
    os.makedirs(key, exist_ok=True)
    writer = _Writer(key, payload, max_to_keep)
    with _WRITERS_LOCK:
        _WRITERS[key] = writer
    writer.start()


def wait_for_checkpoints(ckpt_dir: Optional[str] = None) -> None:
    """Block until in-flight saves are written (one directory, or all);
    raises if a save failed."""
    with _WRITERS_LOCK:
        if ckpt_dir is None:
            writers = list(_WRITERS.values())
            _WRITERS.clear()
        else:
            writer = _WRITERS.pop(os.path.abspath(ckpt_dir), None)
            writers = [writer] if writer is not None else []
    for writer in writers:
        writer.join()


atexit.register(wait_for_checkpoints)


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The newest completely written step in `ckpt_dir`, or None."""
    wait_for_checkpoints(ckpt_dir)
    steps = _step_files(ckpt_dir)
    return max(steps) if steps else None


def _check_keys(what: str, got: Mapping[str, torch.Tensor],
                want: Mapping[str, torch.Tensor], errors: list) -> None:
    errors += [f"{what}: missing {k!r}" for k in sorted(set(want) - set(got))]
    errors += [f"{what}: unknown {k!r}" for k in sorted(set(got) - set(want))]
    errors += [f"{what}: {k!r} shape {tuple(v.shape)} vs "
               f"{tuple(want[k].shape)}" for k, v in got.items()
               if k in want and tuple(v.shape) != tuple(want[k].shape)]


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None
                       ) -> Tuple[Any, Optional[int]]:
    """Restore step `step` (default: the latest) into `state`'s parameters
    in place, on their device → (TrainState, step), or (None, None) when
    the directory holds no checkpoint. The file must hold exactly the
    state's parameters, a momentum for trained parameters only (exactly
    `state.momentum`'s keys when it has any), all of their shapes."""
    from ..engine.train import TrainState

    wait_for_checkpoints(ckpt_dir)
    step = latest_checkpoint_step(ckpt_dir) if step is None else int(step)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"{step}.pt")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    # A fresh state has no momentum yet: then the file's must be a trace
    # of some of the parameters, shaped like them.
    momentum = state.momentum or {k: p for k, p in state.params.items()
                                  if k in saved["momentum"]}
    errors = []
    _check_keys("params", saved["params"], state.params, errors)
    _check_keys("momentum", saved["momentum"], momentum, errors)
    if saved["step"] != step:
        errors.append(f"step {saved['step']} in the file of step {step}")
    if errors:
        raise ValueError(f"checkpoint {path} does not fit the state:\n  "
                         + "\n  ".join(errors))
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(saved["params"][k])
    momentum = {k: v.to(state.params[k].device)
                for k, v in saved["momentum"].items()}
    return TrainState(state.params, momentum, step), step


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
