"""Learning-rate schedules (port of detectandtrack_tpu/utils/lr_policy.py,
which imports jax.numpy).

`get_lr_at_iter` is the host-side scalar form; `make_schedule` is the one
the optimizer evaluates, in f32 like the JAX schedule. Both keep the
reference's quirks: `make_schedule`'s "step" policy decays every 30000
steps whatever SOLVER says, while `get_lr_at_iter` takes `step_size`.
"""

from __future__ import annotations

import bisect
from typing import Callable, Sequence

import torch


def get_lr_at_iter(it: int, *, base_lr: float,
                   policy: str = "steps_with_decay",
                   gamma: float = 0.1, steps: Sequence[int] = (0,),
                   max_iter: int = 0, step_size: int = 30000,
                   warm_up_iters: int = 0, warm_up_factor: float = 1.0 / 3.0,
                   warm_up_method: str = "linear") -> float:
    """LR at iteration `it` (host-side scalar version)."""
    if policy == "fixed":
        lr = base_lr
    elif policy == "step":
        lr = base_lr * gamma ** (it // step_size)
    elif policy == "steps_with_decay":
        idx = bisect.bisect_right(list(steps), it) - 1
        lr = base_lr * gamma ** idx
    else:
        raise ValueError(f"Unknown LR_POLICY {policy!r}")

    if it < warm_up_iters:
        if warm_up_method == "linear":
            alpha = it / max(warm_up_iters, 1)
            factor = warm_up_factor * (1 - alpha) + alpha
        elif warm_up_method == "constant":
            factor = warm_up_factor
        else:
            raise ValueError(f"Unknown WARM_UP_METHOD {warm_up_method!r}")
        lr *= factor
    return lr


def make_schedule(solver_cfg) -> Callable[[int], torch.Tensor]:
    """SolverCfg → schedule: step (int) → lr as a 0-d f32 tensor."""
    base_lr = solver_cfg.BASE_LR
    gamma = torch.tensor(solver_cfg.GAMMA, dtype=torch.float32)
    steps = torch.tensor(solver_cfg.STEPS, dtype=torch.float32)
    warm_iters = solver_cfg.WARM_UP_ITERS
    warm_factor = solver_cfg.WARM_UP_FACTOR
    policy = solver_cfg.LR_POLICY
    method = solver_cfg.WARM_UP_METHOD
    if policy not in ("fixed", "steps_with_decay", "step"):
        raise ValueError(f"Unknown LR_POLICY {policy!r}")

    def schedule(step: int) -> torch.Tensor:
        step = torch.tensor(float(step), dtype=torch.float32)
        if policy == "fixed":
            lr = torch.tensor(base_lr, dtype=torch.float32)
        elif policy == "steps_with_decay":
            idx = (step >= steps).sum() - 1
            lr = base_lr * gamma ** idx.clamp(min=0).float()
        else:
            lr = base_lr * gamma ** torch.floor(step / 30000.0)
        if warm_iters > 0:
            alpha = (step / warm_iters).clamp(0.0, 1.0)
            if method == "linear":
                factor = warm_factor * (1 - alpha) + alpha
            else:
                factor = torch.where(step < warm_iters,
                                     torch.tensor(warm_factor), 1.0)
            lr = lr * factor
        return lr

    return schedule
