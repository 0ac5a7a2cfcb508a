"""Environment / runtime report for the CLI banner, the tools and bug
reports (port of detectandtrack_tpu/utils/env.py, for torch and CUDA).

`card_line` is the one source of the card line every measurement prints
beside its numbers: `nvidia-smi`'s name and power limit, because a card set
below its full power limit runs slower under load.
"""

from __future__ import annotations

import platform
import subprocess
from typing import Dict

import numpy as np
import torch


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"; raises where
    nvidia-smi is missing or fails."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def get_runtime_info() -> Dict[str, str]:
    """Python, platform, torch, CUDA, cuDNN and numpy versions, the device
    and device count, the card line ("n/a" without a card), and this
    process's rank, world size and backend (0, 1 and "none" without a
    process group), as JAX's reports its process count."""
    cuda = torch.cuda.is_available()
    dist = torch.distributed
    group = dist.is_available() and dist.is_initialized()
    cudnn = torch.backends.cudnn.version() if cuda else None
    try:
        card = card_line()
    except (OSError, subprocess.CalledProcessError, IndexError):
        card = "n/a"
    return {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "n/a",
        "cudnn": str(cudnn) if cudnn else "n/a",
        "numpy": np.__version__,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": str(torch.cuda.device_count() if cuda else 0),
        "card": card,
        "rank": str(dist.get_rank() if group else 0),
        "world_size": str(dist.get_world_size() if group else 1),
        "backend": dist.get_backend() if group else "none",
    }


def log_runtime_info(logger) -> None:
    for k, v in get_runtime_info().items():
        logger.info("env: %s = %s", k, v)
