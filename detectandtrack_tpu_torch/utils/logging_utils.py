"""Logger setup (port of detectandtrack_tpu/utils/logging_utils.py;
parity: `lib/utils/logging.py`)."""

from __future__ import annotations

import logging
import sys


def setup_logging(name: str = "detectandtrack_tpu_torch",
                  level: int = logging.INFO) -> logging.Logger:
    fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
    root = logging.getLogger()
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(fmt))
        root.addHandler(handler)
    root.setLevel(level)
    return logging.getLogger(name)
