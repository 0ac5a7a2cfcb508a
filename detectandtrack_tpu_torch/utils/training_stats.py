"""Training statistics: smoothed losses, iteration timing, ETA, JSON logs
(port of detectandtrack_tpu/utils/training_stats.py).

Reference parity: `lib/utils/training_stats.py` (SURVEY.md §2.1/§5):
`IterTic/IterToc`, smoothed-window medians of loss components, periodic
`json_stats: {...}` log lines with lr / eta / mem. Emits the same
shape of line (a `json_stats:` prefix) plus an optional JSONL file for
structured consumption.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class SmoothedValue:
    """Median/average over a sliding window (parity: SmoothedValue)."""

    def __init__(self, window_size: int = 20):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.window.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self) -> float:
        if not self.window:
            return 0.0
        vals = sorted(self.window)
        return vals[len(vals) // 2]

    @property
    def average(self) -> float:
        return self.total / max(self.count, 1)


class TrainingStats:
    def __init__(self, max_iter: int, log_period: int = 20,
                 window_size: int = 20, jsonl_path: Optional[str] = None):
        self.max_iter = max_iter
        self.log_period = log_period
        self.smoothed: Dict[str, SmoothedValue] = {}
        self.window_size = window_size
        self.iter_timer = SmoothedValue(window_size)
        self._tic: Optional[float] = None
        self.cur_iter = 0
        self.jsonl_path = jsonl_path
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def iter_tic(self):
        self._tic = time.perf_counter()

    def iter_toc(self):
        if self._tic is not None:
            self.iter_timer.update(time.perf_counter() - self._tic)
            self._tic = None

    def update_iter_stats(self, metrics: Dict[str, float], it: int,
                          lr: float = 0.0):
        self.cur_iter = it
        self.lr = lr
        for k, v in metrics.items():
            self.smoothed.setdefault(
                k, SmoothedValue(self.window_size)).update(float(v))
        if it % self.log_period == 0:
            self.log_iter_stats()

    def get_stats(self) -> Dict[str, float]:
        eta_s = self.iter_timer.median * (self.max_iter - self.cur_iter)
        stats = {
            "iter": self.cur_iter,
            "max_iter": self.max_iter,
            "time": round(self.iter_timer.median, 4),
            "eta_seconds": round(eta_s, 1),
            "lr": getattr(self, "lr", 0.0),
        }
        for k, sv in self.smoothed.items():
            stats[k] = round(sv.median, 6)
        return stats

    def log_iter_stats(self):
        stats = self.get_stats()
        line = json.dumps(stats, sort_keys=True)
        logger.info("json_stats: %s", line)
        if self._jsonl:
            self._jsonl.write(line + "\n")
            self._jsonl.flush()

    def close(self):
        if self._jsonl:
            self._jsonl.close()
