"""Parallel work fan-out (port of detectandtrack_tpu/utils/subprocess_utils.py;
parity: `lib/utils/subprocess.py`).

The reference shards dataset inference across GPUs by spawning one
subprocess per device over contiguous roidb ranges and merging pickled
partial outputs. Here each shard is one child process running the CLI
over a contiguous video range; the children run at the same time.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
from typing import Callable, List, Sequence, Tuple


def split_ranges(total: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) ranges covering `total` items."""
    base = total // num_shards
    rem = total % num_shards
    out = []
    start = 0
    for i in range(num_shards):
        n = base + (1 if i < rem else 0)
        out.append((start, start + n))
        start += n
    return out


def process_in_parallel(
    tag: str,
    total: int,
    cmd_template: Sequence[str],
    output_dir: str,
    num_workers: int = 1,
) -> List[str]:
    """Run `cmd_template` once per range; returns per-shard output pickles.

    The template may contain `{start}`, `{end}`, `{out}` placeholders. Each
    shard must write its partial results to `{out}`.
    """
    os.makedirs(output_dir, exist_ok=True)
    outputs = []
    procs = []
    for i, (start, end) in enumerate(split_ranges(total, num_workers)):
        out = os.path.join(output_dir, f"{tag}_range_{start}_{end}.pkl")
        outputs.append(out)
        cmd = [c.format(start=start, end=end, out=out)
               for c in cmd_template]
        procs.append((cmd, subprocess.Popen(cmd)))
    failed = []
    for cmd, p in procs:
        if p.wait() != 0:
            failed.append(" ".join(cmd))
    if failed:
        raise RuntimeError(f"{len(failed)} shard(s) failed: {failed}")
    return outputs


def merge_shard_results(paths: Sequence[str]) -> list:
    """Concatenate per-shard pickled lists in range order."""
    merged = []
    for p in paths:
        with open(p, "rb") as f:
            merged.extend(pickle.load(f))
    return merged
