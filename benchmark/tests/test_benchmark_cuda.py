"""On a card: each cell runs through `benchmark/run.py` for a short window
and comes out correct, with its end-to-end metrics, and its traced run
with its per-layer metrics. Run on the card with

    python3 -m pytest -p no:cacheprovider -m cuda -q \
        benchmark/tests/test_benchmark_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.manifest import Manifest

BENCH = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in Manifest.load(BENCH).data["workloads"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run only on the chip")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    _need_card()
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 32 + 17 + trace), "--seconds", "3", "--trace", str(trace)],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    m = Manifest.load(BENCH)
    want = (m.per_layer(cell) if trace else m.end_to_end(cell))
    assert set(res["metrics"]) == {x["name"] for x in want}
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
