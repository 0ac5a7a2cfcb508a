"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

See `benchmark/harness.py`.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root in place of this script's folder, whose module names
# (trace, inputs, ...) would shadow others.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], START))
