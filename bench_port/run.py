"""Run one cell of the PyTorch port's benchmark once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object; the compared numbers and their limits are the
last lines of standard error. See ``harness/core.py``.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from bench_port.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(BENCH_DIR, T_START))
