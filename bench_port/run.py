"""The port's benchmark: one run of one cell.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (see bench_port/README.md); the last lines of standard error are
the numbers compared beside their limits.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(t0=T0))
