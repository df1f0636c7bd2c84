"""Run one benchmark cell and print its result as the last line of stdout.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Exits with a nonzero code and prints no
result when no CUDA card (or fewer cards than the cell asks for) is
visible, when the run fails, or when JAX or the JAX package was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root in place of benchmark/

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
