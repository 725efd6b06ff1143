"""The benchmark of splashsurf_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints the result as one JSON line, the last of standard output, and
the numbers of the check beside their limits as the last lines of standard
error. Exits with a code other than 0, and prints no result, without CUDA
or with fewer cards than the cell needs, or where the process has loaded
JAX or the JAX package.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    # the program under test is the checkout's splashsurf_tpu_torch
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
    import os

    from harness.files import command_switches

    os.environ.update(command_switches(sys.argv[1:]))  # before torch loads OpenMP
    from harness import runner

    sys.exit(runner.main(t_start=T_START))
