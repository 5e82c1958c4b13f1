"""The port's benchmark: one run of one cell, its result as the last line of
standard output.

    python3 benchmark/run.py --workload align-medium --seed 7 --seconds 30 --trace 0

Run from the root of a checkout that holds the port
(``lyricalignment_tpu_torch``); it needs as many CUDA devices as the cell
asks for, and exits with another code than 0 and no result otherwise.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
