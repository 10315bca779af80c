"""Run one cell of BENCHMARK.json once on the CUDA card and print one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without a result when no CUDA card (or too few) is present; the run
never falls back to the CPU.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, in place of this file's folder: the benchmark's
# modules are imported as port_bench.*, and never shadow the standard library's
sys.path[0] = str(Path(__file__).resolve().parents[1])

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
