"""The control of a cell: the same run with the port's hiding switched off
(MarlinKZG10 committed without a hiding bound, Hyrax's row masks all 0),
which the reference has to find wrong. Not part of a benchmark run.

    python3 port_bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

prints, for each seed in turn (one process), the compared numbers and
``correct``, then exits 1 if any seed came out correct.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    passed = []
    for seed in args.seeds:
        t0 = time.perf_counter() if passed else T_PROCESS  # set-up is not compared here
        result = harness.run(root, args.workload, seed, args.seconds, False, t0, control=True,
                             log=lambda s: print(s, flush=True))
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"]}), flush=True)
        passed.append(result["correct"])
    return 1 if any(passed) else 0


if __name__ == "__main__":
    sys.exit(main())
