"""The benchmark of geneo4petsc_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for.  Prints the result as one JSON line, the last line of
standard output; the numbers compared with the plain reference, each
beside its limit, are the last lines of standard error.
"""

import time

T_PROC0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent

if __name__ == "__main__":
    sys.path[:0] = [str(HERE.parent), str(HERE)]
    from g4pbench import runner
    sys.exit(runner.main(sys.argv[1:], T_PROC0))
