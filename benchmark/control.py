"""The control of the benchmark's correctness check, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--program 1]

For each seed, the program's float32 path with no float64 refinement
(the control) solves the seed's first b at the cell's own size, and the
plain reference judges its answer as a run judges one: the reading has
to lie above the configuration's limit.  With ``--program 1`` the
program's refined solve of the same b is read too.  One JSON line per
seed.  The benchmark's runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

if __name__ == "__main__":
    sys.path[:0] = [str(HERE.parent), str(HERE)]
    import torch
    from g4pbench.control import readings

    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", type=int, choices=(0, 1), default=0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    print(torch.cuda.get_device_name(0), file=sys.stderr)
    for row in readings(HERE.parent, a.workload,
                        [int(s) for s in a.seeds.split(",")], "cuda:0",
                        bool(a.program)):
        print(json.dumps(row), flush=True)
