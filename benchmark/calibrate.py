"""The readings that each output limit of a cell is set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 101-112 --controls 3

runs, for each seed, the cell's set-up and the driver's readings on the card:
the program's ("sound", the lower reading is the largest over the seeds)
and, for the first ``--controls`` seeds, the control (the reference computed
in TF32 in the program's place) and the faults a cell can have (the upper
reading is the smallest of them). One JSON line a seed on standard output.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seed_list(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seed_list, required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.Cell(args.workload)
    for i, seed in enumerate(args.seeds):
        driver = harness.driver_class(cell.traffic["driver"])(cell, seed, args.device)
        t0 = time.perf_counter()
        driver.setup(0)
        t1 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               **driver.calibration(i < args.controls)}
        row["seconds"] = {"setup": t1 - t0, "readings": time.perf_counter() - t1}
        print(json.dumps(row), flush=True)
        del driver


if __name__ == "__main__":
    main()
