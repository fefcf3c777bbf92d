"""Readings that a cell's limits are set from, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 1.5]

Each seed runs the cell at its own size (set-up, a short window at the
cell's load, the comparison with the plain reference) and prints one JSON
line with every number the comparison reads: first the program on
``--seeds``, then the control (the port's next precision below the
configuration's) on ``--control-seeds``; with ``--fault`` the program's
runs have that fault of `faults` planted. The benchmark's own runs never
run the control or a fault.
"""

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import faults
from benchmark.run import run_cell
from benchmark.spec import Spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--fault", choices=sorted(faults.BY_NAME),
                    help="plant this fault under the program's runs")
    args = ap.parse_args(argv)
    spec = Spec()
    if args.fault:
        faults.BY_NAME[args.fault](setattr)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] \
        + [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        out = run_cell(spec, args.workload, seed, args.seconds, False,
                       control=control, t0=time.perf_counter())
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "variant": "control" if control
                          else args.fault or "program",
                          "numbers": out.numbers, "routes": out.routes,
                          "end_to_end": out.end_to_end}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
