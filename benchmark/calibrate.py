"""Readings of a cell's compared numbers over many seeds in one process,
from which its limits (``limits/<workload>.json``) are set: the program
as it runs (the lower readings) or, with ``--precision tf32``, the
lower-precision control (the upper readings: TF32 on after the program's
constructors, and for training's update, which the program keeps in
float32, the reference's steps in TF32 in the program's place).  Not
part of a benchmark run.

    python -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... \\
        [--precision tf32 | --fault <name>] [--seconds 2]

``--fault`` plants one of ``faults.py``'s faults of the cell's traffic.

Prints one JSON line a seed: its numbers, correct or not against the
limits the cell has now.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark import faults, harness, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--precision", choices=("float32", "tf32"),
                        default="float32")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    cell = harness.find_cell(harness.load_spec(), args.workload)
    plant = (faults.BY_LOOP[cell.traffic["loop"]][args.fault]
             if args.fault else contextlib.nullcontext)
    for seed in args.seeds:
        with plant():
            res = run.run_cell(cell, seed, args.seconds, False,
                               precision=args.precision)
        harness.set_tf32(False)
        print(json.dumps({"seed": seed, "precision": args.precision,
                          "fault": args.fault,
                          "correct": res["correct"],
                          "numbers": {k: c["value"]
                                      for k, c in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
