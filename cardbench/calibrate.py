#!/usr/bin/env python3
"""Readings for the limits of a cell's ``correct`` (``cells/<workload>.json``):
the program over many seeds, the fp8 control and (training) the half-batch
fault, against the fp32 reference at the cell's own size, on the card.

    python3 cardbench/calibrate.py --workload seamless-m4t-large-v2.train-2x4k \
        --seeds 11 12 13 --control-seeds 11 12 13 --fault-seeds 11

Prints one JSON line a seed.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from cbench import calibrate, harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    cell = harness.Cell(HERE.parent, args.workload, args.seeds[0], 0, False,
                        "cuda", time.perf_counter())
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.mix["kind"] == "train":
            r = calibrate.train_seed(cell, seed, seed in args.control_seeds,
                                     seed in args.fault_seeds)
        else:
            r = calibrate.serve_seed(cell, seed, seed in args.control_seeds)
        r["seconds"] = time.perf_counter() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
