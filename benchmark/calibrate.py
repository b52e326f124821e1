#!/usr/bin/env python3
"""The readings a cell's limits are set from: one unit on each seed, judged
by the reference, in one process (set-up and warm-up once), printed as one
JSON line a seed.  ``--precision high`` runs the control: the program with
its own TF32 path on.

    python3 benchmark/calibrate.py --workload vgg19.2048 --seeds 1,2,3 [--precision high]

The benchmark's own runs do not run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (ROOT, os.path.dirname(__file__))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--precision", default=None, help="replaces the configuration's (high: TF32, the control)")
    p.add_argument("--fault", default=None,
                   help="a fault of faults.py, or of a judge's FAULTS, planted under the timed path")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="replaces a configuration key (a witness: another path of the program)")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import faults
    from benchmark.instrument import patched

    cell = harness.load_cell(ROOT, args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        cell["config"][key] = json.loads(value)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    with patched(*(faults.patches(args.fault) if args.fault else [])):
        for seed, numbers in harness.readings(cell, seeds, "cuda", args.precision):
            print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                              "fault": args.fault, "set": args.set, **numbers, "s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
