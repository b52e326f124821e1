#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload vgg19.pyramid --seed 1234 --seconds 40 --trace 0

Prints the cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``) as the last line of standard output, one JSON object,
after each number of the correctness check beside its limit on standard
error.  Exits non-zero, printing no result, without the program beside
this directory, without enough CUDA devices, or when JAX or the JAX
package was loaded."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# the checkout's root, not this directory, on the path: its modules are
# reached as ``benchmark.*`` only
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (ROOT, os.path.dirname(__file__))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    try:
        import maua_style_tpu_torch  # the program under test, beside this directory
    except ImportError as e:
        print(f"benchmark: the program maua_style_tpu_torch is not importable from {ROOT}: {e}", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(maua_style_tpu_torch.__file__))) != ROOT:
        print(f"benchmark: maua_style_tpu_torch comes from {maua_style_tpu_torch.__file__}, not from {ROOT}",
              file=sys.stderr)
        return 2
    import torch

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    r, numbers = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    out = harness.result(ROOT, cell, r, numbers, bool(args.trace), "cuda")
    found = harness.jax_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for row in numbers["rows"]:
        print("check row " + json.dumps(row), file=sys.stderr)
    print(f"check sample unit {numbers['sample']} of {len(r.units)}", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
