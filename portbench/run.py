"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload bvh.pt --seed 1234 --seconds 51 --trace 0

Builds the cell's scene, makes its inputs from `--seed`, warms up, then
with `--trace 0` measures a closed loop of `--seconds` seconds and reports
the cell's end-to-end metrics, with `--trace 1` profiles a few iterations
and reports its per-layer metrics.  Either way it then checks the outputs
against the plain reference (`portbench/reference/`), prints each number
compared beside its limit on standard error, and prints the result as one
JSON line, the last of standard output.  Exits non-zero with no result
where there is no CUDA device, fewer than the cell asks for, or where the
JAX package or JAX was loaded.  `README.md` beside this file says more.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PB = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PB)
sys.path.insert(0, REPO)

from portbench.lib import harness  # noqa: E402

# every build and kernel cache of the program, at fixed paths in the checkout
CACHES = dict(TORCH_EXTENSIONS_DIR="torch_extensions", TRITON_CACHE_DIR="triton",
              CUDA_CACHE_PATH="cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = time.perf_counter() - harness.process_seconds()
    for key, sub in CACHES.items():
        os.environ[key] = os.path.join(REPO, "build", sub)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result, split = harness.execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                             started=started)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in this process, and not allowed: {', '.join(banned)}", file=sys.stderr)
        return 3
    print("setup split (s), and the window: " + json.dumps(split), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
