"""Readings that set a cell's limits, in one process on one device:

    python3 portbench/calibrate.py --workload bvh.pt --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--faults unchanged,half,answer --fault-seeds 1,2,3] \
        [--units 2] [--params '{"width": 64, "height": 40}'] [--json out/cal.json]

For each of `--seeds`, the program's outputs of a short run at the cell's
own size (set-up and `--units` more units of its traffic) checked against
the reference: the sound runs' readings, whose largest is a limit's lower
reading.  For each of `--control-seeds`, the reference computed in
bfloat16 (the precision below the configuration's float32 whose
arithmetic has no matrix product to fall to TF32) put in the program's
place: the control's readings, whose smallest is the upper reading.
With `--faults`, the program with each fault of its entry planted
(`lib/faults.py`).  The scene is compiled once; each seed makes its own
inputs.  Prints one JSON object: each row is a seed, its numbers, and the
entry's per-leaf readings where it keeps them (the train step's `leaves`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PB = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(PB))

from portbench.lib import faults, harness, traffic  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, seeds, units: int, device, control: bool = False, fault: str = "",
             scene=None) -> list:
    """[(seed, the check's numbers, the entry's per-leaf readings or None)]
    for each seed (module docstring)."""
    import contextlib

    import torch

    from portbench.reference.scene import load_scene

    if scene is None:
        scene, _ = harness.compile_config(cell.config, device)
    out = []
    for seed in seeds:
        ctx = faults.planted(fault, cell.mix["entry"]) if fault else contextlib.nullcontext()
        with ctx:
            loop = traffic.entry_module(cell.mix["entry"]).Loop(
                harness.Run(cell, seed, device, scene))
            if control:
                low = load_scene(os.path.join(harness.REPO, cell.config["scene"]),
                                 dtype=torch.bfloat16, device=device)
                answers = loop.control(low)
                del low
            else:
                loop.warm_up()
                for _ in range(units):
                    loop.unit()
                answers = loop.answers()
        out.append((seed, harness.check(loop, answers, device), getattr(loop, "leaves", None)))
        del loop, answers
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default="{}", help="JSON overriding the cell's parameters")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    cell.params.update(json.loads(args.params))
    device = torch.device(args.device)
    scene, _ = harness.compile_config(cell.config, device)
    result = dict(workload=cell.name, device=torch.cuda.get_device_name(device)
                  if device.type == "cuda" else "cpu", units=args.units)
    result["program"] = readings(cell, _seeds(args.seeds), args.units, device, scene=scene)
    result["control"] = readings(cell, _seeds(args.control_seeds), 0, device, control=True,
                                 scene=scene)
    for fault in [f for f in args.faults.split(",") if f]:
        result[f"fault_{fault}"] = readings(cell, _seeds(args.fault_seeds), args.units, device,
                                            fault=fault, scene=scene)
    for key in [k for k in result if isinstance(result[k], list)]:
        rows = result[key]
        if rows:
            names = rows[0][1]
            result[f"{key}_max"] = {n: max(r[1][n] for r in rows) for n in names}
            result[f"{key}_min"] = {n: min(r[1][n] for r in rows) for n in names}
    text = json.dumps(result, indent=1)
    print(text)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
