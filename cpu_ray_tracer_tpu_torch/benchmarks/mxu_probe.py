"""Leaf-test probe: should a Moller-Trumbore leaf test run on the tensor
cores (K7, `wgmma` TF32) or once per thread on the CUDA cores (K6)?

The port of the JAX package's `benchmarks/mxu_probe.py:151-214`, on the
kernels of `ops/leaf_probe.py`, with the same inputs: drawn from
`np.random.default_rng(0)` in that probe's order (the triangle rows, the
six ray components, then C and Phi for each m), at its sizes (64 tiles of
4096 rays, 512 tests per ray).  Each variant is timed as a warm call, then
10 chained calls between CUDA events, twice, keeping the faster.  Prints V
in ns per 8-triangle row and, for each m, ns per row-equivalent and the
speedup against V; the last line is the JSON dict of those numbers and
the device they ran on.  The probe's own decision rule: the tensor cores
are worth integrating only if an achievable m (<= 32) beats V by >= 1.5x.

    python -m cpu_ray_tracer_tpu_torch.benchmarks.mxu_probe            # on the card

With `device="cpu"` (`--device cpu`) the plain PyTorch versions run, and
the times are the CPU's; `tests/test_torch_probes.py` checks them against
the JAX probe at 2 tiles.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.ops import leaf_probe

TS = (32, 128)
N_TILES = 64
ROWS = 64  # rows of 8 triangles: the VPU variant's flushes


def inputs(tiles: int = N_TILES, device=device_mod.DEFAULT) -> dict:
    """The probe's inputs, drawn in the JAX probe's order: tris [64, 128],
    the six ray components [tiles, 32, 128], and per m C [16m, 16] and Phi
    [tiles, 16, 4096]; `vpu_packed` holds the triangles in K6's layout
    (`leaf_probe.pack_vpu`) and `packed` each (C, Phi) in K7's
    (`leaf_probe.pack`), made once here so that no timed call pays them."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    tris = draw(ROWS, 128)
    comps = [draw(tiles, *TS) for _ in range(6)]
    per_m = {m: (draw(16 * m, 16), draw(tiles, 16, leaf_probe.TILE)) for m in leaf_probe.WIDTHS}
    packed = {m: leaf_probe.pack(c_tab, phi, m) for m, (c_tab, phi) in per_m.items()}
    return dict(tris=tris, comps=comps, per_m=per_m, packed=packed,
                vpu_packed=leaf_probe.pack_vpu(tris))


def vpu(inp: dict) -> torch.Tensor:
    """K6 on the probe's inputs: t + u + v + slot [tiles, 32, 128]."""
    return leaf_probe.vpu_leaf(inp["tris"], *inp["comps"], packed=inp["vpu_packed"])


def mxu(inp: dict, m: int) -> torch.Tensor:
    """K7 on the probe's inputs for m: t + slot of the first 128 rays of
    each tile [tiles, 1, 128], as the JAX kernel stores them."""
    c_tab, phi = inp["per_m"][m]
    return leaf_probe.mxu_leaf(c_tab, phi, m, inp["packed"][m])[:, None, :128]


def timed(fn, dev: torch.device) -> float:
    """Seconds per call: a warm call, then 10 chained calls, twice; the
    faster pass."""
    fn()
    best = float("inf")
    for _ in range(2):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            best = min(best, start.elapsed_time(end) / 1e3 / 10)
        else:
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            best = min(best, (time.perf_counter() - t0) / 10)
    return best


def main(device=device_mod.DEFAULT) -> dict:
    dev = device_mod.resolve(device)
    tiles = N_TILES
    inp = inputs(tiles, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    dt_v = timed(lambda: vpu(inp), dev)
    rows_total = tiles * ROWS
    results = {"V_ns_per_row": dt_v * 1e9 / rows_total}
    print(f"V(per-thread rows, {name}): {dt_v * 1e3:.4f} ms  {results['V_ns_per_row']:.2f} ns/row",
          flush=True)
    for m in leaf_probe.WIDTHS:
        dt_m = timed(lambda m=m: mxu(inp, m), dev)
        rows_eq = tiles * leaf_probe.n_flush(m) * m / 8  # 8-triangle-row equivalents
        ns_row = dt_m * 1e9 / rows_eq
        print(f"M{m}(tensor cores, {m} tris/flush): {dt_m * 1e3:.4f} ms  "
              f"{ns_row:.2f} ns/row-equivalent  ({results['V_ns_per_row'] / ns_row:.2f}x vs V)",
              flush=True)
        results[f"M{m}_ns_per_row"] = ns_row
    results["device"] = name
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=device_mod.DEFAULT)
    main(ap.parse_args().device)
