"""Node-step sync probe: what does a tile-wide decision cost per node step?

The port of the JAX package's `benchmarks/sync_probe.py:291-344`, on the
kernel of `ops/sync_probe.py`: 256 steps of a threaded-link walk with one
cursor per 4096-ray tile, over the TLAS forest of `bunny_teapot.xml`
(`scene/build.tlas_node_tables`, octant 0), for the 921,600 rays of the
`bench.py` camera at 1280x720 in 225 tiles.  The variants differ in how
the tile decides (`csrc/sync_probe.cu`): A from the tables alone, B with
every ray's slab test but no vote, C with a block-wide OR per step, D one
block-wide sum per 4 steps, E1/E2/E8 eight slab tests per step decided by
1 or 2 sums or 8 ORs; F0-F2 add the wide walk's stack and leaf shapes.
Each variant is timed as a warm call, then 10 chained calls between CUDA
events, twice, keeping the faster.  Prints ms, ns per step and ns per node
(E and F test 8 nodes per step).

    python -m cpu_ray_tracer_tpu_torch.benchmarks.sync_probe                # A-E8 on the card
    python -m cpu_ray_tracer_tpu_torch.benchmarks.sync_probe --variants C,D,F0

With `device="cpu"` (`--device cpu`) the plain PyTorch version runs, and
the times are the CPU's; `tests/test_torch_probes.py` checks it against
the JAX probe on 2 tiles from the middle of the frame.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.benchmarks.mxu_probe import timed
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.ops import sync_probe
from cpu_ray_tracer_tpu_torch.scene.build import tlas_node_tables

XML = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "assets", "scenes", "bunny_teapot.xml")
CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))  # bench.py
WIDTH, HEIGHT = 1280, 720
N_TILES = WIDTH * HEIGHT // sync_probe.TILE  # 225
TILE_SHAPE = (sync_probe.TILE // 128, 128)


def inputs(tiles: int = N_TILES, device=device_mod.DEFAULT, xml: str = XML) -> dict:
    """The probe's tables (aabb [6, M], octant-0 links [2, M], and the
    kernel's `records`, built once here so that no timed call pays it) and
    the first `tiles` tiles of the camera's rays as six components
    [tiles, 32, 128], in the JAX probe's order."""
    dev = device_mod.resolve(device)
    aabb, links = tlas_node_tables(xml)
    cam = cam_mod.make_camera(WIDTH, HEIGHT, **CAMERA)
    o, d = cam_mod.full_frame_rays(cam, device=dev)
    comps = [x[:, axis].reshape(N_TILES, *TILE_SHAPE)[:tiles].contiguous()
             for x in (o, d) for axis in range(3)]
    aabb, links = torch.from_numpy(aabb).to(dev), torch.from_numpy(links[0]).contiguous().to(dev)
    return dict(aabb=aabb, links=links, records=sync_probe.node_records(aabb, links), comps=comps)


NAN_FLAT = 64  # nodes whose boxes `nan_rays` flattens


def nan_rays(inp: dict, tiles: int, seed: int = 0) -> dict:
    """`inp` with `tiles` tiles of rays on which the slab test meets NaN,
    and tables where that decides the step.  Each ray starts inside a
    node's box, on one of its slab planes, with that direction component
    zero, so (b - o) * (1 / 0) is 0 * inf = NaN on that axis.  Where the
    box has depth on the axis, the other plane gives -inf or inf and the
    test misses however NaN is treated; so the boxes of `NAN_FLAT` nodes are
    flattened onto their min plane of one axis, as a planar leaf's box
    is, and half of the rays start on those planes: there both bounds are
    NaN, which jnp.minimum / maximum carry to a miss and fminf / fmaxf
    would drop to a hit.  The nodes are drawn (from `seed`, with numpy)
    half from the cursor paths that take the hit link at every node or at
    the even ones (A and B's path), half from nodes 0-1023, which the E
    and F variants read."""
    aabb = inp["aabb"].cpu().numpy().copy()
    links = inp["links"].cpu().numpy()
    paths = set()
    for take_hit in (lambda n: True, lambda n: n % 2 == 0):
        cur = 0
        for _ in range(sync_probe.STEPS):
            if cur < 0:
                break
            paths.add(cur)
            cur = int(links[0, cur] if take_hit(cur) else links[1, cur])
    paths = np.array(sorted(paths))
    rng = np.random.default_rng(seed)

    def draw(k):
        return np.where(rng.random(k) < 0.5, paths[rng.integers(0, len(paths), k)],
                        rng.integers(0, sync_probe.NODE_MASK + 1, k))

    flat_nodes = np.unique(draw(NAN_FLAT))
    flat_axis = rng.integers(0, 3, len(flat_nodes))
    aabb[3 + flat_axis, flat_nodes] = aabb[flat_axis, flat_nodes]
    n = tiles * sync_probe.TILE
    on_flat = rng.random(n) < 0.5
    pick = rng.integers(0, len(flat_nodes), n)
    node = np.where(on_flat, flat_nodes[pick], draw(n))
    axis = np.where(on_flat, flat_axis[pick], rng.integers(0, 3, n))
    side = np.where(on_flat, 0, rng.integers(0, 2, n))
    lo, hi = aabb[:3, node], aabb[3:, node]
    o = lo + rng.random((3, n)) * (hi - lo)
    d = rng.normal(size=(3, n))
    rows = np.arange(n)
    o[axis, rows] = np.where(side == 0, lo[axis, rows], hi[axis, rows])
    d[axis, rows] = 0.0
    dev = inp["aabb"].device
    comps = [torch.from_numpy(x.astype(np.float32).reshape(tiles, *TILE_SHAPE)).to(dev)
             for x in (*o, *d)]
    box = torch.from_numpy(aabb).to(dev)
    return dict(inp, aabb=box, records=sync_probe.node_records(box, inp["links"]), comps=comps)


def run(inp: dict, variant: str) -> torch.Tensor:
    """The probe's walk for one variant: out [tiles, 32, 128]."""
    return sync_probe.node_walk(inp["aabb"], inp["links"], inp["comps"], variant, inp["records"])


def main(variants=sync_probe.DEFAULT_VARIANTS, device=device_mod.DEFAULT) -> dict:
    dev = device_mod.resolve(device)
    tiles = N_TILES
    inp = inputs(tiles, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{name}: {inp['aabb'].shape[1]} nodes, {tiles} tiles of {sync_probe.TILE} rays, "
          f"{sync_probe.STEPS} steps", flush=True)
    results = {}
    for variant in variants:
        dt = timed(lambda v=variant: run(inp, v), dev)
        ns_step = dt * 1e9 / (tiles * sync_probe.STEPS)
        # E and F slab-test 8 nodes per counted step, A-D one
        nodes_per_step = 8 if variant[0] in "EF" else 1
        print(f"variant {variant}: {dt * 1e3:.4f} ms  {ns_step:.3f} ns/step  "
              f"{ns_step / nodes_per_step:.3f} ns/node", flush=True)
        results[variant] = dict(ms=dt * 1e3, ns_per_step=ns_step,
                                ns_per_node=ns_step / nodes_per_step)
    print(json.dumps(dict(results, device=name)))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(sync_probe.DEFAULT_VARIANTS),
                    help=f"comma list of {','.join(sync_probe.VARIANTS)}")
    ap.add_argument("--device", default=device_mod.DEFAULT)
    a = ap.parse_args()
    main(tuple(a.variants.split(",")), a.device)
