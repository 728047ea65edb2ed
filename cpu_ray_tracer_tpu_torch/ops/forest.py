"""The reference walks over a TLAS scene's grid or KD forest: the JAX
package's `cpu_ray_tracer_tpu/ops/forest.py` `traverse_forest`.

The reference's TLASGrid and TLASKDTree (infra/tlas_grid.cpp:17-111,
infra/tlas_kdtree.cpp:17-111) put a TLAS over one grid or KD tree per
instance; with a handful of instances its only job is to skip the
instances a ray misses, which each structure's own entry slab test does.
So the instances' structures (triangle ids global) are walked one after
another in a static chain, each from the best t of those before it, and
a later instance's hit replaces the earlier one where it found one (only
a hit closer than its t0 is recorded).  Counters and loop counts add up.
"""

from __future__ import annotations

import torch


def traverse_forest(traverse_fn, structs, tris, o: torch.Tensor, d: torch.Tensor,
                    t0: torch.Tensor, any_hit: bool = False) -> dict:
    """Chain `traverse_fn(struct, tris, o, d, t, any_hit=...)` (a reference
    walk of `ops/traverse_grid.py` or `ops/traverse_kd.py`) over `structs`,
    threading the running t: the walks' dict."""
    out = None
    t = t0
    for st in structs:
        res = traverse_fn(st, tris, o, d, t, any_hit=any_hit)
        if out is None:
            out = dict(res)
        else:
            better = res["tri_idx"] >= 0
            for k in ("t", "u", "v", "tri_idx", "obj_id", "mat_id"):
                out[k] = torch.where(better, res[k], out[k])
            for k in ("traversed", "tested", "loop_steps", "syncs"):
                out[k] = out[k] + res[k]
        t = out["t"]
    return out
