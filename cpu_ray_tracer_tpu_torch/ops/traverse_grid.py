"""The reference grid walk: the Amanatides-Woo 3D DDA of the JAX package's
`cpu_ray_tracer_tpu/ops/traverse_grid.py` (the reference's
Grid::IntersectGrid, infra/grid.cpp:94-153), in plain PyTorch on the
scene's device.

A ray is slab-tested against the grid's box; one that enters it starts
in the cell of its entry point nudged 1e-5 along the ray.  Each step
either tests the next `CHUNK` triangles of the current cell's list or,
once the list is done, steps the DDA to the next cell along the axis the
reference's 3-bit table picks (grid.cpp:140-144); the ray stops when its
best t lies before that cell's crossing (grid.cpp:146) or it leaves the
grid.  `traversed` counts DDA steps, `tested` triangle tests.  The JAX
package's documented deviation is kept: a ray from outside the grid is
advanced to its entry point, where the reference clamps its origin cell
(grid.cpp:98-100).

The DDA's lane picks (`take_along_axis`, `one_hot` there) are elementwise
here too (`gather`, a comparison with the lane ids), with JAX's operation
order: a lane whose step is infinite turns its next crossing into NaN as
the one-hot product does there.  The walk loop, the hit dict and the two
loop counts are `ops/traverse_bvh.py`'s.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.accel.types import GridArrays, TrianglePool
from cpu_ray_tracer_tpu_torch.ops.traverse_bvh import finish, leaf_test, lockstep, ray_state

# grid.cpp:143: the axis for k = (x<y)<<2 | (x<z)<<1 | (y<z)
_AXIS_LUT = (2, 1, 2, 1, 2, 2, 0, 0)

CHUNK = 4  # triangles tested per step inside a cell


def traverse(grid: GridArrays, tris: TrianglePool, o: torch.Tensor, d: torch.Tensor,
             t0: torch.Tensor, any_hit: bool = False, max_steps: int | None = None) -> dict:
    """Closest hit (or any hit) of rays o, d [R, 3] from t0 [R] through
    the grid: `ops/traverse_bvh.py`'s dict.  `max_steps` defaults to
    (rx + ry + rz + 3) (max_cell_len // CHUNK + 2)."""
    dev = o.device
    rx, ry, rz = grid.resolution
    res = torch.tensor(grid.resolution, dtype=torch.int32, device=dev)
    rd = 1.0 / d
    bmin, bmax = grid.bounds_min, grid.bounds_max
    f = o.dtype
    cell_size = (bmax - bmin) / res.to(f)

    # the slab test for the entry point (and to drop rays that miss the grid)
    t1 = (bmin - o) * rd
    t2 = (bmax - o) * rd
    tn = torch.amax(torch.minimum(t1, t2), dim=-1)
    tf = torch.amin(torch.maximum(t1, t2), dim=-1)
    hits_grid = (tf >= tn) & (tf > 0.0) & (tn < t0)
    t_enter = torch.maximum(tn, torch.zeros_like(tn))
    p_enter = o + (t_enter + 1e-5)[:, None] * d  # nudged inside, into a valid cell
    # XLA's float-to-int conversion saturates and takes NaN to 0: clip
    # before converting to the same cell
    cell = torch.clamp(torch.nan_to_num(torch.floor((p_enter - bmin) / cell_size), nan=0.0),
                       torch.zeros_like(cell_size), (res - 1).to(f)).to(torch.int32)
    dpos = d >= 0
    step = torch.where(dpos, 1, -1).to(torch.int32)
    exit_ = torch.where(dpos, res, -1).to(torch.int32)
    delta = torch.where(dpos, cell_size * rd, -cell_size * rd)
    next_bound = torch.where(dpos, (cell + 1).to(f), cell.to(f))

    if max_steps is None:
        max_steps = (rx + ry + rz + 3) * (max(grid.max_cell_len, 1) // CHUNK + 2)
    s = ray_state(o, d, t0)
    s.update(cell=cell, next_t=(next_bound * cell_size + bmin - o) * rd,
             k=torch.zeros_like(s["tri"]), active=hits_grid, step=step, exit=exit_, delta=delta)
    lut = torch.tensor(_AXIS_LUT, dtype=torch.int64, device=dev)
    lanes = torch.arange(3, device=dev)
    n_cells = rx * ry * rz
    k_tri = grid.cell_tris.shape[0]

    def body(s):
        cell, active, k = s["cell"], s["active"], s["k"]
        cell_id = (cell[:, 0] + cell[:, 1] * rx + cell[:, 2] * (rx * ry)).clamp(0, n_cells - 1)
        rng = grid.cell_range[cell_id]
        start, end = rng[:, 0], rng[:, 1]
        in_cell = (start + k) < end
        testing = active & in_cell
        for c in range(CHUNK):
            slot = start + k + c
            tid = grid.cell_tris[slot.clamp(0, k_tri - 1)]
            leaf_test(s, tris, tid, testing & (slot < end))

        # rays done with their cell step the DDA
        stepping = active & ~in_cell
        nt = s["next_t"]
        kxy = (nt[:, 0] < nt[:, 1]).long()
        kxz = (nt[:, 0] < nt[:, 2]).long()
        kyz = (nt[:, 1] < nt[:, 2]).long()
        axis = lut[(kxy << 2) + (kxz << 1) + kyz][:, None]
        axis_t = nt.gather(1, axis)[:, 0]
        # early out: the best t lies before the next crossing (grid.cpp:146)
        done_by_t = stepping & (s["t"] < axis_t)
        new_cell_ax = cell.gather(1, axis)[:, 0] + s["step"].gather(1, axis)[:, 0]
        out_of_grid = stepping & (new_cell_ax == s["exit"].gather(1, axis)[:, 0])
        one_hot = axis == lanes
        s["cell"] = cell + one_hot.to(torch.int32) * s["step"] * stepping[:, None].to(torch.int32)
        s["next_t"] = nt + one_hot.to(f) * s["delta"] * stepping[:, None].to(f)
        s["k"] = torch.where(testing, k + CHUNK, torch.where(stepping, 0, k))
        active = active & ~(done_by_t | out_of_grid)
        s["active"] = active & (s["tri"] < 0) if any_hit else active
        s["traversed"] = s["traversed"] + stepping.to(torch.int32)

    return finish(tris, lockstep(s, body, lambda s: s["active"], max_steps))
