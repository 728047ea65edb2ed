"""Build the port's DeviceScene from the JAX package's scene state.

`scene_from_arrays` takes the arrays of a JAX `DeviceScene` compiled with
`use_pallas=True`, already converted to numpy, and repacks the packet
kernel's row tables into this package's layout (`accel/pack.py`).  Both
frameworks then render from identical tables, independently of whether
the two scene compilers agree.

`arrays` keys:

* `tris.v0`, `tris.e1`, `tris.e2` — the triangle pool [N, 3];
* `packed.node_aabb` [6, M], `packed.node_meta2` [2, M] (leaf's first
  triangle row, row count), `packed.node_nearfar` [8, 2, M] (absent when
  the root is a leaf), `packed.tri_rows` and `packed.tri_shade_rows`
  [R, 128] (8 triangles of 16 floats per row, degenerate padding);
* where the hit ids do not fit the meta word (`meta["meta_in_shade"]`
  False), `packed.slot_tri` [8R] and `tris.obj_id`, `tris.mat_id` [N],
  from which the ids of each slot are joined (`accel/pack.py` slot_ids);
* `materials.albedo`, `.reflectivity`, `.refractivity`, `.absorption`,
  `.tex_id`, `.is_light`;
* `atlas.texels`, `.packed`, `.offset`, `.width`, `.height`;
* `light_t`, `light_inv_t`, `light_size`, `light_color`, `floor_inv_to`.

`meta`: `root`, `stack_depth` (0 when the root is a leaf), `skydome_tex`,
and optionally `shadow_quirk` (default True), `meta_in_shade` (default
True) and `bilinear` (default False: the scene's texture tap,
`DeviceScene.bilinear`).  A tree deeper than the stack walk's STACK_CAP
is threaded with links here (`pack.make_tables`), as the JAX package
walks it by its links.

`params_from_arrays` carries the JAX package's differentiable parameters
the same way: the dict of its `diff.grad.extract_params`, converted to
numpy, with any of the keys of `diff/grad.PARAM_KEYS` (`albedo` [M, 3],
`reflectivity`, `refractivity` [M], `absorption` [M, 3], `texels` [K, 3],
`light_color` [3], `v0`, `e1`, `e2` [N, 3] in pool order), becomes the
port's parameter dict for `diff/grad.apply_params` on the scene that
`scene_from_arrays` built from the same JAX scene.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.core.materials import MaterialTable
from cpu_ray_tracer_tpu_torch.core.textures import Atlas
from cpu_ray_tracer_tpu_torch.scene.types import DeviceScene

_SLOTS_PER_ROW = 8  # the JAX packing's triangles per 128-lane row
_SLOT_F = 16  # floats per triangle record


def scene_from_arrays(arrays: dict, meta: dict) -> DeviceScene:
    a = arrays
    aabb = np.asarray(a["packed.node_aabb"], np.float32)
    m = aabb.shape[1]
    row_start, nrows = np.asarray(a["packed.node_meta2"], np.int64)
    rows = np.asarray(a["packed.tri_rows"], np.float32).reshape(-1, _SLOT_F)
    shade_rows = np.asarray(a["packed.tri_shade_rows"], np.float32).reshape(-1, _SLOT_F)
    # a real triangle's lane 15 is its meta word, whose obj >= 2 sets bits
    # 20-25, or its material id >= 2 as a float; padding slots are all-zero
    # records
    real = shade_rows.view(np.int32)[:, 15] != 0
    slot_ids = None
    if not meta.get("meta_in_shade", True):
        slot_ids = pack.slot_id_table(
            np.asarray(a["packed.slot_tri"], np.int64)[real],
            np.asarray(a["tris.obj_id"]), np.asarray(a["tris.mat_id"]))
    prefix = np.concatenate([[0], np.cumsum(real)])
    leaf = nrows > 0
    first = np.where(leaf, prefix[row_start * _SLOTS_PER_ROW], 0)
    count = np.where(leaf, prefix[(row_start + nrows) * _SLOTS_PER_ROW] - first, 0)

    nearfar = a.get("packed.node_nearfar")
    depth = int(meta["stack_depth"])
    if nearfar is None:
        # the JAX packer attaches no near/far table when the root is a leaf,
        # which makes the root the only node
        if m != 1:
            raise ValueError("node_nearfar missing for a multi-node tree")
        nearfar = np.full((8, 2, 1), -1, np.int32)
        depth = 1
    packed = pack.make_tables(
        aabb[:3].T, aabb[3:].T, first, count, np.asarray(nearfar, np.int32),
        rows[real, :9], shade_rows[real], root=int(meta["root"]), depth=depth,
        slot_ids=slot_ids,
    )
    materials = MaterialTable(
        albedo=a["materials.albedo"],
        reflectivity=a["materials.reflectivity"],
        refractivity=a["materials.refractivity"],
        absorption=a["materials.absorption"],
        tex_id=np.asarray(a["materials.tex_id"], np.int32),
        is_light=np.asarray(a["materials.is_light"], np.bool_),
    )
    atlas = Atlas(
        texels=a["atlas.texels"],
        packed=np.asarray(a["atlas.packed"], np.int64).astype(np.int32),
        offset=np.asarray(a["atlas.offset"], np.int32),
        width=np.asarray(a["atlas.width"], np.int32),
        height=np.asarray(a["atlas.height"], np.int32),
    )
    return DeviceScene(
        packed=packed,
        pool=np.concatenate([a["tris.v0"], a["tris.e1"], a["tris.e2"]], axis=1),
        materials=materials,
        atlas=atlas,
        light_t=a["light_t"],
        light_inv_t=a["light_inv_t"],
        light_size=float(a["light_size"]),
        light_color=a["light_color"],
        floor_inv_to=float(a["floor_inv_to"]),
        skydome_tex=int(meta["skydome_tex"]),
        shadow_quirk=bool(meta.get("shadow_quirk", True)),
        bilinear=bool(meta.get("bilinear", False)),
    )


def params_from_arrays(np_params: dict) -> dict:
    """The port's parameter dict (float32 tensors, on the CPU as the scene
    `scene_from_arrays` builds) of the JAX package's `extract_params`
    output as numpy arrays (module docstring)."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in np_params.items()}
