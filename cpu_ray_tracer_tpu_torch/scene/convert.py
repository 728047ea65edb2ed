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

A shared-instancing scene (`instancing="shared"`) carries, in place of
the `packed.*` keys:

* `shared.inst_minv` [I, 4, 4], `shared.inst_nrm` [I, 3, 3],
  `shared.inst_aabb_min`, `shared.inst_aabb_max` [I, 3],
  `shared.inst_obj`, `shared.inst_mat` [I];
* per unique mesh s, `shared.packs.{s}.node_aabb`, `.node_meta2`,
  `.node_nearfar` (absent when its root is a leaf), `.tri_rows` and
  `.slot_tri` (the JAX package packs no shading rows for them);
* `tris.shade` [N, 16] (the pool's shading records), `tris.obj_id` and
  `tris.mat_id` (the pool's placeholder ids, which the meta words keep);

and `meta` holds `inst_mesh`, `mesh_bounds` and per mesh its
`stack_depth` in `mesh_depths`.

A scene of the JAX package's XLA route (`use_pallas=False`) becomes a
scene of the port's reference route (`scene/types.ReferenceTables`):
`meta["reference"]` holds its `accel` and, per walked structure i, the
static fields in `structs[i]` (a BVH's `max_leaf`, `max_depth`, `root`; a
grid's `resolution`, `max_cell_len`; a KD tree's `max_depth`,
`max_leaf`), and the arrays hold that structure's fields under
`ref.{i}.` (`node_min`, `node_max`, `left_first`, `tri_count`,
`hit_link` [8, M], `miss_link`, `tri_indices`; `bounds_min`,
`bounds_max`, `cell_start`, `cell_tris`; `split_axis`, `split_dist`,
`left`, `right`, `first`, `count`, `tri_ids`, `bounds_min`,
`bounds_max`): the fused BVH, or the grids or KD trees in chain order
(one on the mono layout), or on a shared-instancing scene each unique
mesh's BVH (`shared.bvhs` there), whose instance tables are the
`shared.*` keys above.  The pool is `tris.v0`, `.e1`, `.e2`, `.obj_id`,
`.mat_id` and `tris.shade` [N, 16].

`prim_scene_from_arrays` carries a JAX `PrimScene`: its geometry fields
under their own names (`light_t`, `sphere_pos`, `cube_m`, `plane_n`,
`torus_inv_t`, ...) and the atlas under `atlas.*`.

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
from cpu_ray_tracer_tpu_torch.accel.types import BVHArrays, GridArrays, KDTreeArrays, TrianglePool
from cpu_ray_tracer_tpu_torch.core.materials import MaterialTable
from cpu_ray_tracer_tpu_torch.core.textures import Atlas
from cpu_ray_tracer_tpu_torch.scene import primitive_scene
from cpu_ray_tracer_tpu_torch.scene.types import DeviceScene, ReferenceTables, SharedInstances

_SLOTS_PER_ROW = 8  # the JAX packing's triangles per 128-lane row
_SLOT_F = 16  # floats per triangle record


def _packed_from_rows(a: dict, prefix: str, real: np.ndarray, shade_slots: np.ndarray,
                      root: int, stack_depth: int, slot_ids=None) -> pack.PackedBVH:
    """The port's tables of one JAX `PackedBVH` (its arrays under
    `prefix`): `real` marks the row slots that hold a triangle, whose
    shading records are `shade_slots` in slot order."""
    aabb = np.asarray(a[f"{prefix}node_aabb"], np.float32)
    m = aabb.shape[1]
    row_start, nrows = np.asarray(a[f"{prefix}node_meta2"], np.int64)
    rows = np.asarray(a[f"{prefix}tri_rows"], np.float32).reshape(-1, _SLOT_F)
    prefix_sum = np.concatenate([[0], np.cumsum(real)])
    leaf = nrows > 0
    first = np.where(leaf, prefix_sum[row_start * _SLOTS_PER_ROW], 0)
    count = np.where(leaf, prefix_sum[(row_start + nrows) * _SLOTS_PER_ROW] - first, 0)
    nearfar = a.get(f"{prefix}node_nearfar")
    depth = int(stack_depth)
    if nearfar is None:
        # the JAX packer attaches no near/far table when the root is a leaf,
        # which makes the root the only node
        if m != 1:
            raise ValueError("node_nearfar missing for a multi-node tree")
        nearfar = np.full((8, 2, 1), -1, np.int32)
        depth = 1
    return pack.make_tables(
        aabb[:3].T, aabb[3:].T, first, count, np.asarray(nearfar, np.int32),
        rows[real, :9], shade_slots, root=int(root), depth=depth, slot_ids=slot_ids,
    )


def _common(a: dict, meta: dict) -> dict:
    """The materials, atlas, light and floor arguments of `DeviceScene`."""
    return dict(
        materials=MaterialTable(
            albedo=a["materials.albedo"],
            reflectivity=a["materials.reflectivity"],
            refractivity=a["materials.refractivity"],
            absorption=a["materials.absorption"],
            tex_id=np.asarray(a["materials.tex_id"], np.int32),
            is_light=np.asarray(a["materials.is_light"], np.bool_),
        ),
        atlas=_atlas(a),
        light_t=a["light_t"],
        light_inv_t=a["light_inv_t"],
        light_size=float(a["light_size"]),
        light_color=a["light_color"],
        floor_inv_to=float(a["floor_inv_to"]),
        skydome_tex=int(meta["skydome_tex"]),
        shadow_quirk=bool(meta.get("shadow_quirk", True)),
        bilinear=bool(meta.get("bilinear", False)),
    )


def _atlas(a: dict) -> Atlas:
    return Atlas(
        texels=a["atlas.texels"],
        packed=np.asarray(a["atlas.packed"], np.int64).astype(np.int32),
        offset=np.asarray(a["atlas.offset"], np.int32),
        width=np.asarray(a["atlas.width"], np.int32),
        height=np.asarray(a["atlas.height"], np.int32),
    )


def _pool(a: dict) -> np.ndarray:
    return np.concatenate([a["tris.v0"], a["tris.e1"], a["tris.e2"]], axis=1)


REF_KEYS = dict(
    bvh=("node_min", "node_max", "left_first", "tri_count", "hit_link", "miss_link",
         "tri_indices"),
    grid=("bounds_min", "bounds_max", "cell_start", "cell_tris"),
    kdtree=("split_axis", "split_dist", "left", "right", "first", "count", "tri_ids",
            "bounds_min", "bounds_max"),
)


def reference_tables(a: dict, ref: dict) -> ReferenceTables:
    """The `ReferenceTables` of arrays `a` and `meta["reference"]` (module
    docstring): the pool and the walked structures."""
    return ReferenceTables(_reference_pool(a), ref["accel"], _reference_structs(a, ref))


def _reference_structs(a: dict, ref: dict) -> list:
    """The walked structures of `meta["reference"]` (module docstring)."""
    accel, out = ref["accel"], []
    for i, static in enumerate(ref["structs"]):
        x = [a[f"ref.{i}.{k}"] for k in REF_KEYS[accel]]
        if accel == "bvh":
            out.append(BVHArrays(*x, **static))
        elif accel == "grid":
            out.append(GridArrays(x[0], x[1], static["resolution"], x[2], x[3],
                                  static["max_cell_len"]))
        else:
            out.append(KDTreeArrays(*x, **static))
    return out


def _reference_pool(a: dict) -> TrianglePool:
    return TrianglePool(a["tris.v0"], a["tris.e1"], a["tris.e2"], a["tris.obj_id"],
                        a["tris.mat_id"], a["tris.shade"])


def scene_from_arrays(arrays: dict, meta: dict) -> DeviceScene:
    a = arrays
    if "shared.inst_minv" in a:
        return _shared_scene(a, meta)
    if "reference" in meta:
        return DeviceScene(packed=None, pool=_pool(a), reference=reference_tables(
            a, meta["reference"]), **_common(a, meta))
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
    packed = _packed_from_rows(a, "packed.", real, shade_rows[real], meta["root"],
                               meta["stack_depth"], slot_ids)
    return DeviceScene(packed=packed, pool=_pool(a), **_common(a, meta))


def _shared_scene(a: dict, meta: dict) -> DeviceScene:
    """A shared-instancing scene (module docstring): each mesh's pack with
    the pool's shading records and meta words (pool-global triangle id,
    the placeholder object and material) in slot order."""
    ref = None
    if "reference" in meta:
        ref = ReferenceTables(_reference_pool(a), "bvh", [])
        packs = _reference_structs(a, meta["reference"])
    else:
        obj_id, mat_id = np.asarray(a["tris.obj_id"]), np.asarray(a["tris.mat_id"])
        shade = np.asarray(a["tris.shade"], np.float32).copy()
        shade.view(np.int32)[:, 15] = pack.meta_words(obj_id, mat_id)
        packs = []
        for s, depth in enumerate(meta["mesh_depths"]):
            slot_tri = np.asarray(a[f"shared.packs.{s}.slot_tri"], np.int64)
            real = slot_tri >= 0
            packs.append(_packed_from_rows(a, f"shared.packs.{s}.", real,
                                           shade[slot_tri[real]], 0, depth))
    shared = SharedInstances(
        packs, **{k: a[f"shared.{k}"] for k in ("inst_minv", "inst_nrm", "inst_aabb_min",
                                                "inst_aabb_max")},
        inst_obj=np.asarray(a["shared.inst_obj"], np.int32),
        inst_mat=np.asarray(a["shared.inst_mat"], np.int32),
        inst_mesh=meta["inst_mesh"], mesh_bounds=meta["mesh_bounds"])
    return DeviceScene(packed=None, pool=_pool(a), shared=shared, reference=ref,
                       **_common(a, meta))


def prim_scene_from_arrays(arrays: dict) -> primitive_scene.PrimScene:
    """The port's `PrimScene` of a JAX `PrimScene`'s arrays (module
    docstring), on the CPU."""
    names = primitive_scene.scene_arrays().keys()
    return primitive_scene.PrimScene({k: arrays[k] for k in names}, _atlas(arrays))


def params_from_arrays(np_params: dict) -> dict:
    """The port's parameter dict (float32 tensors, on the CPU as the scene
    `scene_from_arrays` builds) of the JAX package's `extract_params`
    output as numpy arrays (module docstring)."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in np_params.items()}
