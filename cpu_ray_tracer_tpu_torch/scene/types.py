"""Device scene: every table a render needs, as buffers of one `nn.Module`,
so that `scene.to(device)` moves the whole scene.

The counterpart of the JAX package's `cpu_ray_tracer_tpu/scene/types.py`
for the TLAS-baked layout, over any of its accelerators.  Fields:

* `nodes`, `tris`, `shade`: the closest-hit tables (`accel/pack.py`);
  `slot_ids` int32 [S, 4], each slot's (tri, obj, mat) where the ids do
  not fit the meta word in lane 15 of `shade`, else None;
* `links` (cell forests, and a BVH deeper than the stack walk's
  `STACK_CAP`) and `wide_nodes`, `wide_roots` (a wide BVH): the tables of
  the link walk and the wide walk, None where absent; `roots`, the
  forest's roots in walk order; `wide_stack`, the most node ids the wide
  walk's stack holds at once from one root (`accel/wide.py`);
* the tables the CUDA walks read, built from those (`accel/pack.py`):
  `node_records` int32 [M, 16] (the binary stack walk: both children's
  boxes and refs and the per-octant swap mask in one 64-byte record per
  interior node) with its start `record_root` (the root, or ~root for a
  one-leaf tree); `link_records` int32 [8, M, 8] (the link walk: box, hit
  link or leaf, miss link in one 32-byte record per octant and node; None
  without `links`); `wide_records` int32 [W, 64] (the wide walk:
  `wide_nodes` with the boxes field-major, for 16-byte loads;
  `accel/wide.py`); `tris4` float32 [S, 12] (`tris` with v0, e1, e2
  padded to 16 bytes each);
* `walk`: which walk answers the scene's closest-hit and any-hit
  queries: "stack" (the binary walk, `ops/closest_hit.py`), "links" (the
  grid and KD cell forests and a BVH too deep for the stack,
  `ops/link_walk.py`), "wide" (`ops/wide_bvh.py`), "reference" (the
  reference walks of `use_pallas=False`, plain PyTorch: `reference`) or
  "instanced" (a shared-instancing scene: one walk per instance over its
  mesh's tables, `scene/query.py`);
* `reference`: the reference walks' tables (`ReferenceTables`), else
  None.  Such a scene has no kernel tables: `shade` holds the pool's
  shading records by pool id (a hit's `slot` is its triangle id), and
  `stack_kernels` is False (the JAX package's `_kernel_scene_eligible`
  turns its `use_pallas=False` scenes away as well);
* `shared`: a shared-instancing scene's `SharedInstances`, else None.
  Such a scene has no walk fields of its own: `shade` holds its meshes'
  shading records one after another, `pool` the unique meshes'
  object-space triangles, and `stack_kernels` is False (the JAX package's
  `_kernel_scene_eligible` turns shared scenes away as well);
* `leaf_codes`: the walk records' leaf code form (`accel/pack.py`): the
  count beside the first slot, or the first slot alone;
* `stack_walk`: whether the binary stack walk serves the tree (a BVH of
  depth <= STACK_CAP); the wavefront and Whitted level kernels walk the
  stack tables where it does and the link tables where it does not (the
  JAX package's gate, wavefront_pt.py:563-568);
* `bilinear`: textures take the bilinear tap of the float atlas
  (`core/textures.py`), differentiable in the texels, instead of the
  nearest tap of the packed one;
* `stack_kernels`: whether the wavefront and Whitted level kernels may
  serve the scene: a binary BVH, alone or with wide tables for the host
  queries only (`wide_bounce`, the JAX package's `CRT_WIDE=bounce`), whose
  ids fit the meta word, with nearest taps (the kernels record nearest
  texel indices) (the JAX package's `_kernel_scene_eligible`,
  render/pathtracer.py:473-500, which also turns away the cell forests
  and bilinear scenes);
* `pool` float32 [N, 9]: v0, e1, e2 of every triangle by pool id (the
  triangle pool; hit ids index it);
* `mat_*`: the material table, plus each material's texture offset, width
  and height joined from the atlas (`mat_tex_off` / `_w` / `_h`);
* `atlas_*`: the texture atlas (`core/textures.py`);
* the quad light (object 0) and the floor plane (object 1):
  `light_t`, `light_inv_t`, `light_size`, `light_color`, `floor_inv_to`;
* `shadow_quirk`: shadow rays test triangles to RAY_FAR instead of to the
  light (the reference's file_scene.cpp:177-187; the JAX package's
  default, `cpu_ray_tracer_tpu/scene/types.py:95`);
* `kernel_params`: the light, floor and material scalars packed once for
  the wavefront and Whitted kernels (`ops/surface.kernel_params`).

`diff/grad.apply_params` swaps differentiable tensors in for the
material, texel, light-colour and pool buffers of a copy of the scene.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from cpu_ray_tracer_tpu_torch.accel.bvh_builder import BuildStats
from cpu_ray_tracer_tpu_torch.accel.types import BVHArrays, TrianglePool
from cpu_ray_tracer_tpu_torch.accel.pack import N_COUNT, PackedBVH
from cpu_ray_tracer_tpu_torch.accel.wide import PackedWide
from cpu_ray_tracer_tpu_torch.core.materials import MaterialTable
from cpu_ray_tracer_tpu_torch.core.textures import Atlas
from cpu_ray_tracer_tpu_torch.ops import forest, surface, traverse_bvh, traverse_grid, traverse_kd


@dataclasses.dataclass
class SceneInfo:
    """Host-side scene metadata: counts, the size and depth of the tree the
    walks take (`num_nodes`, `tree_depth`, as `DeviceScene.depth`), and the
    builds' statistics (the data behind the reference's GetBuildTime /
    GetMaxTreeDepth; the JAX package's scene/types.py:117-135):
    `build_stats` of the scene's tree, and on the TLAS layout those of
    each instance's tree in `blas_stats`; the BVH `builder` ("native" or
    "numpy") and whether its BVHs were asked for as SBVHs (`sbvh`)."""

    name: str
    triangle_count: int
    object_count: int
    num_nodes: int
    tree_depth: int
    build_stats: BuildStats
    blas_stats: list = dataclasses.field(default_factory=list)
    builder: str = "native"
    sbvh: bool = False

    @property
    def build_time_us(self) -> int:
        return self.build_stats.build_time_us + sum(s.build_time_us for s in self.blas_stats)

    @property
    def max_tree_depth(self) -> int:
        return max([self.build_stats.max_depth] + [s.max_depth for s in self.blas_stats])


def _buffer(module: nn.Module, name: str, x, dtype) -> None:
    module.register_buffer(name, None if x is None else torch.from_numpy(np.array(x, dtype)))


def register_walk(module: nn.Module, packed: PackedBVH) -> None:
    """Register the closest-hit tables of `packed` on `module` as the walk
    fields of the module docstring (`nodes`, `tris`, `shade`, `slot_ids`,
    `links`, `node_records`, `link_records`, `tris4`, the roots, `depth`,
    `leaf_codes`, `stack_walk`) and `walk`: "stack", or "links" for a tree
    the stack walk does not serve."""
    for name, x, dtype in (
            ("nodes", packed.nodes, np.int32), ("tris", packed.tris, np.float32),
            ("shade", packed.shade, np.float32), ("slot_ids", packed.slot_ids, np.int32),
            ("links", packed.links, np.int32), ("node_records", packed.node_records, np.int32),
            ("link_records", packed.link_records, np.int32), ("tris4", packed.tris4, np.float32)):
        _buffer(module, name, x, dtype)
    module.root = packed.root
    module.roots = packed.roots
    module.depth = packed.depth
    module.root_is_leaf = bool(packed.nodes[packed.root, N_COUNT] > 0)
    module.record_root = packed.record_root
    module.stack_walk = packed.stack
    module.leaf_codes = packed.leaf_codes
    module.walk = "stack" if packed.stack else "links"


def register_materials(module: nn.Module, materials: MaterialTable, atlas: Atlas) -> None:
    """Register the material table (`mat_*`, with each material's texture
    offset, width and height joined from the atlas) and the atlas
    (`atlas_*`) on `module`."""
    for name, x, dtype in (
            ("mat_albedo", materials.albedo, np.float32),
            ("mat_reflectivity", materials.reflectivity, np.float32),
            ("mat_refractivity", materials.refractivity, np.float32),
            ("mat_absorption", materials.absorption, np.float32),
            ("mat_tex_id", materials.tex_id, np.int32),
            ("mat_is_light", materials.is_light, np.bool_)):
        _buffer(module, name, x, dtype)
    textured = materials.tex_id >= 0
    ts = np.maximum(materials.tex_id, 0)
    _buffer(module, "mat_tex_off", np.where(textured, atlas.offset[ts], 0), np.int32)
    _buffer(module, "mat_tex_w", np.where(textured, atlas.width[ts], 1), np.int32)
    _buffer(module, "mat_tex_h", np.where(textured, atlas.height[ts], 1), np.int32)
    for name, x, dtype in (
            ("atlas_texels", atlas.texels, np.float32), ("atlas_packed", atlas.packed, np.int32),
            ("atlas_offset", atlas.offset, np.int32), ("atlas_width", atlas.width, np.int32),
            ("atlas_height", atlas.height, np.int32)):
        _buffer(module, name, x, dtype)


class MeshTables(nn.Module):
    """One unique mesh's closest-hit tables on a shared-instancing scene:
    the walk fields of a baked scene (`register_walk`) over the mesh's
    object-space BVH, so that `ops/closest_hit` and `ops/link_walk` walk it
    as they walk a baked scene.  Its slots are the mesh's own; the meta
    word carries the pool-global triangle id."""

    def __init__(self, packed: PackedBVH):
        super().__init__()
        register_walk(self, packed)

    @property
    def device(self) -> torch.device:
        return self.tris4.device


class ReferenceTables(nn.Module):
    """The tables of the reference walks (`compile_scene(use_pallas=
    False)`, the JAX package's XLA route): `tris`, the `TrianglePool`;
    `accel` "bvh", "grid" or "kdtree"; `structs`, a ModuleList of the
    walked structures: one `BVHArrays` (the fused TLAS forest, or the
    mono tree), or one `GridArrays` / `KDTreeArrays` per instance on the
    TLAS layout (global triangle ids; the walk chains them,
    `ops/forest.py`) and one on the mono layout.  A shared-instancing
    scene keeps its meshes' BVHs in `SharedInstances` and none here."""

    def __init__(self, tris: TrianglePool, accel: str, structs: list):
        super().__init__()
        self.tris = tris
        self.accel = accel
        self.structs = nn.ModuleList(structs)

    def walk(self, o: torch.Tensor, d: torch.Tensor, t0: torch.Tensor, any_hit: bool) -> dict:
        """The reference walk's hit dict (`ops/traverse_bvh.py`) of rays o, d
        from t0 (the JAX package's `_traverse_accel`, scene/query.py:106-139
        there)."""
        if self.accel == "bvh":
            return traverse_bvh.traverse(self.structs[0], self.tris, o, d, t0, any_hit)
        fn = traverse_grid.traverse if self.accel == "grid" else traverse_kd.traverse
        return forest.traverse_forest(fn, self.structs, self.tris, o, d, t0, any_hit)


class SharedInstances(nn.Module):
    """Object-space shared-BLAS instancing tables (`instancing="shared"`),
    as the JAX package's `SharedInstances` (scene/types.py:22-70 there):
    the reference's BLASBVH (blas_bvh.cpp:376-389), where N instances share
    one BLAS and SetTransform is O(1).  One object-space BVH per unique
    mesh (`meshes`, a ModuleList of `MeshTables`); a query makes one
    masked pass per instance over its mesh's tables with the rays moved
    into object space by the instance's inverse TRS, directions not
    renormalised, so that t is one scalar in both spaces
    (`scene/query.py`).  Buffers:

    * `inst_minv` float32 [I, 4, 4]: world to object, the full TRS inverse;
    * `inst_nrm` float32 [I, 3, 3]: the inverse-transpose of the linear
      part (object normal to world);
    * `inst_aabb_min`, `inst_aabb_max` float32 [I, 3]: each instance's
      world box, the early-out against the running best t (the TLAS's
      role);
    * `inst_obj`, `inst_mat` int32 [I]: the object id (2 + i) and the
      material of each instance.

    `inst_mesh` (tuple) maps an instance to its mesh, `mesh_bounds` holds
    each mesh's object-space root box ((min3, max3), all that a transform
    change needs to recompute the world boxes), `slot_base` each mesh's
    first slot in the scene's concatenated `shade` table.

    On the reference route (`use_pallas=False`) `meshes` holds each mesh's
    reference `BVHArrays` (pool-global triangle ids), walked by
    `ops/traverse_bvh.py` over the scene's `reference.tris`; a hit's slot
    is then its pool id (`slot_base` all 0).

    A known, bounded difference from the baked forest, kept from the JAX
    package: Moller-Trumbore runs in unscaled object space, where a
    grazing sliver's determinant is about s^3 larger than in world space,
    so a world |det| just under TRI_EPS can be accepted here
    (tests/test_instancing.py::test_bench_scale_multi_mesh there)."""

    def __init__(self, meshes: list, inst_minv, inst_nrm, inst_aabb_min,
                 inst_aabb_max, inst_obj, inst_mat, inst_mesh, mesh_bounds):
        super().__init__()
        reference = isinstance(meshes[0], BVHArrays)
        self.meshes = nn.ModuleList(meshes if reference else [MeshTables(p) for p in meshes])
        self.inst_mesh = tuple(int(m) for m in inst_mesh)
        self.mesh_bounds = tuple(mesh_bounds)
        sizes = [0 if reference else p.tris.shape[0] for p in meshes]
        self.slot_base = tuple(int(x) for x in np.cumsum([0] + sizes)[:-1])
        self.set_transforms(inst_minv, inst_nrm, inst_aabb_min, inst_aabb_max)
        _buffer(self, "inst_obj", inst_obj, np.int32)
        _buffer(self, "inst_mat", inst_mat, np.int32)

    def set_transforms(self, inst_minv, inst_nrm, inst_aabb_min, inst_aabb_max) -> None:
        """Register the transform buffers (numpy), on the device of the
        mesh tables."""
        dev = self.meshes[0].device
        for name, x in (("inst_minv", inst_minv), ("inst_nrm", inst_nrm),
                        ("inst_aabb_min", inst_aabb_min), ("inst_aabb_max", inst_aabb_max)):
            self.register_buffer(name, torch.from_numpy(np.array(x, np.float32)).to(dev))

    def with_transforms(self, inst_minv, inst_nrm, inst_aabb_min, inst_aabb_max):
        """A copy that shares every mesh table and the id buffers, with new
        transform buffers: the O(1) SetTransform."""
        out = copy.copy(self)
        out._buffers = dict(self._buffers)
        out.set_transforms(inst_minv, inst_nrm, inst_aabb_min, inst_aabb_max)
        return out


class DeviceScene(nn.Module):
    def __init__(
        self,
        packed: PackedBVH | None,
        pool: np.ndarray,
        materials: MaterialTable,
        atlas: Atlas,
        light_t: np.ndarray,
        light_inv_t: np.ndarray,
        light_size: float,
        light_color: np.ndarray,
        floor_inv_to: float,
        skydome_tex: int,
        shadow_quirk: bool = True,
        wide: PackedWide | None = None,
        wide_bounce: bool = False,
        bilinear: bool = False,
        shared: SharedInstances | None = None,
        reference: ReferenceTables | None = None,
    ):
        super().__init__()

        def buf(name, x, dtype):
            _buffer(self, name, x, dtype)

        buf("pool", pool, np.float32)
        self.shared = shared
        self.reference = reference
        if reference is not None:
            # the pool's shading records: a hit's slot is its pool id
            buf("shade", reference.tris.shade.numpy(), np.float32)
            self.walk = "reference"
        elif shared is None:
            register_walk(self, packed)
        else:
            # the meshes' shading records one after another: a hit's slot
            # plus its mesh's `slot_base` indexes them
            buf("shade", np.concatenate([m.shade.numpy() for m in shared.meshes]), np.float32)
        if shared is not None:
            self.walk = "instanced"
        buf("wide_nodes", None if wide is None else wide.nodes, np.int32)
        buf("wide_roots", None if wide is None else wide.roots, np.int32)
        buf("wide_records", None if wide is None else wide.records, np.int32)
        self.wide_stack = 0 if wide is None else wide.stack
        if wide is not None:
            self.walk = "wide"
        self.bilinear = bool(bilinear)
        self.stack_kernels = (shared is None and reference is None and not packed.cell_forest
                              and packed.slot_ids is None and (wide is None or wide_bounce)
                              and not self.bilinear)

        register_materials(self, materials, atlas)
        self.skydome_tex = int(skydome_tex)

        buf("light_t", light_t, np.float32)
        buf("light_inv_t", light_inv_t, np.float32)
        buf("light_size", np.float32(light_size), np.float32)
        buf("light_color", light_color, np.float32)
        buf("floor_inv_to", np.float32(floor_inv_to), np.float32)
        self.shadow_quirk = bool(shadow_quirk)
        self.register_buffer("kernel_params", surface.kernel_params(self))

    @property
    def device(self) -> torch.device:
        return self.pool.device

    @property
    def material_count(self) -> int:
        return self.mat_albedo.shape[0]
