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
* `walk`: which kernel answers the scene's closest-hit and any-hit
  queries: "stack" (the binary walk, `ops/closest_hit.py`), "links" (the
  grid and KD cell forests and a BVH too deep for the stack,
  `ops/link_walk.py`) or "wide" (`ops/wide_bvh.py`);
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

import dataclasses

import numpy as np
import torch
from torch import nn

from cpu_ray_tracer_tpu_torch.accel.pack import N_COUNT, PackedBVH
from cpu_ray_tracer_tpu_torch.accel.wide import PackedWide
from cpu_ray_tracer_tpu_torch.core.materials import MaterialTable
from cpu_ray_tracer_tpu_torch.core.textures import Atlas
from cpu_ray_tracer_tpu_torch.ops import surface


@dataclasses.dataclass
class SceneInfo:
    """Host-side scene metadata."""

    name: str
    triangle_count: int
    object_count: int
    num_nodes: int
    tree_depth: int


class DeviceScene(nn.Module):
    def __init__(
        self,
        packed: PackedBVH,
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
    ):
        super().__init__()

        def buf(name, x, dtype):
            self.register_buffer(
                name, None if x is None else torch.from_numpy(np.array(x, dtype)))

        buf("nodes", packed.nodes, np.int32)
        buf("tris", packed.tris, np.float32)
        buf("shade", packed.shade, np.float32)
        buf("slot_ids", packed.slot_ids, np.int32)
        buf("pool", pool, np.float32)
        self.root = packed.root
        self.roots = packed.roots
        self.depth = packed.depth
        self.root_is_leaf = bool(packed.nodes[packed.root, N_COUNT] > 0)
        buf("links", packed.links, np.int32)
        buf("node_records", packed.node_records, np.int32)
        self.record_root = packed.record_root
        buf("link_records", packed.link_records, np.int32)
        buf("tris4", packed.tris4, np.float32)
        buf("wide_nodes", None if wide is None else wide.nodes, np.int32)
        buf("wide_roots", None if wide is None else wide.roots, np.int32)
        buf("wide_records", None if wide is None else wide.records, np.int32)
        self.wide_stack = 0 if wide is None else wide.stack
        self.stack_walk = packed.stack
        self.leaf_codes = packed.leaf_codes
        if wide is not None:
            self.walk = "wide"
        else:
            self.walk = "stack" if packed.stack else "links"
        self.bilinear = bool(bilinear)
        self.stack_kernels = (not packed.cell_forest and packed.slot_ids is None
                              and (wide is None or wide_bounce) and not self.bilinear)

        buf("mat_albedo", materials.albedo, np.float32)
        buf("mat_reflectivity", materials.reflectivity, np.float32)
        buf("mat_refractivity", materials.refractivity, np.float32)
        buf("mat_absorption", materials.absorption, np.float32)
        buf("mat_tex_id", materials.tex_id, np.int32)
        buf("mat_is_light", materials.is_light, np.bool_)
        textured = materials.tex_id >= 0
        ts = np.maximum(materials.tex_id, 0)
        buf("mat_tex_off", np.where(textured, atlas.offset[ts], 0), np.int32)
        buf("mat_tex_w", np.where(textured, atlas.width[ts], 1), np.int32)
        buf("mat_tex_h", np.where(textured, atlas.height[ts], 1), np.int32)

        buf("atlas_texels", atlas.texels, np.float32)
        buf("atlas_packed", atlas.packed, np.int32)
        buf("atlas_offset", atlas.offset, np.int32)
        buf("atlas_width", atlas.width, np.int32)
        buf("atlas_height", atlas.height, np.int32)
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
        return self.nodes.device

    @property
    def material_count(self) -> int:
        return self.mat_albedo.shape[0]
