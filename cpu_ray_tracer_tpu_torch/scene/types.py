"""Device scene: every table a render needs, as buffers of one `nn.Module`,
so that `scene.to(device)` moves the whole scene.

The counterpart of the JAX package's `cpu_ray_tracer_tpu/scene/types.py`
for the TLAS-baked BVH layout.  Fields:

* `nodes`, `tris`, `shade`: the closest-hit tables (`accel/pack.py`);
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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cpu_ray_tracer_tpu_torch.accel.pack import N_COUNT, PackedBVH
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
    ):
        super().__init__()

        def buf(name, x, dtype):
            self.register_buffer(name, torch.from_numpy(np.array(x, dtype)))

        buf("nodes", packed.nodes, np.int32)
        buf("tris", packed.tris, np.float32)
        buf("shade", packed.shade, np.float32)
        buf("pool", pool, np.float32)
        self.root = packed.root
        self.depth = packed.depth
        self.root_is_leaf = bool(packed.nodes[packed.root, N_COUNT] > 0)

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
