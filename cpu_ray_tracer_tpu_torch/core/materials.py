"""Material table, as the JAX package's `cpu_ray_tracer_tpu/core/materials.py`.

Slot layout shared by every scene:

    slot 0            — the quad light's material (is_light)
    slot 1            — the textured floor plane's material
    slots 2..2+M-1    — the scene XML's M materials, in file order
    last slot         — error material (pink) for bad lookups
                        (file_scene.cpp:6)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MaterialTable:
    """Host-side table; `scene.types.DeviceScene` holds it as buffers."""

    albedo: np.ndarray  # float32 [M, 3] (material.h default 1.0)
    reflectivity: np.ndarray  # float32 [M]
    refractivity: np.ndarray  # float32 [M]
    absorption: np.ndarray  # float32 [M, 3]
    tex_id: np.ndarray  # int32 [M] into the atlas, -1 = none
    is_light: np.ndarray  # bool [M]


def make_table(rows: list[dict]) -> MaterialTable:
    m = len(rows)
    albedo = np.ones((m, 3), np.float32)
    refl = np.zeros((m,), np.float32)
    refr = np.zeros((m,), np.float32)
    absorb = np.zeros((m, 3), np.float32)
    tex_id = np.full((m,), -1, np.int32)
    is_light = np.zeros((m,), np.bool_)
    for i, r in enumerate(rows):
        albedo[i] = r.get("albedo", (1.0, 1.0, 1.0))
        refl[i] = r.get("reflectivity", 0.0)
        refr[i] = r.get("refractivity", 0.0)
        absorb[i] = r.get("absorption", (0.0, 0.0, 0.0))
        tex_id[i] = r.get("tex_id", -1)
        is_light[i] = r.get("is_light", False)
    return MaterialTable(albedo, refl, refr, absorb, tex_id, is_light)
