"""Animated scenes: SetTransform, SetTime and the light's move
(BLASBVH::SetTransform blas_bvh.cpp:363-374, BaseScene::SetTime), as the
JAX package's `cpu_ray_tracer_tpu/scene/animate.py`.

`AnimatedScene` holds the parsed scene spec; its setters edit the spec,
`build()` compiles it anew and `update(scene)` gives the scene after the
edits.  On a shared-instancing scene (`instancing="shared"`) `update` is
the reference's O(1) SetTransform: new instance matrices and world boxes
(`update_shared_transforms`), every mesh's tables shared with the old
scene.  On a baked scene it rebuilds the whole scene with the options it
was built with (`builder`, `sbvh` among them; the native BVH builds take
a small share of a rebuild, PERF.md); `accel/bvh_builder.refit_bvh`
refits one tree's bounds after vertex motion where the topology may
stay (an SBVH's too: its leaves' whole-triangle boxes stay
conservative).
"""

from __future__ import annotations

import copy

import numpy as np

from cpu_ray_tracer_tpu_torch.io.scene_xml import load_scene_xml
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene, instance_tables


class AnimatedScene:
    """The spec of a scene and the `compile_scene` options to build it
    with (`device` among them); `anim_time` is stored (the reference's XML
    scenes animate nothing by default: tlas_file_scene.cpp:18)."""

    def __init__(self, xml_path: str | None = None, spec=None, **compile_opts):
        self.spec = spec if spec is not None else load_scene_xml(xml_path)
        self.compile_opts = compile_opts
        self.anim_time = 0.0

    def set_transform(self, obj_index: int, position=None, rotation_deg=None, scale=None):
        o = self.spec.objects[obj_index]
        if position is not None:
            o.position = np.asarray(position, np.float32)
        if rotation_deg is not None:
            o.rotation = np.asarray(rotation_deg, np.float32)
        if scale is not None:
            o.scale = np.asarray(scale, np.float32)

    def set_light_position(self, position):
        self.spec.light_pos = np.asarray(position, np.float32)

    def set_time(self, t: float):
        self.anim_time = t

    def build(self):
        """(DeviceScene, SceneInfo) of the spec as it stands."""
        return compile_scene(spec=self.spec, **self.compile_opts)

    def update(self, scene):
        """The scene after the spec's edits: on a shared-instancing scene
        the O(1) transform update, else a full rebuild."""
        if scene.shared is not None:
            return update_shared_transforms(scene, self.spec)
        return self.build()[0]


def update_shared_transforms(scene, spec):
    """A scene that shares every table of `scene` but its instances'
    transforms, which are recomputed from `spec`'s objects (the inverse
    TRS, the normal matrix and the world box from each mesh's root box),
    on the scene's device.  `scene` itself is left as it was."""
    sh = scene.shared
    out = copy.copy(scene)
    out._buffers, out._modules = dict(scene._buffers), dict(scene._modules)
    out._modules["shared"] = sh.with_transforms(**instance_tables(spec, sh.inst_mesh,
                                                                  sh.mesh_bounds))
    return out
