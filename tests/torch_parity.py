"""Shared helpers of the `test_torch_*.py` files: run the JAX package the
way its own tests do (CPU backend, packed tables with the Pallas kernels in
interpret mode, the host-bounce path tracer, the numpy BVH builder) and
carry its scene state into the PyTorch port as numpy arrays."""

import os

import numpy as np
import pytest

from conftest import OUR_ASSETS

CUBE_XML = os.path.join(OUR_ASSETS, "scenes", "cube_scene.xml")
BENCH_XML = os.path.join(OUR_ASSETS, "scenes", "bunny_teapot.xml")
BENCH_CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))  # bench.py


def jax_reference_env(mp: pytest.MonkeyPatch) -> None:
    """The configuration the port reproduces: the host-bounce path tracer
    (no wavefront kernel), the binary packet kernel (no wide BVH), and the
    numpy builder.  The native library handle is cached per process, so
    the loader itself is patched, not only CRT_NATIVE."""
    from cpu_ray_tracer_tpu.accel import native

    mp.setenv("CRT_WAVEFRONT", "0")
    mp.setenv("CRT_WIDE", "0")
    mp.setenv("CRT_NATIVE", "0")
    mp.setattr(native, "get_lib", lambda: None)


def jax_compile(xml: str, **kwargs):
    """JAX `compile_scene(layout="tlas", use_pallas=True, **kwargs)` in the
    reference configuration."""
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        return compile_scene(xml, layout="tlas", use_pallas=True, **kwargs)


def jax_scene_arrays(scene):
    """(arrays, meta) of a JAX DeviceScene for `scene_from_arrays`."""
    pk, m, at = scene.packed, scene.materials, scene.atlas
    arrays = {
        "tris.v0": scene.tris.v0, "tris.e1": scene.tris.e1, "tris.e2": scene.tris.e2,
        "packed.node_aabb": pk.node_aabb, "packed.node_meta2": pk.node_meta2,
        "packed.tri_rows": pk.tri_rows, "packed.tri_shade_rows": pk.tri_shade_rows,
        "materials.albedo": m.albedo, "materials.reflectivity": m.reflectivity,
        "materials.refractivity": m.refractivity, "materials.absorption": m.absorption,
        "materials.tex_id": m.tex_id, "materials.is_light": m.is_light,
        "atlas.texels": at.texels, "atlas.packed": at.packed, "atlas.offset": at.offset,
        "atlas.width": at.width, "atlas.height": at.height,
        "light_t": scene.light_t, "light_inv_t": scene.light_inv_t,
        "light_size": scene.light_size, "light_color": scene.light_color,
        "floor_inv_to": scene.floor_inv_to,
    }
    if pk.node_nearfar is not None:
        arrays["packed.node_nearfar"] = pk.node_nearfar
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    meta = dict(
        root=pk.root, stack_depth=pk.stack_depth, skydome_tex=scene.skydome_tex,
        shadow_quirk=scene.shadow_quirk,
    )
    return arrays, meta
