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


def jax_compile_wide(xml: str, **kwargs):
    """`jax_compile` with the wide BVH (`CRT_WIDE=1`): the scene carries
    `packed_wide`, and its closest-hit queries take the wide kernel."""
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WIDE", "1")
        return compile_scene(xml, layout="tlas", use_pallas=True, **kwargs)


def jax_compile_xla(xml: str, accel: str):
    """The JAX package's grid or KD scene on its XLA traversal
    (`use_pallas=False`): the reference's DDA and KD descent per instance,
    chained over the forest (ops/traverse_grid.py, ops/traverse_kd.py,
    ops/forest.py)."""
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        return compile_scene(xml, layout="tlas", use_pallas=False, accel=accel)


def jax_scene_over(host: dict, shade16, obj_id, mat_id, xml: str = CUBE_XML):
    """A JAX scene over a BVH built by hand: `host` holds the node arrays
    (`node_min`, `node_max`, `left`, `right`, `axis`, `left_first`,
    `tri_count`, `tri_indices`, `root`) and the triangles `tri_v`
    [N, 3, 3], packed as the JAX compiler packs a BVH (`pack_host` +
    `attach_stack_tables`), with the materials, light and textures of the
    scene `xml`."""
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.accel import bvh_builder, pack

    tri_v = host["tri_v"]
    v0, e1, e2 = tri_v[:, 0], tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]
    hit, miss = bvh_builder.thread_links(host["left"], host["right"], host["tri_count"],
                                         host["axis"], roots=[host["root"]])
    pk = pack.pack_host(
        host["node_min"], host["node_max"], host["left_first"], host["tri_count"],
        host["tri_indices"], v0, e1, e2, hit, miss, host["root"],
        obj_id=obj_id, mat_id=mat_id, shade16=shade16,
    )
    pk = pack.attach_stack_tables(pk, host["left"], host["right"], host["axis"])
    base, _ = jax_compile(xml)
    n = tri_v.shape[0]
    zeros2 = jnp.zeros((n, 2), jnp.float32)
    nrm = jnp.asarray(shade16[:, 0:3])
    tris = base.tris.replace(
        v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2), n0=nrm, n1=nrm, n2=nrm,
        uv0=zeros2, uv1=zeros2, uv2=zeros2, obj_id=jnp.asarray(obj_id),
        mat_id=jnp.asarray(mat_id), shade=jnp.asarray(shade16),
    )
    bvh = base.bvh.replace(
        node_min=jnp.asarray(host["node_min"]), node_max=jnp.asarray(host["node_max"]),
        left_first=jnp.asarray(host["left_first"]), tri_count=jnp.asarray(host["tri_count"]),
        hit_link=jnp.asarray(hit), miss_link=jnp.asarray(miss),
        tri_indices=jnp.asarray(host["tri_indices"]), root=int(host["root"]),
    )
    return base.replace(packed=pk, tris=tris, bvh=bvh)


def jax_scene_arrays(scene):
    """(arrays, meta) of a JAX DeviceScene for `scene_from_arrays`."""
    pk, m, at = scene.packed, scene.materials, scene.atlas
    arrays = {
        "tris.v0": scene.tris.v0, "tris.e1": scene.tris.e1, "tris.e2": scene.tris.e2,
        "tris.obj_id": scene.tris.obj_id, "tris.mat_id": scene.tris.mat_id,
        "packed.slot_tri": pk.slot_tri,
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
        shadow_quirk=scene.shadow_quirk, meta_in_shade=pk.meta_in_shade,
        bilinear=scene.bilinear,
    )
    return arrays, meta
