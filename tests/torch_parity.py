"""Shared helpers of the `test_torch_*.py` files: run the JAX package the
way its own tests do (CPU backend, packed tables with the Pallas kernels in
interpret mode, the host-bounce path tracer, its default native BVH
builder, or with `numpy=True` its numpy one) and carry its scene state
into the PyTorch port as numpy arrays."""

import os
import time

import numpy as np
import pytest

from conftest import OUR_ASSETS

CUBE_XML = os.path.join(OUR_ASSETS, "scenes", "cube_scene.xml")
BENCH_XML = os.path.join(OUR_ASSETS, "scenes", "bunny_teapot.xml")
BENCH_CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))  # bench.py


def jax_reference_env(mp: pytest.MonkeyPatch, numpy: bool = False, sbvh: bool = False) -> None:
    """The configuration the port reproduces: the host-bounce path tracer
    (no wavefront kernel), the binary packet kernel (no wide BVH), and the
    JAX package's default BVH builder, the native one, which the port's
    `compile_scene` defaults to as well.  The library must load: a JAX
    package that fell back to its numpy builder would be compared with the
    port's native trees.  `numpy=True` takes the numpy builder instead
    (`CRT_NATIVE=0`, for the port's `builder="numpy"`; the library handle
    is cached per process, so the loader itself is patched), `sbvh=True`
    the SBVH (`CRT_SBVH=1`, for the port's `sbvh=True`)."""
    from cpu_ray_tracer_tpu.accel import native

    mp.setenv("CRT_WAVEFRONT", "0")
    mp.setenv("CRT_WIDE", "0")
    if numpy:
        mp.setenv("CRT_NATIVE", "0")
        mp.setattr(native, "get_lib", lambda: None)
    else:
        mp.delenv("CRT_NATIVE", raising=False)
        for _ in range(3):
            if native.get_lib() is not None:
                break
            # another test process may have been writing the library: load anew
            time.sleep(1.0)
            native._tried = False
        assert native.get_lib() is not None, "the JAX package's native library did not load"
    if sbvh:
        mp.setenv("CRT_SBVH", "1")
    else:
        mp.delenv("CRT_SBVH", raising=False)


def jax_compile(xml: str, layout: str = "tlas", numpy: bool = False, sbvh: bool = False,
                **kwargs):
    """JAX `compile_scene(layout=layout, use_pallas=True, **kwargs)` in the
    reference configuration (`parity=True` turns the kernels off there),
    with the builder `jax_reference_env` picks for `numpy` and `sbvh`."""
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp, numpy=numpy, sbvh=sbvh)
        return compile_scene(xml, layout=layout, use_pallas=True, **kwargs)


def jax_compile_wide(xml: str, sbvh: bool = False, **kwargs):
    """`jax_compile` with the wide BVH (`CRT_WIDE=1`): the scene carries
    `packed_wide`, and its closest-hit queries take the wide kernel;
    `sbvh=True` collapses SBVHs (`CRT_SBVH=1`)."""
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp, sbvh=sbvh)
        mp.setenv("CRT_WIDE", "1")
        return compile_scene(xml, layout="tlas", use_pallas=True, **kwargs)


def assert_wide_tables_equal(jax_scene, port) -> None:
    """The port's wide collapse (`compile_scene(wide=...)`) equals the JAX
    package's `packed_wide` (accel/wide.py): each wide node's 8 child
    boxes (NaN for empty slots), its 8 per-octant order words, its
    interior children, and the triangles of its leaf children (the port
    names the binary pack's slots where the JAX package regroups rows)."""
    from cpu_ray_tracer_tpu_torch.accel import pack, wide

    pk = jax_scene.packed_wide
    nodes = port.wide_nodes.numpy()
    assert nodes.shape == (pk.num_wide, wide.WIDE_WORDS)
    assert port.wide_roots.tolist() == list(pk.stack_roots)
    boxes = nodes[:, : 6 * wide.WIDE].view(np.float32)
    np.testing.assert_array_equal(boxes, np.asarray(pk.aabb48).T)  # NaN slots alike
    np.testing.assert_array_equal(nodes[:, wide.W_ORDER:], np.asarray(pk.orderw).T)
    child = nodes[:, wide.W_CHILD : wide.W_CHILD + wide.WIDE]
    cmeta = np.asarray(pk.cmeta).T
    # the port's leaf word is ~(count << 22 | first) (the in-tree scenes'
    # leaves fit it), the JAX package's row | nrows << 22
    assert port.leaf_codes
    shift, mask = pack.LEAF_SHIFT, (1 << pack.LEAF_SHIFT) - 1
    leaf, jax_leaf = child < 0, cmeta >> shift > 0
    np.testing.assert_array_equal(leaf, jax_leaf)
    np.testing.assert_array_equal(child[~leaf], cmeta[~jax_leaf])  # interior ids, empty 0
    # leaf children: the same triangles in the same order
    meta = port.shade.numpy().view(np.int32)[:, 15] & 0xFFFFF
    slot_tri = np.asarray(pk.slot_tri)
    for w, k in zip(*np.nonzero(leaf)):
        first, count = ~child[w, k] & mask, ~child[w, k] >> shift
        row, nrows = cmeta[w, k] & mask, cmeta[w, k] >> shift
        ids = slot_tri[row * 8 : (row + nrows) * 8]
        assert meta[first : first + count].tolist() == ids[ids >= 0].tolist(), (w, k)


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


def jax_compile_reference(xml: str, layout: str = "tlas", numpy: bool = False,
                          sbvh: bool = False, **kwargs):
    """JAX `compile_scene(layout=layout, use_pallas=False, **kwargs)`: the
    XLA traversals over the reference's tables (leaves of 2), with the
    builder `jax_reference_env` picks for `numpy` and `sbvh`."""
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp, numpy=numpy, sbvh=sbvh)
        return compile_scene(xml, layout=layout, use_pallas=False, **kwargs)


def jax_scene_arrays(scene):
    """(arrays, meta) of a JAX DeviceScene for `scene_from_arrays`, a
    shared-instancing one and one of the XLA route (`use_pallas=False`)
    included."""
    if not scene.use_pallas:
        return _jax_reference_arrays(scene)
    if scene.shared is not None:
        return _jax_shared_arrays(scene)
    pk = scene.packed
    arrays, meta = _jax_common_arrays(scene)
    arrays.update({
        "packed.slot_tri": pk.slot_tri,
        "packed.node_aabb": pk.node_aabb, "packed.node_meta2": pk.node_meta2,
        "packed.tri_rows": pk.tri_rows, "packed.tri_shade_rows": pk.tri_shade_rows,
    })
    if pk.node_nearfar is not None:
        arrays["packed.node_nearfar"] = pk.node_nearfar
    meta.update(root=pk.root, stack_depth=pk.stack_depth, meta_in_shade=pk.meta_in_shade)
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


def _jax_reference_arrays(scene):
    """The arrays of a JAX scene of the XLA route (`scene/convert.py`):
    its walk tables (`jax_walk_arrays`) and the common ones."""
    arrays, meta = _jax_common_arrays(scene)
    if scene.shared is not None:
        accel, structs = "bvh", scene.shared.bvhs
        for k in ("inst_minv", "inst_nrm", "inst_aabb_min", "inst_aabb_max", "inst_obj",
                  "inst_mat"):
            arrays[f"shared.{k}"] = getattr(scene.shared, k)
        meta.update(inst_mesh=scene.shared.inst_mesh, mesh_bounds=scene.shared.mesh_bounds)
    else:
        accel = scene.accel_kind
        structs = dict(bvh=scene.bvh, grid=scene.grid, kdtree=scene.kd)[accel]
    walk, meta["reference"] = jax_walk_arrays(scene.tris, accel, structs)
    arrays.update(walk)
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


def jax_walk_arrays(tris, accel: str, structs):
    """(arrays, reference meta) of the JAX package's XLA walk tables for
    `scene/convert.reference_tables`: the pool `tris` and the structures
    `structs` (one, or a tuple walked as a forest) of kind `accel`."""
    from cpu_ray_tracer_tpu_torch.scene.convert import REF_KEYS

    arrays = {f"tris.{k}": getattr(tris, k) for k in ("v0", "e1", "e2", "obj_id", "mat_id",
                                                       "shade")}
    structs = list(structs) if isinstance(structs, (tuple, list)) else [structs]
    statics = []
    for i, st in enumerate(structs):
        for k in REF_KEYS[accel]:
            arrays[f"ref.{i}.{k}"] = getattr(st, k)
        if accel == "bvh":
            statics.append(dict(max_leaf=st.max_leaf, max_depth=st.max_depth, root=st.root))
        elif accel == "grid":
            statics.append(dict(resolution=st.resolution, max_cell_len=st.max_cell_len))
        else:
            statics.append(dict(max_depth=st.max_depth, max_leaf=st.max_leaf))
    return {k: np.asarray(v) for k, v in arrays.items()}, dict(accel=accel, structs=statics)


def _jax_shared_arrays(scene):
    sh = scene.shared
    arrays, meta = _jax_common_arrays(scene)
    arrays["tris.shade"] = scene.tris.shade
    for k in ("inst_minv", "inst_nrm", "inst_aabb_min", "inst_aabb_max", "inst_obj", "inst_mat"):
        arrays[f"shared.{k}"] = getattr(sh, k)
    for s, pk in enumerate(sh.packs):
        for k in ("node_aabb", "node_meta2", "tri_rows", "slot_tri", "node_nearfar"):
            if getattr(pk, k) is not None:
                arrays[f"shared.packs.{s}.{k}"] = getattr(pk, k)
    meta.update(inst_mesh=sh.inst_mesh, mesh_bounds=sh.mesh_bounds,
                mesh_depths=[pk.stack_depth or 1 for pk in sh.packs])
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


def jax_prim_arrays(scene):
    """The arrays of a JAX `PrimScene` for `prim_scene_from_arrays`."""
    at = scene.atlas
    arrays = {k: getattr(scene, k) for k in (
        "light_t", "light_inv_t", "light_size", "light_color", "sphere_pos", "sphere_r2",
        "sphere_inv_r", "cube_m", "cube_inv_m", "cube_bmin", "cube_bmax", "plane_n", "plane_d",
        "torus_t", "torus_inv_t", "torus_rc2", "torus_rt2", "torus_r2")}
    arrays.update({"atlas.texels": at.texels, "atlas.packed": at.packed, "atlas.offset": at.offset,
                   "atlas.width": at.width, "atlas.height": at.height})
    return {k: np.asarray(v) for k, v in arrays.items()}


def _jax_common_arrays(scene):
    m, at = scene.materials, scene.atlas
    arrays = {
        "tris.v0": scene.tris.v0, "tris.e1": scene.tris.e1, "tris.e2": scene.tris.e2,
        "tris.obj_id": scene.tris.obj_id, "tris.mat_id": scene.tris.mat_id,
        "materials.albedo": m.albedo, "materials.reflectivity": m.reflectivity,
        "materials.refractivity": m.refractivity, "materials.absorption": m.absorption,
        "materials.tex_id": m.tex_id, "materials.is_light": m.is_light,
        "atlas.texels": at.texels, "atlas.packed": at.packed, "atlas.offset": at.offset,
        "atlas.width": at.width, "atlas.height": at.height,
        "light_t": scene.light_t, "light_inv_t": scene.light_inv_t,
        "light_size": scene.light_size, "light_color": scene.light_color,
        "floor_inv_to": scene.floor_inv_to,
    }
    meta = dict(skydome_tex=scene.skydome_tex, shadow_quirk=scene.shadow_quirk,
                bilinear=scene.bilinear)
    return arrays, meta
