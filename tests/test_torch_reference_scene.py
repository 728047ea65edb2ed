"""`compile_scene(use_pallas=False)`: the port's reference route against the
JAX package's XLA route (`cpu_ray_tracer_tpu/scene/build.py:101-110`,
:225-302, :524-536 there).

* Its tables equal the JAX package's `use_pallas=False` tables for the
  TLAS and mono layouts with each accelerator and for shared instancing:
  the triangle pool and shading records, the fused BVH (leaves of 2), the
  grids and KD trees (one per instance on TLAS, global triangle ids),
  each unique mesh's BVH, and their static fields.
* `parity=True` takes the route, as in the JAX package, even with
  `use_pallas=True`; `RenderConfig(use_pallas=...)` maps "false" to it
  and "auto" / "true" to the kernels.
* `wide` with `use_pallas=False` raises: the JAX package builds no wide
  tables there.
* The kernel routes refuse such a scene: an explicit wavefront depth or
  Whitted level kernel raises, and the defaults take the host route.
"""

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import reference_tables
from cpu_ray_tracer_tpu_torch.utils.config import RenderConfig
from torch_parity import BENCH_XML, CUBE_XML, jax_compile_reference, jax_walk_arrays

CASES = [("tlas", "bvh", "baked"), ("tlas", "grid", "baked"), ("tlas", "kdtree", "baked"),
         ("mono", "bvh", "baked"), ("mono", "grid", "baked"), ("mono", "kdtree", "baked"),
         ("tlas", "bvh", "shared")]


def _assert_modules_equal(ours, theirs, label):
    a, b = dict(ours.named_buffers()), dict(theirs.named_buffers())
    assert a.keys() == b.keys(), label
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{label}: {k}"
    for k in ("max_leaf", "max_depth", "root", "resolution", "max_cell_len"):
        assert getattr(ours, k, None) == getattr(theirs, k, None), f"{label}: {k}"


@pytest.mark.parametrize("layout, accel, instancing", CASES,
                         ids=["-".join(c) for c in CASES])
def test_tables_equal_jax(layout, accel, instancing):
    jax_scene, jax_info = jax_compile_reference(BENCH_XML, layout=layout, accel=accel,
                                                instancing=instancing)
    port, info = compile_scene(BENCH_XML, layout=layout, accel=accel, instancing=instancing,
                               use_pallas=False, device="cpu")
    if instancing == "shared":
        assert port.walk == "instanced" and len(port.reference.structs) == 0
        structs, ours = jax_scene.shared.bvhs, list(port.shared.meshes)
        assert port.shared.inst_mesh == tuple(jax_scene.shared.inst_mesh)
        np.testing.assert_array_equal(port.shared.inst_minv.numpy(),
                                      np.asarray(jax_scene.shared.inst_minv))
        assert port.shared.slot_base == (0,) * len(ours)
    else:
        assert port.walk == "reference"
        structs = dict(bvh=jax_scene.bvh, grid=jax_scene.grid, kdtree=jax_scene.kd)[accel]
        ours = list(port.reference.structs)
    arrays, ref = jax_walk_arrays(jax_scene.tris, accel, structs)
    theirs = reference_tables(arrays, ref)
    # one grid or KD tree per instance on TLAS, one BVH per unique mesh shared
    assert len(ours) == len(theirs.structs) == (3 if layout == "tlas" and accel != "bvh" else
                                                2 if instancing == "shared" else 1)
    for i, (a, b) in enumerate(zip(ours, theirs.structs)):
        _assert_modules_equal(a, b, f"struct {i}")
    _assert_modules_equal(port.reference.tris, theirs.tris, "pool")
    # the scene's shading table is the pool's, by triangle id
    np.testing.assert_array_equal(port.shade.numpy(), np.asarray(jax_scene.tris.shade))
    assert not port.stack_kernels
    assert info.triangle_count == jax_info.triangle_count
    if accel == "bvh" and instancing == "baked":
        for key in ("max_depth", "num_nodes", "num_leaves", "max_leaf"):
            assert getattr(info.build_stats, key) == getattr(jax_info.build_stats, key), key
        assert info.max_tree_depth == jax_info.max_tree_depth


def test_parity_takes_the_reference_route():
    """`parity=True` walks the reference tables with the reference's SAH
    stop, whatever `use_pallas` says (the JAX package's
    scene/build.py:105-116)."""
    jax_scene, _ = jax_compile_reference(CUBE_XML, parity=True)
    for use_pallas in (None, True):
        port, _ = compile_scene(CUBE_XML, parity=True, use_pallas=use_pallas, device="cpu")
        assert port.walk == "reference"
        arrays, ref = jax_walk_arrays(jax_scene.tris, "bvh", jax_scene.bvh)
        _assert_modules_equal(port.reference.structs[0], reference_tables(arrays, ref).structs[0],
                              "parity bvh")


@pytest.mark.parametrize("value, walk", [("false", "reference"), ("true", "stack"),
                                         ("auto", "stack")])
def test_config_maps_use_pallas(value, walk):
    cfg = RenderConfig(scene_xml=CUBE_XML, use_pallas=value, device="cpu")
    scene, _ = cfg.build_scene()
    assert scene.walk == walk


@pytest.mark.parametrize("wide", [True, "bounce"])
def test_wide_refused_on_the_reference_route(wide):
    with pytest.raises(ValueError, match="use_pallas=False"):
        compile_scene(CUBE_XML, wide=wide, use_pallas=False, device="cpu")


def test_kernel_routes_refuse_the_scene():
    """The wavefront and Whitted level kernels walk the kernels' tables:
    asked for explicitly on a reference scene they raise, and by default
    the renders take the host route (counters from the reference
    walks)."""
    scene, _ = compile_scene(CUBE_XML, use_pallas=False, device="cpu")
    camera = cam_mod.make_camera(8, 4)
    with pytest.raises(ValueError, match="'reference'"):
        pathtracer.render_pass(scene, camera, 0, wavefront_depths=1)
    with pytest.raises(ValueError, match="'reference'"):
        whitted.render(scene, camera, level_kernel=True)
    assert pathtracer.wavefront_depths_for(scene, None) == 0
    assert whitted.level_kernel_for(scene, None) is False
    img, stats = pathtracer.render_pass(scene, camera, 0)
    assert torch.isfinite(img).all() and int(stats["tested"].sum()) > 0
    # cube_scene's 12 triangles make several leaves of 2: rays take steps
    assert int(stats["traversed"].sum()) > 0
