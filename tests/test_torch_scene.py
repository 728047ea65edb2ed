"""The port's scene compiler against the JAX package's
`compile_scene(layout="tlas", use_pallas=True)`: node bounds, near/far
child tables, per-leaf triangle lists in order, tree depth, materials,
atlas and light matrices must be EQUAL, and the scene carried across with
`scene_from_arrays` must equal the one the port compiles itself."""

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import pathtracer
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_parity import BENCH_XML, CUBE_XML, jax_compile, jax_scene_arrays

XMLS = {"cube_scene": CUBE_XML, "bunny_teapot": BENCH_XML}


@pytest.fixture(scope="module", params=list(XMLS))
def pair(request):
    xml = XMLS[request.param]
    jax_scene, jax_info = jax_compile(xml)
    port, info = compile_scene(xml, device="cpu")
    return jax_scene, jax_info, port, info


def _jax_leaf_lists(pk):
    """{leaf node: pool triangle ids in slot order} from the JAX packing
    (8 slots per row, padding slots carry an all-zero record)."""
    meta = np.asarray(pk.tri_shade_rows).reshape(-1, 16).view(np.int32)[:, 15]
    start, nrows = np.asarray(pk.node_meta2)
    out = {}
    for n in np.nonzero(nrows > 0)[0]:
        m = meta[start[n] * 8 : (start[n] + nrows[n]) * 8]
        out[int(n)] = (m[m != 0] & 0xFFFFF).tolist()
    return out


def _port_leaf_lists(scene):
    nodes = scene.nodes.numpy()
    meta = scene.shade.numpy().view(np.int32)[:, 15]
    first, count = nodes[:, pack.N_FIRST], nodes[:, pack.N_COUNT]
    return {
        int(n): (meta[first[n] : first[n] + count[n]] & 0xFFFFF).tolist()
        for n in np.nonzero(count > 0)[0]
    }


def test_node_bounds_equal(pair):
    jax_scene, _, port, info = pair
    f = port.nodes.numpy().view(np.float32)
    aabb = np.asarray(jax_scene.packed.node_aabb)
    np.testing.assert_array_equal(f[:, 0:3], aabb[:3].T)
    np.testing.assert_array_equal(f[:, 3:6], aabb[3:].T)
    assert port.root == jax_scene.packed.root
    assert info.triangle_count == jax_scene.tris.v0.shape[0]


def test_nearfar_tables_equal(pair):
    jax_scene, _, port, _ = pair
    nf = port.nodes.numpy()[:, pack.N_NEARFAR :].reshape(-1, 8, 2).transpose(1, 2, 0)
    if jax_scene.packed.node_nearfar is None:
        # one-leaf tree: the JAX packer attaches no table, the port's is all -1
        assert port.root_is_leaf and (nf == -1).all()
    else:
        np.testing.assert_array_equal(nf, np.asarray(jax_scene.packed.node_nearfar))


def test_leaf_triangle_lists_equal(pair):
    jax_scene, _, port, _ = pair
    assert _port_leaf_lists(port) == _jax_leaf_lists(jax_scene.packed)
    # and the triangles behind the ids: v0, e1, e2 of the JAX rows
    rows = np.asarray(jax_scene.packed.tri_rows).reshape(-1, 16)
    meta = np.asarray(jax_scene.packed.tri_shade_rows).reshape(-1, 16).view(np.int32)[:, 15]
    np.testing.assert_array_equal(port.tris.numpy(), rows[meta != 0, :9])


def test_tree_depth_equal(pair):
    jax_scene, _, port, info = pair
    want = jax_scene.packed.stack_depth or 1  # 0 = "root is a leaf" there
    assert port.depth == info.tree_depth == want


def test_materials_atlas_lights_equal(pair):
    jax_scene, _, port, _ = pair
    m, a = jax_scene.materials, jax_scene.atlas
    pairs = {
        "mat_albedo": m.albedo, "mat_reflectivity": m.reflectivity,
        "mat_refractivity": m.refractivity, "mat_absorption": m.absorption,
        "mat_tex_id": m.tex_id, "mat_is_light": m.is_light,
        "atlas_texels": a.texels, "atlas_offset": a.offset,
        "atlas_width": a.width, "atlas_height": a.height,
        "light_t": jax_scene.light_t, "light_inv_t": jax_scene.light_inv_t,
        "light_size": jax_scene.light_size, "light_color": jax_scene.light_color,
        "floor_inv_to": jax_scene.floor_inv_to,
    }
    for name, want in pairs.items():
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(port.atlas_packed.numpy(), np.asarray(a.packed).astype(np.int32))
    assert port.skydome_tex == jax_scene.skydome_tex


def test_scene_from_arrays_equals_port_compile(pair):
    jax_scene, _, port, _ = pair
    carried = scene_from_arrays(*jax_scene_arrays(jax_scene))
    want = port.state_dict()
    got = carried.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if g.dtype == torch.float32:  # kernel_params bit-casts ints (NaN patterns)
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), k
    assert (carried.root, carried.depth, carried.skydome_tex) == (port.root, port.depth, port.skydome_tex)


def test_scene_moves_with_to():
    """Every table is a buffer: `.to(device)` moves the whole scene."""
    scene, _ = compile_scene(CUBE_XML, device="cpu")
    scene.to("meta")
    assert scene.device.type == "meta"
    assert all(b.device.type == "meta" for b in scene.buffers())
    assert len(list(scene.buffers())) == len(scene.state_dict())


@pytest.mark.parametrize("kwargs", [dict(layout="mono"), dict(accel="grid"),
                                    dict(accel="kdtree"), dict(wide=True)],
                         ids=["mono-bvh", "tlas-grid", "tlas-kdtree", "wide"])
def test_shared_instancing_needs_tlas_and_bvh(kwargs):
    """The JAX package's ValueError for shared instancing outside the TLAS
    layout's BVH (scene/build.py:160-164 there), and for wide tables,
    which it has no shared form of."""
    with pytest.raises(ValueError, match="instancing='shared' requires"):
        compile_scene(CUBE_XML, instancing="shared", device="cpu", **kwargs)
    if "wide" not in kwargs:
        import cpu_ray_tracer_tpu.scene.build as jax_build

        with pytest.raises(ValueError, match="instancing='shared' requires"):
            jax_build.compile_scene(CUBE_XML, instancing="shared", **kwargs)


def test_entry_points_default_to_the_card():
    """compile_scene and the ray helpers make their tensors on the card
    unless the caller asks for the CPU; without a card the default raises
    rather than fall back."""
    cam = cam_mod.make_camera(8, 4)
    defaults = (
        lambda: compile_scene(CUBE_XML)[0].nodes,
        lambda: pathtracer.camera_rays(cam, 1)[0],
        lambda: cam_mod.full_frame_rays(cam)[1],
        lambda: cam_mod.pixel_grid(cam)[0],
    )
    for make in defaults:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    scene, _ = compile_scene(CUBE_XML, device="cpu")
    assert scene.device.type == "cpu" and scene.kernel_params.device.type == "cpu"
    assert pathtracer.camera_rays(cam, 1, "cpu")[0].device.type == "cpu"
    assert cam_mod.full_frame_rays(cam, device="cpu")[0].device.type == "cpu"
