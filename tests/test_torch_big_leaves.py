"""A leaf of 600 triangles, past what the walk records held, in both packages.

The walk records once named a leaf by `count << 22 | first`: fewer than
512 triangles and a first slot below 2^22.  The JAX package keeps a leaf's
first row and row count in full int32 words (`node_meta2`), and so does
the port now: a leaf ref is `~first`, and the count rides in word 3 of the
first slot's `tris4` record (accel/pack.py).

The scene: 600 coincident triangles (one OBJ, written to a temporary
directory) above the floor, a mirror (`scene/synthetic.big_leaf_xml`).
The grid puts all 600 in each cell they cross, the KD tree in each leaf;
both packages compile those (`compile_scene`).  Their BVH builders split
any leaf above 24 triangles at the median (`FORCE_SPLIT_CAP`), so the BVH
is built by hand (`synthetic.big_leaf_bvh`): a root over a leaf of the 600
and a leaf of one other triangle, packed by both packages from the same
arrays (`tests/torch_parity.jax_scene_over`).  For
"bvh", "grid" and "kdtree" the path tracer (`rays_traced` exact) and
Whitted at 32x20 are held to the JAX package's renders at the parity
tolerance (atol=2e-5, rtol=1e-4) but for fp-borderline pixels
(`render/borderline.py`).  The coincident triangles tie at every hit: both
packages keep the first-tested, the first slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene import synthetic
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_parity import (
    OUR_ASSETS, jax_compile, jax_reference_env, jax_scene_arrays, jax_scene_over,
)

W, H, DEPTH, SALT = 32, 20, 5, 1
N_TRIS = synthetic.BIG_LEAF
ACCELS = ("bvh", "grid", "kdtree")


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    return synthetic.big_leaf_xml(str(tmp_path_factory.mktemp("big_leaf")), OUR_ASSETS)


@pytest.fixture(scope="module", params=ACCELS)
def scenes(request, xml):
    if request.param == "bvh":
        host = synthetic.big_leaf_bvh()
        shade = synthetic.flat_shading(host["tri_v"])
        ids = np.full(N_TRIS + 1, 2, np.int32)
        jax_scene = jax_scene_over(host, shade, ids, ids, xml)
        port = scene_from_arrays(*jax_scene_arrays(jax_scene))
        own = pack.pack_bvh(
            host["node_min"], host["node_max"], host["left"], host["right"], host["axis"],
            host["left_first"], host["tri_count"], host["tri_indices"], host["tri_v"], shade,
            ids, ids, root=0)
        for name in ("nodes", "node_records", "tris4"):
            np.testing.assert_array_equal(getattr(own, name), getattr(port, name).numpy())
        return request.param, jax_scene, port
    kw = dict(accel=request.param)
    jax_scene, _ = jax_compile(xml, **kw)
    port, _ = compile_scene(xml, device="cpu", **kw)
    return request.param, jax_scene, port


def test_the_big_leaf_packs(scenes):
    accel, _, port = scenes
    nodes = port.nodes.numpy()
    count = nodes[:, pack.N_COUNT]
    assert count.max() == N_TRIS  # past the old 9-bit count
    first = nodes[count == N_TRIS, pack.N_FIRST]
    left = port.tris4.numpy().view(np.int32)[:, 3]
    np.testing.assert_array_equal(left[first], N_TRIS)
    assert not port.leaf_codes  # the leaf refs name the first slot alone
    if accel == "bvh":
        assert port.record_root == 0 and port.stack_walk and port.stack_kernels
        assert ~port.node_records.numpy()[0, 12] == 0  # leaf 1: ~first slot
    else:
        rec = port.link_records.numpy()[0]
        big = np.nonzero(count == N_TRIS)[0]
        np.testing.assert_array_equal(~rec[big, 6], nodes[big, pack.N_FIRST])


def test_path_tracer_matches_jax(scenes):
    _, jax_scene, port = scenes
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        ref, st = jax_pt.render_pass(jax_scene, jax_cam.make_camera(W, H), jnp.uint32(SALT),
                                     depth_limit=DEPTH)
    camera = cam_mod.make_camera(W, H)
    img, stats = pathtracer.render_pass(port, camera, SALT, DEPTH)
    assert stats["rays_traced"] == int(st["rays_traced"])
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(port, o, d, s, DEPTH)[0],
        pathtracer.camera_rays(camera, SALT, "cpu"), img, torch.from_numpy(np.asarray(ref).copy()),
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
    assert int(stats["tested"].max()) >= N_TRIS


def test_whitted_matches_jax(scenes):
    _, jax_scene, port = scenes
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WHITTED_WF", "0")
        ref = np.asarray(jax_whitted.render(jax_scene, jax_cam.make_camera(W, H),
                                            depth_limit=DEPTH)["image"])
    camera = cam_mod.make_camera(W, H)
    out = whitted.render(port, camera, DEPTH)
    assert out["levels"] > 1 and float(out["image"].sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(port, o, d, DEPTH)[0],
        (*cam_mod.full_frame_rays(camera, device="cpu"), None), out["image"],
        torch.from_numpy(ref.copy()),
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
