"""Hit ids past the meta word, rendered by both packages.

The meta word in lane 15 of a slot's shading record holds `tri | obj << 20
| mat << 26`, so it takes fewer than 2^20 triangles, object ids below 64
and material ids below 32.  Past that the JAX package packs without it
(`meta_in_shade` False) and decodes the ids through `slot_tri` and the
per-triangle ids (cpu_ray_tracer_tpu/accel/pack.py:266-292,
ops/pallas/packet_bvh.py:898-922), and its renderers take the host route
(`_kernel_scene_eligible`, render/pathtracer.py:483).  The port does the
same with `slot_ids` (accel/pack.py), which the closest-hit kernels read
one row of.

The scene: 70 instances of assets/cube.obj (object ids 2-71), written to a
temporary directory (`scene/synthetic.cubes_xml`).  The path tracer
(`rays_traced` exact) and Whitted at 32x20 are held to the JAX package's renders at the parity tolerance
(atol=2e-5, rtol=1e-4) but for fp-borderline pixels
(`render/borderline.py`).  The 2^20-triangle case takes the same code; its
decode is held on a synthetic slot table.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops.closest_hit import decode
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import synthetic
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_parity import OUR_ASSETS, jax_compile, jax_reference_env, jax_scene_arrays

W, H, DEPTH, SALT = 32, 20, 5, 1
N_CUBES = synthetic.N_CUBES


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    return synthetic.cubes_xml(str(tmp_path_factory.mktemp("wide_ids")), OUR_ASSETS)


@pytest.fixture(scope="module")
def scenes(xml):
    jax_scene, _ = jax_compile(xml)
    port, _ = compile_scene(xml, device="cpu")
    return jax_scene, port


def test_ids_past_the_meta_word_pack_a_slot_table(scenes):
    jax_scene, port = scenes
    assert not jax_scene.packed.meta_in_shade
    assert port.slot_ids is not None and not port.stack_kernels and port.walk == "stack"
    ids = port.slot_ids.numpy()
    assert ids[:, 1].max() == 2 + N_CUBES - 1 and (ids[:, 3] == 0).all()
    # every slot names its triangle, whose object and material are the JAX
    # package's, and lane 15 holds the material as a float, as there
    pool = jax_scene.tris
    np.testing.assert_array_equal(ids[:, 1], np.asarray(pool.obj_id)[ids[:, 0]])
    np.testing.assert_array_equal(ids[:, 2], np.asarray(pool.mat_id)[ids[:, 0]])
    np.testing.assert_array_equal(port.shade.numpy()[:, 15], ids[:, 2].astype(np.float32))
    # the JAX scene carried over (`scene_from_arrays`) decodes the same
    arrays, meta = jax_scene_arrays(jax_scene)
    carried = scene_from_arrays(arrays, meta)
    np.testing.assert_array_equal(carried.slot_ids.numpy(), ids)


def test_path_tracer_matches_jax(scenes):
    jax_scene, port = scenes
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


def test_whitted_matches_jax(scenes):
    jax_scene, port = scenes
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WHITTED_WF", "0")
        ref = np.asarray(jax_whitted.render(jax_scene, jax_cam.make_camera(W, H),
                                            depth_limit=DEPTH)["image"])
    camera = cam_mod.make_camera(W, H)
    out = whitted.render(port, camera, DEPTH)
    assert out["levels"] > 1 and float(out["image"].sum()) > 0  # the mirrors make children
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(port, o, d, DEPTH)[0],
        (*cam_mod.full_frame_rays(camera, device="cpu"), None), out["image"],
        torch.from_numpy(ref.copy()),
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


def test_slot_table_decodes_past_two_to_the_twenty():
    """2^20 + 7 triangles do not fit the meta word's 20 bits: the ids come
    from the slot table, for slots anywhere in it, and a miss stays -1."""
    n = (1 << 20) + 7
    rng = np.random.default_rng(5)
    obj_id = rng.integers(2, 9, size=n).astype(np.int32)
    mat_id = rng.integers(2, 6, size=n).astype(np.int32)
    assert not pack.meta_fits(obj_id, mat_id)
    slot_tri = np.arange(n, dtype=np.int32)[::-1].copy()  # slot 0 names triangle n - 1
    table = pack.slot_id_table(slot_tri, obj_id, mat_id)
    scene = SimpleNamespace(slot_ids=torch.from_numpy(table), shade=None)
    slot = torch.tensor([0, n - 1, -1, 123456, (1 << 20) + 3], dtype=torch.int32)
    got = decode(scene, dict(slot=slot))
    s = slot.numpy()
    tri = np.where(s >= 0, slot_tri[np.maximum(s, 0)], -1)
    np.testing.assert_array_equal(got["tri_idx"].numpy(), tri)
    np.testing.assert_array_equal(got["obj_id"].numpy(), np.where(s >= 0, obj_id[tri], -1))
    np.testing.assert_array_equal(got["mat_id"].numpy(), np.where(s >= 0, mat_id[tri], -1))
    assert tri.max() >= 1 << 20
