"""`render_pass` of the PyTorch port (plain versions, CPU) against the JAX
package's `render_pass` on its host-bounce path (`CRT_WAVEFRONT=0`):
`rays_traced` exact, image at the tolerance of the JAX package's own
wavefront-vs-host parity test (tests/test_wavefront.py:62).  A pixel beyond
the tolerance passes only if the nudge probe shows its path to be
fp-borderline (`render/borderline.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env, jax_scene_arrays,
)

CASES = {
    # (xml, width, height, camera, pass salt)
    "cube_scene": (CUBE_XML, 48, 32, {}, 1),
    "bunny_teapot": (BENCH_XML, 64, 40, BENCH_CAMERA, 1),
}


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    """The JAX image and ray count, and the JAX scene's arrays."""
    xml, w, h, cam, salt = CASES[request.param]
    jax_scene, _ = jax_compile(xml)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        img, stats = jax_pt.render_pass(jax_scene, jax_cam.make_camera(w, h, **cam), jnp.uint32(salt))
        img, rays = np.asarray(img), int(stats["rays_traced"])
    return request.param, img, rays, jax_scene_arrays(jax_scene)


def _check(name, scene, ref_img, ref_rays):
    xml, w, h, cam, salt = CASES[name]
    camera = cam_mod.make_camera(w, h, **cam)
    img, stats = pathtracer.render_pass(scene, camera, salt)
    assert stats["rays_traced"] == ref_rays
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(scene, o, d, s)[0],
        pathtracer.camera_rays(camera, salt), img, torch.tensor(ref_img),
    )
    assert cmp["unexplained"].numel() == 0, (
        f"pixels {cmp['unexplained'].tolist()} differ and are not fp-borderline"
    )
    return stats


def test_render_from_own_scene_compile(reference):
    name, img, rays, _ = reference
    scene, _ = compile_scene(CASES[name][0])
    stats = _check(name, scene, img, rays)
    assert int(stats["traversed"].sum()) + int(stats["tested"].sum()) > 0


def test_render_from_carried_jax_scene(reference):
    name, img, rays, (arrays, meta) = reference
    _check(name, scene_from_arrays(arrays, meta), img, rays)


def test_sample_radiance_keeps_inputs_and_order(reference):
    """The state is updated in place on copies, and the radiance comes back
    in the input ray order: rendering the rays reversed gives the image
    reversed."""
    name, _, _, _ = reference
    xml, w, h, cam, salt = CASES[name]
    scene, _ = compile_scene(xml)
    o, d, seeds = pathtracer.camera_rays(cam_mod.make_camera(w, h, **cam), salt)
    kept = (o.clone(), d.clone(), seeds.clone())
    fwd, st = pathtracer.sample_radiance(scene, o, d, seeds)
    for a, b in zip((o, d, seeds), kept):
        assert torch.equal(a, b)
    rev, st_rev = pathtracer.sample_radiance(scene, o.flip(0), d.flip(0), seeds.flip(0))
    assert st_rev["rays_traced"] == st["rays_traced"]
    torch.testing.assert_close(rev.flip(0), fwd, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("depth_limit", [0, 1])
def test_shallow_depth_limits_match_jax(depth_limit):
    """Depth 0 (primary only: sky and light emission) and depth 1 on the
    cube scene, against JAX."""
    xml, w, h, cam, salt = CASES["cube_scene"]
    jax_scene, _ = jax_compile(xml)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        want, st = jax_pt.render_pass(
            jax_scene, jax_cam.make_camera(w, h, **cam), jnp.uint32(salt), depth_limit=depth_limit
        )
    scene = scene_from_arrays(*jax_scene_arrays(jax_scene))
    img, stats = pathtracer.render_pass(scene, cam_mod.make_camera(w, h, **cam), salt, depth_limit)
    assert stats["rays_traced"] == int(st["rays_traced"])
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
