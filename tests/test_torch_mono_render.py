"""Renders of the port's `layout="mono"` scenes (one tree over every
triangle, `test_torch_mono.py`) against the JAX package's: the path tracer
on the mono BVH (its default route: the wavefront kernel's plain version
at depth 0, the host bounce after) and grid (`rays_traced` exact, the
image within atol=2e-5, rtol=1e-4 except fp-borderline pixels), and
Whitted on the mono BVH through both level routes against the JAX
package's host route (`CRT_WHITTED_WF=0`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import BENCH_CAMERA, BENCH_XML, jax_compile, jax_reference_env

W, H, DEPTH, SALT = 32, 20, 5, 3


@pytest.mark.parametrize("accel", ["bvh", "grid"])
def test_path_tracer_matches_jax_mono(accel):
    jax_scene, _ = jax_compile(BENCH_XML, layout="mono", accel=accel)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        want, st = jax_pt.render_pass(jax_scene, jax_cam.make_camera(W, H, **BENCH_CAMERA),
                                      jnp.uint32(SALT), depth_limit=DEPTH)
        want, rays = torch.from_numpy(np.array(want)), int(st["rays_traced"])
    port, _ = compile_scene(BENCH_XML, layout="mono", accel=accel, device="cpu")
    camera = cam_mod.make_camera(W, H, **BENCH_CAMERA)
    img, stats = pathtracer.render_pass(port, camera, SALT, DEPTH)
    assert stats["rays_traced"] == rays
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(port, o, d, s, DEPTH)[0],
        pathtracer.camera_rays(camera, SALT, "cpu"), img, want)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


@pytest.fixture(scope="module")
def jax_whitted_mono():
    jax_scene, _ = jax_compile(BENCH_XML, layout="mono")
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WHITTED_WF", "0")
        out = jax_whitted.render(jax_scene, jax_cam.make_camera(W, H, **BENCH_CAMERA),
                                 depth_limit=DEPTH)
        return torch.from_numpy(np.array(out["image"]))


@pytest.mark.parametrize("level_kernel", [True, False])
def test_whitted_matches_jax_host_route_mono(jax_whitted_mono, level_kernel):
    want = jax_whitted_mono
    port, _ = compile_scene(BENCH_XML, layout="mono", device="cpu")
    camera = cam_mod.make_camera(W, H, **BENCH_CAMERA)
    got = whitted.render(port, camera, DEPTH, level_kernel=level_kernel)
    assert got["dropped"] == 0
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    cmp = borderline.unexplained_pixels(
        lambda oo, dd, _: whitted.radiance(port, oo, dd, DEPTH, level_kernel)[0],
        (o, d, None), got["image"], want)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
