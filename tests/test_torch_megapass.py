"""`render_pass(samples_per_pass=s)` of the port (the JAX package's
megapass, render/pathtracer.py:1413-1476: s jittered samples a pixel in
one pass, pixel-major, sample k salted spp_index + k).

* It equals the sum of s one-sample passes at spp_index .. spp_index +
  s - 1, `rays_traced` exactly, the radiance within float32 summation
  order, on each route: the wavefront kernel's plain version at k = 1 (the
  expanded lane order) and k = 6, the host bounce, and a grid.
* It matches the JAX package's `render_pass(samples_per_pass=2)`:
  `rays_traced` exact, pixels within atol=2e-5, rtol=1e-4 unless one of
  the pixel's sample paths is fp-borderline.
* With `differentiable=True` the megapass's loss and gradients equal
  those of the sum of single passes.
* The lane order for s samples is a permutation of the s*W*H rays that
  keeps a pixel's samples on adjacent lanes; the per-ray salts keep the
  uint32 arithmetic of `core/rng.pixel_seeds`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.core import rng as jax_rng
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import rng
from cpu_ray_tracer_tpu_torch.diff import grad
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env

W, H, DEPTH = 24, 16, 5


@pytest.fixture(scope="module")
def scenes():
    return {"bvh": compile_scene(BENCH_XML, device="cpu")[0],
            "grid": compile_scene(BENCH_XML, accel="grid", device="cpu")[0]}


ROUTES = {  # (scene, wavefront_depths)
    "k=1": ("bvh", None), "k=6": ("bvh", 6), "host": ("bvh", 0), "grid": ("grid", None),
}


@pytest.mark.parametrize("route, s", [("k=1", 2), ("k=1", 4), ("k=6", 4), ("host", 2),
                                      ("grid", 2)])
def test_megapass_is_the_sum_of_single_passes(scenes, route, s):
    key, kd = ROUTES[route]
    scene, base = scenes[key], 7
    camera = cam_mod.make_camera(W, H, **BENCH_CAMERA)
    img, stats = pathtracer.render_pass(scene, camera, base, DEPTH, kd, samples_per_pass=s)
    singles = [pathtracer.render_pass(scene, camera, base + k, DEPTH, kd) for k in range(s)]
    assert stats["rays_traced"] == sum(st["rays_traced"] for _, st in singles)
    assert stats["traversed"].shape == (s * W * H,)
    want = sum(im for im, _ in singles)
    assert img.shape == (H, W, 3) and float(want.sum()) > 0
    torch.testing.assert_close(img, want, atol=1e-5, rtol=1e-6)


def test_one_sample_megapass_is_the_pass():
    scene = compile_scene(CUBE_XML, device="cpu")[0]
    camera = cam_mod.make_camera(W, H)
    a, sa = pathtracer.render_pass(scene, camera, 3)
    b, sb = pathtracer.render_pass(scene, camera, 3, samples_per_pass=1)
    assert torch.equal(a, b) and sa["rays_traced"] == sb["rays_traced"]
    with pytest.raises(ValueError, match="samples_per_pass"):
        pathtracer.render_pass(scene, camera, 3, samples_per_pass=0)


def test_megapass_matches_jax():
    s = 2
    jax_scene, _ = jax_compile(BENCH_XML)
    base = 5
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        want, st = jax_pt.render_pass(jax_scene, jax_cam.make_camera(W, H, **BENCH_CAMERA),
                                      jnp.uint32(base), depth_limit=DEPTH, samples_per_pass=s)
        want, rays = torch.from_numpy(np.array(want)), int(st["rays_traced"])
    scene = compile_scene(BENCH_XML, device="cpu")[0]
    camera = cam_mod.make_camera(W, H, **BENCH_CAMERA)
    img, stats = pathtracer.render_pass(scene, camera, base, DEPTH, samples_per_pass=s)
    assert stats["rays_traced"] == rays
    bad = torch.nonzero(~torch.isclose(img, want, atol=2e-5, rtol=1e-4).all(-1).reshape(-1))
    # a pixel beyond tolerance must have a sample path the nudge probe
    # shows borderline
    o, d, seeds = pathtracer.camera_rays(camera, base, "cpu", s)
    for p in bad.reshape(-1).tolist():
        rays_p = slice(p * s, (p + 1) * s)
        moved = borderline.nudge_sensitive(
            lambda oo, dd, ss: pathtracer.sample_radiance(scene, oo, dd, ss, DEPTH)[0],
            o[rays_p], d[rays_p], seeds[rays_p])
        assert bool(moved.any()), f"pixel {p} differs and no sample path is fp-borderline"


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_lane_order_for_samples(s):
    cam = cam_mod.make_camera(21, 11)
    perm = cam_mod.lane_order(cam, "cpu", s).numpy()
    assert perm.dtype == np.int32 and sorted(perm.tolist()) == list(range(s * 21 * 11))
    lanes = perm.reshape(-1, s)
    np.testing.assert_array_equal(lanes // s, np.repeat(lanes[:, :1] // s, s, axis=1))
    np.testing.assert_array_equal(lanes % s, np.tile(np.arange(s), (lanes.shape[0], 1)))
    np.testing.assert_array_equal(lanes[:, 0] // s, cam_mod.lane_order(cam, "cpu").numpy())


def test_pixel_seeds_take_per_ray_sample_indices():
    """A tensor of sample indices salts each ray as the int would, in
    uint32 arithmetic, as the JAX package's `pixel_seeds`."""
    pix = np.arange(0, 50000, 7, dtype=np.uint32)
    spp = (np.arange(pix.size, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(np.uint32)
    spp[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jax_rng.pixel_seeds(jnp.asarray(pix), jnp.asarray(spp)))
    got = rng.pixel_seeds(torch.from_numpy(pix.astype(np.int64)),
                          torch.from_numpy(spp.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    one = rng.pixel_seeds(torch.from_numpy(pix.astype(np.int64)), 12345)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jax_rng.pixel_seeds(jnp.asarray(pix), 12345)).astype(np.int64))


def test_megapass_composes_with_differentiable():
    """`differentiable=True` with `samples_per_pass=2`: the radiance equals
    the sum of two differentiable single passes, and so do the gradients
    of a loss over it."""
    scene = compile_scene(CUBE_XML, device="cpu")[0]
    camera = cam_mod.make_camera(16, 10)
    params = grad.extract_params(scene, ("albedo", "light_color"))
    target = torch.zeros(10, 16, 3)

    def mega(sc):
        return pathtracer.render_pass(sc, camera, 3, 2, differentiable=True, samples_per_pass=2)[0]

    def pair(sc):
        return sum(pathtracer.render_pass(sc, camera, 3 + k, 2, differentiable=True)[0]
                   for k in range(2))

    v_mega, g_mega = grad.value_and_grad(grad.make_loss_fn(scene, mega, target), params)
    v_pair, g_pair = grad.value_and_grad(grad.make_loss_fn(scene, pair, target), params)
    assert float(v_mega) == pytest.approx(float(v_pair), rel=1e-5)
    for key in params:
        assert float(g_mega[key].abs().sum()) > 0
        torch.testing.assert_close(g_mega[key], g_pair[key], atol=1e-6, rtol=1e-4)
