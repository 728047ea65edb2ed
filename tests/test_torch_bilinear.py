"""Bilinear textures of the PyTorch port against the JAX package.

* `textures.sample_bilinear` against the JAX package's `sample_bilinear`
  on random uv (edges, the clamp range and beyond included), with its
  gradients in the texels and in uv; `sample_equirect(bilinear=True)` on
  random directions, the poles and the seam included;
* a bilinear scene (`compile_scene(bilinear=True)`, `meta["bilinear"]` of
  a carried JAX scene) is no kernel scene: `stack_kernels` False, the path
  tracer's default takes the host bounce, Whitted's the host level, and
  the kernel routes raise;
* bilinear forward renders of the path tracer (the cube scene, depth 2,
  fixed seed: `rays_traced` exact) and of Whitted (depth 5, the cube scene
  and `bunny_teapot` at 64x40) against the JAX package's, at the parity
  tolerance (atol=2e-5, rtol=1e-4) except fp-borderline pixels
  (`render/borderline.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.core import textures as jax_tex
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import textures
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env, jax_scene_arrays,
)

ATOL, RTOL = 2e-5, 1e-4
DEPTH = 5
PT_DEPTH = 2  # the bilinear tap at the primary hit and at a bounce
RENDERS = {
    # (xml, width, height, camera, pass salt)
    "cube_scene": (CUBE_XML, 32, 20, {}, 3),
    "bunny_teapot": (BENCH_XML, 64, 40, BENCH_CAMERA, 1),
}


@pytest.fixture(scope="module")
def cube():
    """The JAX bilinear cube scene and the port's scene carried from it."""
    return _carried(CUBE_XML)


def _random_uv(rng, n):
    """uv in [-0.25, 1.25] with the edges 0 and 1 and the texel centres of
    a 2-texel row among them."""
    u = rng.uniform(-0.25, 1.25, n).astype(np.float32)
    v = rng.uniform(-0.25, 1.25, n).astype(np.float32)
    u[:8] = [0.0, 1.0, 0.0, 1.0, 0.25, 0.75, 0.5, 1.0 - 1e-7]
    v[:8] = [0.0, 0.0, 1.0, 1.0, 0.25, 0.75, 0.5, 1e-7]
    return u, v


def test_sample_bilinear_matches_jax(cube, rng):
    jax_scene, scene = cube
    atlas = jax_scene.atlas
    n_tex = int(atlas.offset.shape[0])
    n = 4096
    tex_id = rng.integers(0, n_tex, n).astype(np.int32)
    u, v = _random_uv(rng, n)
    weights = rng.standard_normal((n, 3)).astype(np.float32)

    def jax_loss(texels, u, v):
        out = jax_tex.sample_bilinear(atlas.replace(texels=texels), jnp.asarray(tex_id), u, v)
        return jnp.sum(out * weights), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        atlas.texels, jnp.asarray(u), jnp.asarray(v))

    texels = scene.atlas_texels.clone().requires_grad_()
    tu, tv = torch.tensor(u, requires_grad=True), torch.tensor(v, requires_grad=True)
    tid = torch.tensor(tex_id).long()
    got = textures.sample_bilinear(texels, scene.atlas_offset[tid], scene.atlas_width[tid],
                                   scene.atlas_height[tid], tu, tv)
    (got * torch.tensor(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    for name, mine, theirs in (("texels", texels.grad, grads[0]), ("u", tu.grad, grads[1]),
                               ("v", tv.grad, grads[2])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_sample_equirect_bilinear_matches_jax(cube, rng):
    jax_scene, scene = cube
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d[:6] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [1, 0, 0], [-1, 0, 1e-7], [-1, 0, -1e-7]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jax_tex.sample_equirect(jax_scene.atlas, jax_scene.skydome_tex, jnp.asarray(d),
                                   bilinear=True)
    got = textures.sample_equirect(scene, torch.tensor(d), bilinear=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    nearest = textures.sample_equirect(scene, torch.tensor(d))
    assert not torch.equal(nearest, got)  # the two taps differ


def test_bilinear_scene_is_no_kernel_scene(cube):
    _, carried = cube
    own, _ = compile_scene(CUBE_XML, bilinear=True, device="cpu")
    plain, _ = compile_scene(CUBE_XML, device="cpu")
    assert plain.stack_kernels and not plain.bilinear
    for scene in (carried, own):
        assert scene.bilinear and not scene.stack_kernels
        assert pathtracer.wavefront_depths_for(scene, None) == 0
        assert not whitted.level_kernel_for(scene, None)
        with pytest.raises(ValueError):
            pathtracer.wavefront_depths_for(scene, 1)
        with pytest.raises(ValueError):
            whitted.level_kernel_for(scene, True)


def _carried(xml):
    jax_scene, _ = jax_compile(xml, bilinear=True)
    return jax_scene, scene_from_arrays(*jax_scene_arrays(jax_scene))


def test_bilinear_path_tracer_matches_jax():
    """The cube scene (the JAX package's eager path tracer is the slow side
    of this file)."""
    xml, w, h, cam, salt = RENDERS["cube_scene"]
    jax_scene, scene = _carried(xml)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        ref, st = jax_pt.render_pass(jax_scene, jax_cam.make_camera(w, h, **cam),
                                     jnp.uint32(salt), PT_DEPTH)
    camera = cam_mod.make_camera(w, h, **cam)
    img, stats = pathtracer.render_pass(scene, camera, salt, PT_DEPTH)
    assert stats["rays_traced"] == int(st["rays_traced"])
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(scene, o, d, s, PT_DEPTH)[0],
        pathtracer.camera_rays(camera, salt, "cpu"), img, torch.tensor(np.asarray(ref)),
        ATOL, RTOL)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


@pytest.mark.parametrize("name", list(RENDERS))
def test_bilinear_whitted_matches_jax(name):
    xml, w, h, cam, _ = RENDERS[name]
    jax_scene, scene = _carried(xml)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        ref = jax_whitted.render(jax_scene, jax_cam.make_camera(w, h, **cam), DEPTH)["image"]
    camera = cam_mod.make_camera(w, h, **cam)
    out = whitted.render(scene, camera, DEPTH)
    assert out["dropped"] == 0 and float(out["image"].sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(scene, o, d, DEPTH)[0],
        (*cam_mod.full_frame_rays(camera, device="cpu"), None), out["image"],
        torch.tensor(np.asarray(ref)), ATOL, RTOL)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
