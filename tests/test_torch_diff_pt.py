"""Gradients of the PyTorch port's differentiable path tracer
(`render_pass(differentiable=True)`, depth 2, a fixed `spp_index`)
against `jax.grad` of the JAX package's, for every key of
`diff/grad.PARAM_KEYS`: the cube scene at 16x10 in nearest and bilinear
mode here, `bunny_teapot` at 64x40 in `test_torch_diff_pt_bunny.py` (the
JAX package's eager path tracer takes about a minute a case, so the two
files run on two workers).  The JAX package runs as in
`test_torch_diff.py` (its eager host bounce with custom VJPs and
rematerialized bounces, its kernels in interpret mode), the port on the
CPU with autograd; the same tolerances, and the same rule for pixels
beyond the image parity tolerance (fp-borderline, left out of both
losses)."""

import jax.numpy as jnp
import pytest

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import pathtracer
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_grads import DEPTH, KEYS, assert_grad_close, masked_grads
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env, jax_scene_arrays,
)

SALT = 7
CASES = {
    # (xml, bilinear, width, height, camera)
    "cube_scene-nearest": (CUBE_XML, False, 16, 10, {}),
    "cube_scene-bilinear": (CUBE_XML, True, 16, 10, {}),
    "bunny_teapot-nearest": (BENCH_XML, False, 64, 40, BENCH_CAMERA),
}


def case_grads(case):
    """(case, (port grads, JAX grads, pixels left out)) of a case."""
    xml, bilinear, w, h, cam = CASES[case]
    jax_scene, _ = jax_compile(xml, bilinear=bilinear)
    scene = scene_from_arrays(*jax_scene_arrays(jax_scene))
    camera = cam_mod.make_camera(w, h, **cam)

    def render(sc, o=None, d=None, s=None):
        if o is None:
            return pathtracer.render_pass(sc, camera, SALT, DEPTH, differentiable=True)[0]
        return pathtracer.sample_radiance(sc, o, d, s, DEPTH, differentiable=True)[0]

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        out = masked_grads(
            lambda s: jax_pt.render_pass(s, jax_cam.make_camera(w, h, **cam), jnp.uint32(SALT),
                                         depth_limit=DEPTH, differentiable=True)[0],
            render, jax_scene, scene, pathtracer.camera_rays(camera, SALT, "cpu"))
    return case, out


@pytest.fixture(scope="module", params=["cube_scene-nearest", "cube_scene-bilinear"])
def pt_grads(request):
    return case_grads(request.param)


def check_case(pt_grads, key):
    case, (g, g_j, left_out) = pt_grads
    assert left_out.numel() <= 8
    assert_grad_close(g[key].numpy(), g_j[key], f"{case} {key}")
    if key in ("albedo", "light_color"):
        assert float(g[key].abs().sum()) > 0
    if key == "texels":
        assert (float(g[key].abs().sum()) > 0) == case.endswith("bilinear")
    if key == "v0" and case.startswith("bunny"):
        assert float(g[key].abs().sum()) > 0  # interpolated normals move with the vertices


@pytest.mark.parametrize("key", KEYS)
def test_path_tracer_grads_match_jax(pt_grads, key):
    check_case(pt_grads, key)
