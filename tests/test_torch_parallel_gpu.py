"""The native builder's trees and the ray mesh on the card: an SBVH scene's
path-tracer pass and Whitted frame on the card against the CPU at 64x40,
and in a world of one over NCCL the sharded pass bit-equal to
`render_pass` (launching K3 and K1) and the sharded train step equal to
the single-device step.  They need an NVIDIA GPU and skip without one;
they import neither JAX nor the repo's conftest:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_parallel_gpu.py -q
"""

import copy
import os

import pytest
import torch

from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.diff.optimize import make_sharded_train_step, make_train_step
from cpu_ray_tracer_tpu_torch.ops import closest_hit, wavefront_pt
from cpu_ray_tracer_tpu_torch.parallel import mesh as mesh_mod
from cpu_ray_tracer_tpu_torch.parallel import sharded
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
XML = os.path.join(ASSETS, "scenes", "bunny_teapot.xml")
CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
W, H = 64, 40

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_sbvh_scene_on_the_card_matches_the_cpu(cuda):
    cpu, _ = compile_scene(XML, sbvh=True, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    camera = cam_mod.make_camera(W, H, **CAMERA)
    img, st = pathtracer.render_pass(card, camera, 1)
    want, want_st = pathtracer.render_pass(cpu, camera, 1)
    assert st["rays_traced"] == want_st["rays_traced"]
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(cpu, o, d, s)[0],
        pathtracer.camera_rays(camera, 1, "cpu"), img.cpu(), want)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
    frame, want_frame = whitted.render(card, camera), whitted.render(cpu, camera)
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(cpu, o, d)[0],
        (*cam_mod.full_frame_rays(camera, device="cpu"), None), frame["image"].cpu(),
        want_frame["image"])
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


def test_world_of_one_is_the_unsharded_pass_and_step(cuda):
    scene, _ = compile_scene(XML, bilinear=True, device=cuda)
    camera = cam_mod.make_camera(W, H, **CAMERA)
    mesh = mesh_mod.make_mesh(1)
    try:
        assert (mesh.world, mesh.backend) == (1, "nccl")
        plain, _ = compile_scene(XML, device=cuda)
        run = sharded.sharded_render_pass(mesh_mod.replicate_scene(plain, mesh), camera, mesh)
        for k in (closest_hit.closest_hit, wavefront_pt.trace):
            k.launches = 0
        img, st = run(3)
        assert closest_hit.closest_hit.launches > 0 and wavefront_pt.trace.launches > 0
        want, want_st = pathtracer.render_pass(plain, camera, 3)
        assert torch.equal(img, want) and st["rays_traced"] == want_st["rays_traced"]
        assert torch.equal(st["traversed"], want_st["traversed"])
        target = pathtracer.render_pass(scene, camera, 1, 3)[0]
        params = grad_mod.extract_params(scene, ("albedo", "light_color", "texels"))
        params["albedo"] = params["albedo"] * 0.8
        single = make_train_step(scene, camera, target, params, 0.05, 3, device=cuda)
        split = make_sharded_train_step(scene, camera, target, params, 0.05, mesh, 3)
        for _ in range(3):
            assert float(split(1)) == pytest.approx(float(single(1)), rel=1e-5)
        for k in params:
            torch.testing.assert_close(split.params[k], single.params[k], atol=1e-6, rtol=1e-5)
    finally:
        mesh.close()
