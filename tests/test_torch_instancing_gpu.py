"""Shared instancing, animation and the primitive scene on the card against
the CPU: the instanced queries (the closest-hit and any-hit kernels once
per instance), a path-tracer pass and a Whitted frame of the shared
`bunny_teapot`, a mesh deeper than the stack walk (the link walk per
instance), `AnimatedScene.update` against a full rebuild, the primitive
scene's frames (no kernel), `noise2d`, and the CLI's `--instancing
shared`.  Ids exact; t and images at the parity tolerance (atol=2e-5,
rtol=1e-4) except pixels the nudge probe shows fp-borderline on the CPU
(the card's Whitted film sums children with an atomic `index_add_`).

These need an NVIDIA GPU and skip without one.  They import neither JAX
nor the repo's conftest:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_instancing_gpu.py -q
"""

import copy
import os

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.cli import main
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import noise
from cpu_ray_tracer_tpu_torch.io.image import decode_png
from cpu_ray_tracer_tpu_torch.io.scene_xml import load_scene_xml
from cpu_ray_tracer_tpu_torch.ops import closest_hit, link_walk, wavefront_pt, whitted_wf
from cpu_ray_tracer_tpu_torch.render import basics, borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import query, synthetic
from cpu_ray_tracer_tpu_torch.scene.animate import AnimatedScene
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.primitive_scene import compile_primitive_scene

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
XML = os.path.join(ASSETS, "scenes", "bunny_teapot.xml")
CUBE = os.path.join(ASSETS, "scenes", "cube_scene.xml")
CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
W, H, DEPTH = 64, 40, 5
KERNELS = dict(closest_hit=closest_hit.closest_hit, occluded=closest_hit.occluded,
               wavefront_pt=wavefront_pt.trace, whitted_wf=whitted_wf.trace_level0,
               closest_hit_links=link_walk.closest_hit_links,
               occluded_links=link_walk.occluded_links)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def shared(cuda):
    cpu, info = compile_scene(XML, instancing="shared", device="cpu")
    assert len(cpu.shared.inst_mesh) == 3 and len(cpu.shared.meshes) == 2
    return cpu, copy.deepcopy(cpu).to(cuda)


def _counted(fn):
    for k in KERNELS.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in KERNELS.items()}


def _check_image(img, ref, radiance, rays, label):
    cmp = borderline.unexplained_pixels(radiance, rays, img.cpu(), ref)
    assert cmp["unexplained"].numel() == 0, (label, cmp["unexplained"].tolist())
    assert cmp["bad"].numel() < 0.05 * ref.shape[0] * ref.shape[1], label


def test_instanced_queries_card_vs_cpu(shared, cuda):
    cpu, gpu = shared
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(W, H, **CAMERA), device="cpu")
    want = query.find_nearest(cpu, o, d)
    got, counts = _counted(lambda: query.find_nearest(gpu, o.to(cuda), d.to(cuda)))
    assert counts["closest_hit"] == 3 and sum(counts.values()) == 3  # once per instance
    for key in ("obj_idx", "tri_idx", "slot", "mat_id_tri"):
        assert torch.equal(got[key].cpu(), want[key]), key
    torch.testing.assert_close(got["t"].cpu(), want["t"], atol=2e-5, rtol=1e-4)
    dist = torch.full((o.shape[0],), 10.0)
    occ, counts = _counted(lambda: query.is_occluded(gpu, o.to(cuda), d.to(cuda), dist.to(cuda)))
    assert counts["occluded"] == 3
    assert torch.equal(occ.cpu(), query.is_occluded(cpu, o, d, dist))
    normal, _, mat = query.get_hit_info(gpu, got, o.to(cuda) + got["t"][:, None] * d.to(cuda),
                                        d.to(cuda))
    want_n, _, want_mat = query.get_hit_info(cpu, want, o + want["t"][:, None] * d, d)
    assert torch.equal(mat.cpu(), want_mat)
    torch.testing.assert_close(normal.cpu(), want_n, atol=2e-5, rtol=1e-4)


def test_shared_renders_card_vs_cpu(shared, cuda):
    cpu, gpu = shared
    camera = cam_mod.make_camera(W, H, **CAMERA)
    (img, st), counts = _counted(lambda: pathtracer.render_pass(gpu, camera, 1, DEPTH))
    ref, ref_st = pathtracer.render_pass(cpu, camera, 1, DEPTH)
    assert st["rays_traced"] == ref_st["rays_traced"]
    assert counts["wavefront_pt"] == 0 and counts["closest_hit"] % 3 == 0 and counts["closest_hit"]
    _check_image(img, ref, lambda o, d, s: pathtracer.sample_radiance(cpu, o, d, s, DEPTH)[0],
                 pathtracer.camera_rays(camera, 1, "cpu"), "path tracer")
    out, counts = _counted(lambda: whitted.render(gpu, camera, DEPTH))
    assert counts["whitted_wf"] == 0 and counts["occluded"] == 3 * out["levels"]
    ref = whitted.render(cpu, camera, DEPTH)["image"]
    _check_image(out["image"], ref, lambda o, d, _: whitted.radiance(cpu, o, d, DEPTH)[0],
                 (*cam_mod.full_frame_rays(camera, device="cpu"), None), "whitted")


def test_deep_mesh_takes_the_link_walk_on_the_card(cuda):
    spec = load_scene_xml(CUBE)
    spec.objects.append(copy.deepcopy(spec.objects[0]))
    spec.objects[1].position = spec.objects[1].position + np.float32([0.7, 0.3, 0.5])
    cpu = synthetic.shared_scene_over(compile_scene(CUBE, device="cpu")[0],
                                      synthetic.caterpillar(140), spec)
    gpu = copy.deepcopy(cpu).to(cuda)
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(W, H), device="cpu")
    t0 = torch.full((o.shape[0],), 1e34)
    got, counts = _counted(lambda: query.triangle_hit(gpu, o.to(cuda), d.to(cuda), t0.to(cuda)))
    assert counts["closest_hit_links"] == 2 and counts["closest_hit"] == 0
    want = query.triangle_hit(cpu, o, d, t0)
    for key in ("slot", "tri_idx", "obj_id", "traversed", "tested"):
        assert torch.equal(got[key].cpu(), want[key]), key
    torch.testing.assert_close(got["t"].cpu(), want["t"], atol=2e-5, rtol=1e-4)
    assert int((want["slot"] >= 0).sum()) > 20


def test_update_matches_rebuild_on_the_card(cuda):
    anim = AnimatedScene(XML, instancing="shared", device="cuda")
    scene, _ = anim.build()
    anim.set_transform(1, position=(0.4, -0.2, 2.2), rotation_deg=(0, 60, 0))
    fast = anim.update(scene)
    full, _ = anim.build()
    assert fast.shared.meshes is scene.shared.meshes
    camera = cam_mod.make_camera(W, H, **CAMERA)
    o, d = cam_mod.full_frame_rays(camera, device=cuda)
    a, b = query.find_nearest(fast, o, d), query.find_nearest(full, o, d)
    for key in ("t", "obj_idx", "tri_idx", "slot"):
        assert torch.equal(a[key], b[key]), key
    img_fast = whitted.render(fast, camera, DEPTH)["image"].cpu()
    img_full = whitted.render(full, camera, DEPTH)["image"].cpu()
    torch.testing.assert_close(img_fast, img_full, atol=2e-5, rtol=1e-4)
    assert float((img_fast - whitted.render(scene, camera, DEPTH)["image"].cpu()).abs().max()) > 0.01


@pytest.mark.parametrize("anim_time", [0.0, 1.0])
def test_primitive_scene_card_vs_cpu(cuda, anim_time):
    cpu = compile_primitive_scene(anim_time, device="cpu")
    gpu = compile_primitive_scene(anim_time, device="cuda")
    camera = cam_mod.make_camera(W, H)
    (img, st), counts = _counted(lambda: pathtracer.render_pass(gpu, camera, 1, DEPTH))
    ref, ref_st = pathtracer.render_pass(cpu, camera, 1, DEPTH)
    assert sum(counts.values()) == 0  # closed forms: no kernel
    assert st["rays_traced"] == ref_st["rays_traced"]
    _check_image(img, ref, lambda o, d, s: pathtracer.sample_radiance(cpu, o, d, s, DEPTH)[0],
                 pathtracer.camera_rays(camera, 1, "cpu"), "path tracer")
    out, counts = _counted(lambda: whitted.render(gpu, camera, DEPTH))
    assert sum(counts.values()) == 0
    _check_image(out["image"], whitted.render(cpu, camera, DEPTH)["image"],
                 lambda o, d, _: whitted.radiance(cpu, o, d, DEPTH)[0],
                 (*cam_mod.full_frame_rays(camera, device="cpu"), None), "whitted")
    for aov in ("albedo", "normal"):
        _check_image(basics.render(gpu, camera, aov), basics.render(cpu, camera, aov),
                     lambda o, d, _, a=aov: basics.aov_of_rays(cpu, o, d, a),
                     (*cam_mod.full_frame_rays(camera, device="cpu"), None), aov)


def test_noise2d_card_equals_cpu(cuda):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(-300, 300, size=100000).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-300, 300, size=100000).astype(np.float32))
    got = noise.noise2d(x.to(cuda), y.to(cuda)).cpu()
    want = noise.noise2d(x, y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cli_shared_instancing_on_the_card(cuda, tmp_path):
    out = str(tmp_path / "s.png")
    argv = ["--scene-xml", XML, "--integrator", "whitted", "--instancing", "shared",
            "--width", str(W), "--height", str(H), "--cam-pos", "0,0.3,-1.2",
            "--cam-target", "0,-0.1,2.5", "--out", out]
    rc, counts = _counted(lambda: main(argv + ["--device", "cuda"]))
    assert rc == 0 and counts["closest_hit"] > 0 and counts["whitted_wf"] == 0
    ref = str(tmp_path / "c.png")
    assert main(argv[:-1] + [ref, "--device", "cpu"]) == 0
    a, b = decode_png(out).astype(np.int32), decode_png(ref).astype(np.int32)
    assert a.shape == (H, W, 3)
    bad = np.nonzero((np.abs(a - b) > 1).any(axis=-1).reshape(-1))[0]
    if bad.size:
        cpu, _ = compile_scene(XML, instancing="shared", device="cpu")
        o, d = cam_mod.full_frame_rays(cam_mod.make_camera(W, H, **CAMERA), device="cpu")
        idx = torch.from_numpy(bad)
        moved = borderline.nudge_sensitive(lambda oo, dd, _: whitted.radiance(cpu, oo, dd)[0],
                                           o[idx], d[idx], None)
        assert bool(moved.all()), bad[~moved.numpy()].tolist()
