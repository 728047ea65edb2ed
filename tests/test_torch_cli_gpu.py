"""The port's user surface on the card against the CPU: the CLI at 64x40
(path tracer with a checkpoint, Whitted, basics) on the TLAS and mono
layouts and a mono grid, and the megapass.  Each drive on the card must
launch the kernels of its route; PNGs agree within one 8-bit level except
pixels whose path the nudge probe shows fp-borderline on the CPU.

These need an NVIDIA GPU and skip without one.  They import neither JAX
nor the repo's conftest:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cli_gpu.py -q
"""

import copy
import os

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.cli import main
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.io.image import decode_png
from cpu_ray_tracer_tpu_torch.ops import closest_hit, link_walk, wavefront_pt, whitted_wf
from cpu_ray_tracer_tpu_torch.render import basics, borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.utils import checkpoint

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
XML = os.path.join(ASSETS, "scenes", "bunny_teapot.xml")
CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
W, H, SPP = 64, 40, 2
KERNELS = dict(closest_hit=closest_hit.closest_hit, occluded=closest_hit.occluded,
               wavefront_pt=wavefront_pt.trace, whitted_wf=whitted_wf.trace_level0,
               closest_hit_links=link_walk.closest_hit_links,
               occluded_links=link_walk.occluded_links)
# the kernels each route must launch: (layout, accel) -> integrator -> names
EXPECTED = {
    ("tlas", "bvh"): dict(pathtracer=["wavefront_pt", "closest_hit"], whitted=["whitted_wf"],
                          basics=["closest_hit"]),
    ("mono", "bvh"): dict(pathtracer=["wavefront_pt", "closest_hit"], whitted=["whitted_wf"],
                          basics=["closest_hit"]),
    ("mono", "grid"): dict(pathtracer=["closest_hit_links"],
                           whitted=["closest_hit_links", "occluded_links"],
                           basics=["closest_hit_links"]),
}

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cpu_radiance(integrator, scene, camera):
    """(radiance(o, d, seeds), the frame's rays for each pass) on the CPU."""
    if integrator == "pathtracer":
        return (lambda o, d, s: pathtracer.sample_radiance(scene, o, d, s)[0],
                [pathtracer.camera_rays(camera, p, "cpu") for p in range(SPP)])
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    if integrator == "whitted":
        return (lambda oo, dd, _: whitted.radiance(scene, oo, dd)[0]), [(o, d, None)]
    return (lambda oo, dd, _: basics.aov_of_rays(scene, oo, dd, "albedo")), [(o, d, None)]


@pytest.mark.parametrize("integrator", ["pathtracer", "whitted", "basics"])
@pytest.mark.parametrize("layout, accel", list(EXPECTED), ids=lambda x: str(x))
def test_cli_on_the_card_matches_the_cpu(cuda, tmp_path, layout, accel, integrator):
    argv = ["--scene-xml", XML, "--integrator", integrator, "--layout", layout, "--accel", accel,
            "--width", str(W), "--height", str(H), "--spp", str(SPP),
            "--cam-pos", "0,0.3,-1.2", "--cam-target", "0,-0.1,2.5"]
    pngs = {}
    for dev in ("cuda", "cpu"):
        extra = ["--checkpoint", str(tmp_path / f"{dev}.npz"), "--checkpoint-every", "1"]
        for k in KERNELS.values():
            k.launches = 0
        assert main(argv + extra + ["--device", dev, "--out", str(tmp_path / f"{dev}.png")]) == 0
        counts = {name: k.launches for name, k in KERNELS.items()}
        if dev == "cuda":
            for name in EXPECTED[(layout, accel)][integrator]:
                assert counts[name] > 0, (name, counts)
        else:
            assert not any(counts.values()), counts  # the CPU runs the plain versions
        pngs[dev] = decode_png(str(tmp_path / f"{dev}.png")).astype(np.int32)
    if integrator == "pathtracer":
        assert checkpoint.load_film(str(tmp_path / "cuda.npz"), device="cpu")[0].spp == SPP
    bad = np.nonzero((np.abs(pngs["cuda"] - pngs["cpu"]) > 1).any(-1).reshape(-1))[0]
    if bad.size:
        scene, _ = compile_scene(XML, layout=layout, accel=accel, device="cpu")
        radiance, passes = _cpu_radiance(integrator, scene, cam_mod.make_camera(W, H, **CAMERA))
        idx = torch.from_numpy(bad)
        moved = torch.zeros(bad.size, dtype=torch.bool)
        for o, d, s in passes:
            moved |= borderline.nudge_sensitive(radiance, o[idx], d[idx],
                                                None if s is None else s[idx])
        assert bool(moved.all()), f"pixels {bad[~moved.numpy()].tolist()} differ beyond one level"


@pytest.mark.parametrize("layout", ["tlas", "mono"])
def test_megapass_on_the_card(cuda, layout):
    """`samples_per_pass=4` on the card: `rays_traced` equal to the CPU's
    and to four single passes on the card, whose sum it equals within
    1e-6 relative; against the CPU, pixels beyond the parity tolerance
    need a fp-borderline sample path."""
    cpu, _ = compile_scene(XML, layout=layout, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    camera, s, base = cam_mod.make_camera(W, H, **CAMERA), 4, 9
    img, st = pathtracer.render_pass(gpu, camera, base, samples_per_pass=s)
    singles = [pathtracer.render_pass(gpu, camera, base + k) for k in range(s)]
    assert st["rays_traced"] == sum(x[1]["rays_traced"] for x in singles)
    want = sum(x[0] for x in singles)
    assert bool(((img - want).abs() <= 1e-6 * want.abs() + 1e-6).all())
    ref, st_cpu = pathtracer.render_pass(cpu, camera, base, samples_per_pass=s)
    assert st["rays_traced"] == st_cpu["rays_traced"]
    bad = torch.nonzero(~torch.isclose(img.cpu(), ref, atol=2e-5, rtol=1e-4).all(-1).reshape(-1))
    o, d, seeds = pathtracer.camera_rays(camera, base, "cpu", s)
    for p in bad.reshape(-1).tolist():
        rays = slice(p * s, (p + 1) * s)
        moved = borderline.nudge_sensitive(
            lambda oo, dd, ss: pathtracer.sample_radiance(cpu, oo, dd, ss)[0],
            o[rays], d[rays], seeds[rays])
        assert bool(moved.any()), f"pixel {p} differs and no sample path is fp-borderline"
