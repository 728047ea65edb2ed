"""The reference walks (`use_pallas=False`) on the card against the CPU:
each walk (the TLAS BVH, grid forest and KD forest, the mono grid and KD
tree; closest and any hit) on 64x40 camera rays and on bounce-like rays,
and a 64x40 path-tracer pass and Whitted frame per accelerator.  The
walks' integers exact, counters included, and floats within atol=2e-5,
rtol=1e-4; the renders' `rays_traced` exact, their per-ray counters equal
but on rays whose walks are fp-borderline in a float64 evaluation on the
CPU (`torch_rays.counter_borderline`: the shading glue's `exp`, `sin`,
`cos` and `sqrt` round differently on the card, so a bounce ray may start
a last bit apart), and images within the tolerance except pixels the
nudge probe shows fp-borderline on the CPU.  No kernel may launch: the
route is plain PyTorch on the card.

These need an NVIDIA GPU and skip without one.  They import neither JAX
nor the repo's conftest:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_reference_gpu.py -q
"""

import copy
import os

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import closest_hit, link_walk, wavefront_pt, whitted_wf
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_rays import counter_borderline

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
XML = os.path.join(ASSETS, "scenes", "bunny_teapot.xml")
CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
W, H, DEPTH = 64, 40, 5
CASES = [("tlas", "bvh"), ("tlas", "grid"), ("tlas", "kdtree"), ("mono", "grid"),
         ("mono", "kdtree")]
KERNELS = (closest_hit.closest_hit, closest_hit.occluded, wavefront_pt.trace,
           whitted_wf.trace_level0, link_walk.closest_hit_links, link_walk.occluded_links)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these hold the card's run to the CPU's")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def scenes(request, cuda):
    layout, accel = request.param
    cpu, _ = compile_scene(XML, layout=layout, accel=accel, use_pallas=False, device="cpu")
    return request.param, cpu, copy.deepcopy(cpu).to(cuda)


def _no_launch(fn):
    """fn()'s result; fails if any kernel wrapper launched."""
    for k in KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    assert all(k.launches == 0 for k in KERNELS), [k.launches for k in KERNELS]
    return out


def _hold_counters(case, cpu, got: dict, want: dict, o, d, counters=None) -> None:
    """Per-ray `traversed` and `tested` of a render on the card against
    the CPU's: equal but on fp-borderline rays (module docstring), checked
    on the rays that differ (`counters(idx)` gives their counters'
    function, default the nearest-hit query's)."""
    differ = torch.zeros(o.shape[0], dtype=torch.bool)
    for k in ("traversed", "tested"):
        differ |= (got[k].cpu() != want[k]).reshape(-1)
    idx = torch.nonzero(differ).squeeze(1)
    if idx.numel():
        border = torch.from_numpy(counter_borderline(
            cpu, o[idx], d[idx], None if counters is None else counters(idx)))
        assert bool(border.all()), (case, idx[~border].tolist())
    print(f"{case}: {idx.numel()} fp-borderline rays with other counters")


def _rays(n: int = 20000, seed: int = 0):
    """Bounce-like rays through the scene's box, a third of them cut at a
    random t0."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-1.5, -1.0, 0.0), (1.5, 1.0, 4.0), size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, constants.RAY_FAR, np.float32)
    t0[::3] = rng.uniform(0.05, 3.0, size=t0[::3].shape)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_walk_on_the_card_equals_the_cpu(scenes, rays, any_hit):
    case, cpu, gpu = scenes
    if rays == "camera":
        o, d = cam_mod.full_frame_rays(cam_mod.make_camera(W, H, **CAMERA), device="cpu")
        t0 = torch.full((o.shape[0],), constants.RAY_FAR)
    else:
        o, d, t0 = _rays()
    want = cpu.reference.walk(o, d, t0, any_hit)
    got = _no_launch(lambda: gpu.reference.walk(o.cuda(), d.cuda(), t0.cuda(), any_hit))
    for k in ("tri_idx", "obj_id", "mat_id", "traversed", "tested"):
        assert torch.equal(got[k].cpu(), want[k]), (case, k)
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k].cpu(), want[k], atol=2e-5, rtol=1e-4)
    assert got["loop_steps"] == want["loop_steps"]
    assert int((want["tri_idx"] >= 0).sum()) > 100


def test_renders_on_the_card_equal_the_cpu(scenes):
    case, cpu, gpu = scenes
    camera = cam_mod.make_camera(W, H, **CAMERA)
    img, stats = _no_launch(lambda: pathtracer.render_pass(gpu, camera, 1, DEPTH))
    want, wstats = pathtracer.render_pass(cpu, camera, 1, DEPTH)
    assert stats["rays_traced"] == wstats["rays_traced"]
    o, d, seeds = pathtracer.camera_rays(camera, 1, "cpu")

    def pt_counters(idx):
        def counters(sc, oo, dd):
            st = pathtracer.sample_radiance(sc, oo, dd, seeds[idx], DEPTH)[1]
            return torch.stack([st["traversed"], st["tested"]], dim=-1)
        return counters

    _hold_counters(case, cpu, stats, wstats, o, d, pt_counters)
    cmp = borderline.unexplained_pixels(
        lambda oo, dd, ss: pathtracer.sample_radiance(cpu, oo, dd, ss, DEPTH)[0],
        (o, d, seeds), img.cpu(), want)
    assert cmp["unexplained"].numel() == 0, (case, cmp["unexplained"].tolist())

    frame = _no_launch(lambda: whitted.render(gpu, camera, DEPTH))
    wframe = whitted.render(cpu, camera, DEPTH)
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    _hold_counters(case, cpu, frame, wframe, o, d)
    cmp = borderline.unexplained_pixels(
        lambda oo, dd, _: whitted.radiance(cpu, oo, dd, DEPTH)[0], (o, d, None),
        frame["image"].cpu(), wframe["image"])
    assert cmp["unexplained"].numel() == 0, (case, cmp["unexplained"].tolist())
