"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and renders on the card against renders on the CPU.

These need an NVIDIA GPU and skip without one.  They import neither JAX
nor the repo's conftest, so they run on a machine without JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py -q
"""

import copy
import os

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import intersect, wavefront_pt, whitted_wf
from cpu_ray_tracer_tpu_torch.ops.closest_hit import (
    closest_hit, closest_hit_plain, occluded, occluded_plain,
)
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_rays import axis_aligned_rays, flat_quads_xml, in_plane_rays, node_bounds, random_rays

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
BENCH_CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["cube_scene", "bunny_teapot", "flat_quads"])
def scenes(request, cuda, tmp_path_factory):
    if request.param == "flat_quads":
        xml = flat_quads_xml(str(tmp_path_factory.mktemp("flat")), ASSETS)
    else:
        xml = os.path.join(ASSETS, "scenes", f"{request.param}.xml")
    cpu, _ = compile_scene(xml)
    return cpu, copy.deepcopy(cpu).to(cuda)


def _rays(kind, scene, device):
    if kind == "primary":
        cam = cam_mod.make_camera(96, 60, **BENCH_CAMERA)
        o, d, _ = pathtracer.camera_rays(cam, 3, device)
        t0, _ = intersect.primitive_hits(scene, o, d)
        return o, d, t0, torch.ones(o.shape[0], dtype=torch.bool, device=device)
    if kind == "in_plane":
        rays = in_plane_rays(4096, seed=7)
    else:
        bmin, bmax = node_bounds(scene.nodes.cpu().numpy())
        make = random_rays if kind == "random" else axis_aligned_rays
        rays = make(bmin, bmax, 4096, seed=7)
    return tuple(torch.from_numpy(x).to(device) for x in rays)


@pytest.mark.parametrize("kind", ["primary", "random", "axis_aligned", "in_plane"])
def test_closest_hit_kernel_matches_plain(scenes, kind, cuda):
    """Same walk, same order, same arithmetic (-fmad=false): ids and
    counters equal, t/u/v within 1e-6 relative (bit-equal in practice)."""
    _, scene = scenes
    o, d, t0, mask = _rays(kind, scene, cuda)
    before = closest_hit.launches
    got = closest_hit(scene, o, d, t0, mask)
    torch.cuda.synchronize()
    assert closest_hit.launches == before + 1
    want = closest_hit_plain(scene, o, d, t0, mask)
    for key in ("slot", "tri_idx", "obj_id", "mat_id", "traversed", "tested"):
        assert torch.equal(got[key], want[key]), key
    for key in ("t", "u", "v"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=0.0)
    # (the cube's only box has every axis-aligned ray on a slab plane: none
    # hits; in-plane rays hit nothing by construction)
    assert (
        bool((got["tri_idx"] >= 0).any())
        or (kind == "axis_aligned" and scene.root_is_leaf) or kind == "in_plane"
    )
    assert not bool((got["traversed"][~mask] != 0).any())


def test_render_on_card_matches_cpu(scenes, cuda):
    """render_pass through the kernel on the card against the plain
    versions on the CPU: rays_traced exact, image at the JAX package's
    parity tolerance (tests/test_wavefront.py:62) except where the nudge
    probe shows a pixel fp-borderline (the two devices round exp, atan2,
    acos and rsqrt differently in the last bit)."""
    cpu, gpu = scenes
    cam = cam_mod.make_camera(48, 32, **BENCH_CAMERA)
    img_gpu, st_gpu = pathtracer.render_pass(gpu, cam, 1)
    img_cpu, st_cpu = pathtracer.render_pass(cpu, cam, 1)
    assert st_gpu["rays_traced"] == st_cpu["rays_traced"]
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(cpu, o, d, s)[0],
        pathtracer.camera_rays(cam, 1), img_gpu.cpu(), img_cpu,
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


KINDS = ["primary", "random", "axis_aligned", "in_plane"]


def _same(got: dict, want: dict):
    """Integers and bools equal, floats within 1e-6 relative (bit-equal in
    practice: same math, same order, -fmad=false)."""
    assert got.keys() == want.keys()
    for key in want:
        if want[key].is_floating_point():
            torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=0.0, equal_nan=True,
                                       msg=key)
        else:
            assert torch.equal(got[key], want[key]), key


def _flags(n, device, seed):
    rng = np.random.default_rng(seed)
    seeds = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.int64)).to(device)
    inside = torch.from_numpy(rng.uniform(size=n) < 0.2).to(device)
    return seeds, inside


@pytest.mark.parametrize("kind", KINDS)
def test_occluded_kernel_matches_plain(scenes, kind, cuda):
    _, scene = scenes
    o, d, t0, mask = _rays(kind, scene, cuda)
    for tmax in (t0, torch.full_like(t0, 1.5)):
        before = occluded.launches
        got = occluded(scene, o, d, tmax, mask)
        torch.cuda.synchronize()
        assert occluded.launches == before + 1
        want = occluded_plain(scene, o, d, tmax, mask)
        assert torch.equal(got, want)
        assert not bool(got[~mask].any())
        hits = closest_hit_plain(scene, o, d, tmax, mask)["slot"] >= 0
        assert torch.equal(got, hits)  # any hit iff a closest hit


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_wavefront_kernel_matches_plain(scenes, kind, k, cuda):
    _, scene = scenes
    o, d, _, mask = _rays(kind, scene, cuda)
    seeds, inside = _flags(o.shape[0], cuda, 8)
    alive = None if kind == "primary" else mask
    before = wavefront_pt.trace.launches
    got = wavefront_pt.trace(scene, o, d, seeds, k, 5, alive, inside & mask)
    torch.cuda.synchronize()
    assert wavefront_pt.trace.launches == before + 1
    want = wavefront_pt.trace_plain(scene, o, d, seeds, k, 5, alive, inside & mask)
    _same(got, want)
    assert int(got["live_counts"][0]) == int(mask.sum())


@pytest.mark.parametrize("kind", KINDS)
def test_whitted_kernel_matches_plain(scenes, kind, cuda):
    _, scene = scenes
    o, d, _, mask = _rays(kind, scene, cuda)
    _, inside = _flags(o.shape[0], cuda, 9)
    before = whitted_wf.trace_level0.launches
    got = whitted_wf.trace_level0(scene, o, d, inside, mask)
    torch.cuda.synchronize()
    assert whitted_wf.trace_level0.launches == before + 1
    _same(got, whitted_wf.trace_level0_plain(scene, o, d, inside, mask))


@pytest.mark.parametrize("k", [1, 6])
def test_wavefront_render_on_card_matches_cpu(scenes, cuda, k):
    cpu, gpu = scenes
    cam = cam_mod.make_camera(48, 32, **BENCH_CAMERA)
    img_gpu, st_gpu = pathtracer.render_pass(gpu, cam, 1, wavefront_depths=k)
    img_cpu, st_cpu = pathtracer.render_pass(cpu, cam, 1, wavefront_depths=k)
    assert st_gpu["rays_traced"] == st_cpu["rays_traced"]
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(cpu, o, d, s, wavefront_depths=k)[0],
        pathtracer.camera_rays(cam, 1), img_gpu.cpu(), img_cpu,
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


@pytest.mark.parametrize("level_kernel", [True, False])
def test_whitted_render_on_card_matches_cpu(scenes, cuda, level_kernel):
    cpu, gpu = scenes
    cam = cam_mod.make_camera(48, 32, **BENCH_CAMERA)
    out = whitted.render(gpu, cam, level_kernel=level_kernel)
    assert out["dropped"] == 0
    ref = whitted.render(cpu, cam, level_kernel=level_kernel)["image"]
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(cpu, o, d, level_kernel=level_kernel)[0],
        (*cam_mod.full_frame_rays(cam), None), out["image"].cpu(), ref,
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
