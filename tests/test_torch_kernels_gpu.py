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

from cpu_ray_tracer_tpu_torch.benchmarks import leaf_tolerance, mxu_probe
from cpu_ray_tracer_tpu_torch.benchmarks import sync_probe as sync_bench
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.ops import (
    intersect, leaf_probe, link_walk, sync_probe, wavefront_pt, whitted_wf, wide_bvh,
)
from cpu_ray_tracer_tpu_torch.ops.closest_hit import (
    closest_hit, closest_hit_plain, occluded, occluded_plain,
)
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import query, synthetic
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_rays import axis_aligned_rays, flat_quads_xml, in_plane_rays, node_bounds, random_rays
from torch_taps import Taps

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
    cpu, _ = compile_scene(xml, device="cpu")
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
        pathtracer.camera_rays(cam, 1, "cpu"), img_gpu.cpu(), img_cpu,
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
        pathtracer.camera_rays(cam, 1, "cpu"), img_gpu.cpu(), img_cpu,
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
        (*cam_mod.full_frame_rays(cam, device="cpu"), None), out["image"].cpu(), ref,
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


ACCELS = {"grid": dict(accel="grid"), "kdtree": dict(accel="kdtree"), "wide": dict(wide=True),
          "bounce": dict(wide="bounce")}


@pytest.fixture(scope="module",
                params=[(a, x) for a in ACCELS for x in ("cube_scene", "bunny_teapot")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def accel_scenes(request, cuda):
    accel, name = request.param
    cpu, _ = compile_scene(os.path.join(ASSETS, "scenes", f"{name}.xml"), device="cpu",
                           **ACCELS[accel])
    return cpu, copy.deepcopy(cpu).to(cuda)


@pytest.mark.parametrize("kind", KINDS)
def test_link_and_wide_kernels_match_plain(accel_scenes, kind, cuda):
    """The link walk (grid, KD) and the wide walk: same walk, same order,
    same arithmetic as the plain versions, closest and any hit."""
    _, scene = accel_scenes
    o, d, t0, mask = _rays(kind, scene, cuda)
    mod = link_walk if scene.walk == "links" else wide_bvh
    suffix = "links" if scene.walk == "links" else "wide"
    kernel = getattr(mod, f"closest_hit_{suffix}")
    plain = getattr(mod, f"closest_hit_{suffix}_plain")
    before = kernel.launches
    got = kernel(scene, o, d, t0, mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _same(got, plain(scene, o, d, t0, mask))
    any_kernel = getattr(mod, f"occluded_{suffix}")
    any_plain = getattr(mod, f"occluded_{suffix}_plain")
    for tmax in (t0, torch.full_like(t0, 1.5)):
        occ = any_kernel(scene, o, d, tmax, mask)
        torch.cuda.synchronize()
        assert torch.equal(occ, any_plain(scene, o, d, tmax, mask))
        assert torch.equal(occ, plain(scene, o, d, tmax, mask)["slot"] >= 0)


def test_accel_renders_on_card_match_cpu(accel_scenes, cuda):
    """Path tracer and Whitted at their defaults for the scene (the host
    route for grid, KD and wide; the kernels for bounce) on the card against
    the CPU."""
    cpu, gpu = accel_scenes
    cam = cam_mod.make_camera(48, 32, **BENCH_CAMERA)
    img_gpu, st_gpu = pathtracer.render_pass(gpu, cam, 1)
    img_cpu, st_cpu = pathtracer.render_pass(cpu, cam, 1)
    assert st_gpu["rays_traced"] == st_cpu["rays_traced"]
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(cpu, o, d, s)[0],
        pathtracer.camera_rays(cam, 1, "cpu"), img_gpu.cpu(), img_cpu,
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
    out = whitted.render(gpu, cam)
    ref = whitted.render(cpu, cam)["image"]
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(cpu, o, d)[0],
        (*cam_mod.full_frame_rays(cam, device="cpu"), None), out["image"].cpu(), ref,
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


# the scenes past the old limits of the walk records (scene/synthetic.py)
LIMITS = ["deep_100", "deep_140", "big_leaf_bvh", "big_leaf_grid", "big_leaf_kdtree", "cubes70"]


@pytest.fixture(scope="module", params=LIMITS)
def limit_scenes(request, cuda, tmp_path_factory):
    name = request.param
    directory = str(tmp_path_factory.mktemp(name))
    if name.startswith("deep"):
        base, _ = compile_scene(os.path.join(ASSETS, "scenes", "cube_scene.xml"), device="cpu")
        cpu = synthetic.scene_over(base, synthetic.caterpillar(int(name[5:])))
    elif name == "cubes70":
        cpu, _ = compile_scene(synthetic.cubes_xml(directory, ASSETS), device="cpu")
    else:
        xml = synthetic.big_leaf_xml(directory, ASSETS)
        if name == "big_leaf_bvh":
            cpu = synthetic.scene_over(compile_scene(xml, device="cpu")[0],
                                       synthetic.big_leaf_bvh())
        else:
            cpu, _ = compile_scene(xml, device="cpu", accel=name.split("_")[-1])
    return name, cpu, copy.deepcopy(cpu).to(cuda)


def _camera_rays(scene, device, w=96, h=60):
    cam = cam_mod.make_camera(w, h)
    o, d, seeds = pathtracer.camera_rays(cam, 3, device)
    t0, _ = intersect.primitive_hits(scene, o, d)
    return cam, o, d, t0, seeds


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_limit_scene_walks_match_plain(limit_scenes, kind, cuda):
    """K1 (the stack walk: 100 levels with more than 64 stack entries, the
    600-triangle leaf, the wide ids' slot table) and K2 (the 140-level BVH
    by links, the big leaf in the grid and KD tree), closest and any hit,
    against their plain versions on the card."""
    name, _, scene = limit_scenes
    assert scene.walk == ("stack" if name in ("deep_100", "big_leaf_bvh", "cubes70") else "links")
    if kind == "primary":
        _, o, d, t0, _ = _camera_rays(scene, cuda)
        mask = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    else:
        bmin, bmax = node_bounds(scene.nodes.cpu().numpy())
        o, d, t0, mask = (torch.from_numpy(x).to(cuda) for x in random_rays(bmin, bmax, 4096, 7))
    links = scene.walk == "links"
    plain = link_walk.closest_hit_links_plain if links else closest_hit_plain
    any_plain = link_walk.occluded_links_plain if links else occluded_plain
    got = query.triangle_hit(scene, o, d, t0, mask)
    torch.cuda.synchronize()
    want = plain(scene, o, d, t0, mask)
    _same(got, want)
    if kind == "primary":  # (random rays miss the big leaf's one plane)
        assert bool((got["tri_idx"] >= 0).any())
    if name == "cubes70":
        assert int(got["obj_id"].max()) > 63
    if name.startswith("big_leaf") and kind == "primary":
        assert int(got["tested"].max()) >= synthetic.BIG_LEAF
    for tmax in (t0, torch.full_like(t0, 1.5)):
        occ = query.triangle_occluded(scene, o, d, tmax, mask)
        torch.cuda.synchronize()
        assert torch.equal(occ, any_plain(scene, o, d, tmax, mask))


@pytest.mark.parametrize("k", [1, 2, 6])
def test_fused_kernels_on_limit_scenes_match_plain(limit_scenes, k, cuda):
    """K3 and K4 on the stack branch (100 levels, the big leaf's BVH) and
    the link branch (140 levels; the big leaf's grid and KD forests, which
    the renderers keep on the host route) against their plain versions;
    the wide ids' scene, whose materials the meta word does not hold, is
    refused."""
    name, _, scene = limit_scenes
    cam, o, d, _, seeds = _camera_rays(scene, cuda)
    if scene.slot_ids is not None:
        with pytest.raises(ValueError, match="meta word"):
            wavefront_pt.trace(scene, o, d, seeds, k, 5)
        return
    perm = cam_mod.lane_order(cam, cuda)
    _same(wavefront_pt.trace(scene, o, d, seeds, k, 5, perm=perm),
          wavefront_pt.trace_plain(scene, o, d, seeds, k, 5))
    if k == 1:
        _, inside = _flags(o.shape[0], cuda, 9)
        _same(whitted_wf.trace_level0(scene, o, d, inside, perm=perm),
              whitted_wf.trace_level0_plain(scene, o, d, inside))


@pytest.mark.parametrize("k", [1, 6])
def test_permuted_wavefront_matches_plain(scenes, k, cuda):
    """K3 in pixel order and in the camera's lane order: every output at
    the ray's own index, bit-equal to the plain version, live counts
    exact."""
    _, scene = scenes
    cam, o, d, _, seeds = _camera_rays(scene, cuda)
    want = wavefront_pt.trace_plain(scene, o, d, seeds, k, 5)
    for perm in (None, cam_mod.lane_order(cam, cuda)):
        before = wavefront_pt.trace.launches
        got = wavefront_pt.trace(scene, o, d, seeds, k, 5, perm=perm)
        torch.cuda.synchronize()
        assert wavefront_pt.trace.launches == before + 1
        _same(got, want)


def test_permuted_whitted_matches_plain(scenes, cuda):
    """K4 with the camera's lane order: bit-equal to the plain version."""
    _, scene = scenes
    cam, o, d, _, _ = _camera_rays(scene, cuda)
    _, inside = _flags(o.shape[0], cuda, 9)
    want = whitted_wf.trace_level0_plain(scene, o, d, inside)
    for perm in (None, cam_mod.lane_order(cam, cuda)):
        _same(whitted_wf.trace_level0(scene, o, d, inside, perm=perm), want)


@pytest.fixture(scope="module", params=["cube_scene", "bunny_teapot", "deep_100", "deep_140",
                                        "big_leaf_bvh", "cubes70"])
def wide_scenes(request, cuda, tmp_path_factory):
    """The wide walk's scenes: the in-tree ones and the limit scenes
    collapsed into 8-wide nodes (`synthetic.scene_over(wide=True)`)."""
    name = request.param
    directory = str(tmp_path_factory.mktemp(name))
    if name in ("cube_scene", "bunny_teapot"):
        cpu, _ = compile_scene(os.path.join(ASSETS, "scenes", f"{name}.xml"), device="cpu",
                               wide=True)
    elif name.startswith("deep"):
        base, _ = compile_scene(os.path.join(ASSETS, "scenes", "cube_scene.xml"), device="cpu")
        cpu = synthetic.scene_over(base, synthetic.caterpillar(int(name[5:])), wide=True)
    elif name == "cubes70":
        cpu, _ = compile_scene(synthetic.cubes_xml(directory, ASSETS), device="cpu", wide=True)
    else:
        cpu = synthetic.scene_over(
            compile_scene(synthetic.big_leaf_xml(directory, ASSETS), device="cpu")[0],
            synthetic.big_leaf_bvh(), wide=True)
    return name, cpu, copy.deepcopy(cpu).to(cuda)


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_wide_walk_matches_plain_in_any_lane_order(wide_scenes, kind, cuda):
    """K5 (records, the id stack, the lane order) closest and any hit,
    bit-equal to its plain version with and without the camera's lane
    order, steps and tests included."""
    name, _, scene = wide_scenes
    assert scene.walk == "wide"
    camera = BENCH_CAMERA if name in ("cube_scene", "bunny_teapot") else {}
    cam = cam_mod.make_camera(96, 60, **camera)
    if kind == "primary":
        o, d, _ = pathtracer.camera_rays(cam, 3, cuda)
        t0, _ = intersect.primitive_hits(scene, o, d)
        mask = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
        orders = (None, cam_mod.lane_order(cam, cuda))
    else:
        bmin, bmax = node_bounds(scene.nodes.cpu().numpy())
        o, d, t0, mask = (torch.from_numpy(x).to(cuda) for x in random_rays(bmin, bmax, 4096, 7))
        orders = (None, torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(3))
                  .to(torch.int32).to(cuda))
    want = wide_bvh.closest_hit_wide_plain(scene, o, d, t0, mask)
    any_want = wide_bvh.occluded_wide_plain(scene, o, d, t0, mask)
    for perm in orders:
        before = wide_bvh.closest_hit_wide.launches
        got = wide_bvh.closest_hit_wide(scene, o, d, t0, mask, perm)
        torch.cuda.synchronize()
        assert wide_bvh.closest_hit_wide.launches == before + 1
        _same(got, want)
        assert torch.equal(wide_bvh.occluded_wide(scene, o, d, t0, mask, perm), any_want)
    if kind == "primary":
        assert bool((want["tri_idx"] >= 0).any())


def test_mxu_leaf_kernels_run_on_wgmma(cuda):
    """Every instance of K7's kernel holds HGMMA (wgmma) in its SASS."""
    import re
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    from cpu_ray_tracer_tpu_torch.ops import kernel_lib

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           kernel_lib.load().path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"mxu_leaf_kernelILi(\d+)E", line)
            name = found and int(found.group(1))
        elif name and "HGMMA" in line:
            counts[name] = counts.get(name, 0) + 1
    assert set(counts) == set(leaf_probe.WIDTHS), counts


@pytest.fixture(scope="module")
def leaf_inputs(cuda):
    """The leaf probe's inputs at its full size: 64 tiles of 4096 rays."""
    return mxu_probe.inputs(mxu_probe.N_TILES, cuda)


def test_vpu_leaf_kernel_matches_plain(leaf_inputs):
    """K6 on every ray of the 64 tiles: the division-free test from the
    packed normal, FMA contracted, against the probe's arithmetic; rays
    beyond 1e-5 relative only where the float64 evaluation explains them
    (`leaf_tolerance.disagreements`), packed in the call or once by the
    caller alike."""
    tris, comps = leaf_inputs["tris"], leaf_inputs["comps"]
    before = leaf_probe.vpu_leaf.launches
    got = leaf_probe.vpu_leaf(tris, *comps)
    torch.cuda.synchronize()
    assert leaf_probe.vpu_leaf.launches == before + 1
    assert torch.equal(mxu_probe.vpu(leaf_inputs), got)
    want = leaf_probe.vpu_leaf_plain(tris, *comps)
    beyond, bad = leaf_tolerance.disagreements(
        got, want, lambda r: leaf_tolerance.vpu_quantities(tris, comps, r), with_uv=True)
    print(f"K6: {beyond.numel()} of {got.numel()} rays beyond 1e-5 relative, all explained "
          f"by the float64 evaluation but {bad.numel()}")
    assert bad.numel() == 0, bad[:16].tolist()
    assert beyond.numel() < 1e-3 * got.numel()
    assert 0.5 < float((got < 1e29).float().mean()) < 1.0


@pytest.mark.parametrize("m", leaf_probe.WIDTHS)
def test_mxu_leaf_kernel_matches_plain(leaf_inputs, m):
    """K7 on every ray of the 64 tiles: 3xTF32 on the tensor cores against
    the float64 product; rays beyond 1e-5 relative only where the float64
    evaluation explains them (`leaf_tolerance.disagreements`)."""
    c_tab, phi = leaf_inputs["per_m"][m]
    before = leaf_probe.mxu_leaf.launches[m]
    got = leaf_probe.mxu_leaf(c_tab, phi, m)
    torch.cuda.synchronize()
    assert leaf_probe.mxu_leaf.launches[m] == before + 1
    want = leaf_probe.mxu_leaf_plain(c_tab, phi, m)
    assert got.shape == want.shape == (mxu_probe.N_TILES, leaf_probe.TILE)
    beyond, bad = leaf_tolerance.disagreements(
        got, want, lambda r: leaf_tolerance.mxu_quantities(c_tab, phi, m, r), with_uv=False)
    print(f"K7 m={m}: {beyond.numel()} of {got.numel()} rays beyond 1e-5 relative, all "
          f"explained by the float64 evaluation but {bad.numel()}")
    assert bad.numel() == 0, bad[:16].tolist()
    assert beyond.numel() < 1e-3 * got.numel()


@pytest.fixture(scope="module")
def sync_inputs(cuda):
    """The node-step probe's tables and its 921,600 camera rays."""
    return sync_bench.inputs(sync_bench.N_TILES, cuda)


@pytest.mark.parametrize("variant", sync_probe.VARIANTS)
def test_node_walk_kernel_matches_plain(sync_inputs, variant):
    """K8, every variant, on the probe's full inputs and on as many NaN-case
    rays (`sync_probe.nan_rays`: origins on slab planes, a zero direction
    component, flattened boxes): equal."""
    for data in (sync_inputs, sync_bench.nan_rays(sync_inputs, sync_bench.N_TILES)):
        before = sync_probe.node_walk.launches[variant]
        got = sync_bench.run(data, variant)
        torch.cuda.synchronize()
        assert sync_probe.node_walk.launches[variant] == before + 1
        want = sync_probe.node_walk_plain(data["aabb"], data["links"], data["comps"], variant)
        assert torch.equal(got, want)


# gradients on the card (kernels) against the CPU (plain versions): the
# binary, link and wide walks, and the bilinear tap
GRAD_CONFIGS = {"bvh": {}, "grid": dict(accel="grid"), "wide": dict(wide=True),
                "bvh-bilinear": dict(bilinear=True)}
GRAD_DEPTH, GRAD_SPP = 2, 7
# the gradients' atol relative to max|g|: the diffuse weight's cosine is
# analytically constant in the normal and leaves rounding residue in the
# vertex gradients.  On a bilinear scene the texels' and the vertices'
# gradients hold only in sum (relative L1 error `BILINEAR_L1`, each entry
# within `GRAD_ATOL_BILINEAR` max|g|): a texel's weight (1 - tx) near 0
# takes the sky's atan2 / acos rounding (CUDA's and the CPU's) times the
# texture width, and a sample within rounding of a texel edge takes the
# other texel pair on one device, so its uv derivative jumps by a texel
# difference times the width (up to 2.9e-3 max|g| on v0 and a relative L1
# error of 7.7e-4, on an H100 80GB HBM3 at 700 W).  The witness: with the
# CPU's tap positions replayed on the card where they differ by rounding
# (`torch_taps`) every key holds entry by entry at `GRAD_ATOL`
GRAD_ATOL, GRAD_ATOL_BILINEAR, BILINEAR_L1 = 2e-4, 1e-2, 2e-3
BILINEAR_KEYS = ("texels", "v0", "e1", "e2")


@pytest.mark.parametrize("integrator", ["pathtracer", "whitted"])
@pytest.mark.parametrize("config", list(GRAD_CONFIGS))
def test_gradients_on_card_match_cpu(config, integrator, cuda):
    """bunny_teapot 64x40, depth 2 (the path tracer at a fixed seed): the
    gradients of every key of PARAM_KEYS on the card, through the walk
    kernel of the scene (and the any-hit kernel for Whitted), within
    atol = 2e-4 max|g|, rtol = 1e-3 of the CPU's (the texels and vertices
    of the bilinear scene in sum: `BILINEAR_L1`), over the pixels whose
    images agree at the parity tolerance (the others must be
    fp-borderline).  The card's scatters of the backward sum in another
    order, and the atol covers entries that are rounding residue on both
    devices (`GRAD_ATOL`)."""
    cpu, _ = compile_scene(os.path.join(ASSETS, "scenes", "bunny_teapot.xml"), device="cpu",
                           **GRAD_CONFIGS[config])
    gpu = copy.deepcopy(cpu).to(cuda)
    camera = cam_mod.make_camera(64, 40, **BENCH_CAMERA)

    def render(sc, o=None, d=None, s=None):
        if integrator == "pathtracer":
            if o is None:
                return pathtracer.render_pass(sc, camera, GRAD_SPP, GRAD_DEPTH,
                                              differentiable=True)[0]
            return pathtracer.sample_radiance(sc, o, d, s, GRAD_DEPTH, differentiable=True)[0]
        if o is None:
            return whitted.render(sc, camera, GRAD_DEPTH, differentiable=True)["image"]
        return whitted.radiance(sc, o, d, GRAD_DEPTH, differentiable=True)[0]

    if integrator == "pathtracer":
        rays = pathtracer.camera_rays(camera, GRAD_SPP, "cpu")
    else:
        rays = (*cam_mod.full_frame_rays(camera, device="cpu"), None)
    with torch.no_grad():
        img_cpu, img_gpu = render(cpu), render(gpu).cpu()
    mask, cmp = borderline.agreement_mask(lambda o, d, s: render(cpu, o, d, s), rays, img_gpu,
                                          img_cpu)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
    params = grad_mod.extract_params(cpu, grad_mod.PARAM_KEYS)

    def grads(sc, dev, taps=None):
        """The gradients on `dev`; with `taps`, recording the bilinear taps'
        positions (`taps.record_port`) or, with `replay` set, replaying
        them."""

        def taped(s):
            if taps is None:
                return render(s)
            with pytest.MonkeyPatch.context() as mp:
                if replay is None:
                    taps.record_port(mp)
                else:
                    taps.replay_port(mp, replay)
                return render(s)

        loss_fn = grad_mod.make_loss_fn(sc, lambda s: taped(s) * mask.to(dev),
                                        torch.zeros(img_cpu.shape, device=dev))
        return grad_mod.value_and_grad(loss_fn, {k: v.to(dev) for k, v in params.items()})[1]

    walk = dict(stack=closest_hit, links=link_walk.closest_hit_links,
                wide=wide_bvh.closest_hit_wide)[gpu.walk]
    any_walk = dict(stack=occluded, links=link_walk.occluded_links,
                    wide=wide_bvh.occluded_wide)[gpu.walk]
    before, any_before = walk.launches, any_walk.launches
    g_gpu = grads(gpu, cuda)
    torch.cuda.synchronize()
    assert walk.launches > before
    assert (any_walk.launches > any_before) == (integrator == "whitted")
    taps, replay = (Taps(), None) if cpu.bilinear else (None, None)
    g_cpu = grads(cpu, torch.device("cpu"), taps)
    for key in grad_mod.PARAM_KEYS:
        want, got = g_cpu[key], g_gpu[key].cpu()
        assert bool(torch.isfinite(got).all()), key
        scale = float(want.abs().max())
        excess = float(((got - want).abs() - 1e-3 * want.abs()).max())
        l1 = float((got - want).abs().sum() / want.abs().sum().clamp_min(1e-30))
        atol = GRAD_ATOL_BILINEAR if cpu.bilinear and key in BILINEAR_KEYS else GRAD_ATOL
        assert excess <= atol * scale, (
            f"{key}: beyond rtol 1e-3 by {excess / scale:.3g} max|g| (max|g| {scale:.6g}), "
            f"relative L1 error {l1:.3g}")
        if cpu.bilinear and key in BILINEAR_KEYS:
            assert l1 <= BILINEAR_L1, f"{key}: relative L1 error {l1:.3g}"
    if cpu.bilinear:
        # the witness: the card replaying the CPU's tap positions
        replay = {}
        g_replay = grads(gpu, cuda, taps)
        assert replay["calls"] == len(taps.calls) and replay["taps"] > 0, replay
        worst = {}
        for key in grad_mod.PARAM_KEYS:
            want, got = g_cpu[key], g_replay[key].cpu()
            scale = float(want.abs().max())
            excess = float(((got - want).abs() - 1e-3 * want.abs()).max())
            worst[key] = excess / scale if scale > 0 else excess
            assert excess <= GRAD_ATOL * scale, f"{key} with the taps replayed: {worst[key]:.3g}"
        print(f"{config} {integrator}: taps replayed {replay}; the largest excess over rtol "
              f"1e-3 in units of max|g|, per key: { {k: f'{v:.3g}' for k, v in worst.items()} }")
    assert float(g_gpu["albedo"].abs().sum()) > 0 and float(g_gpu["light_color"].abs().sum()) > 0
    assert (float(g_gpu["texels"].abs().sum()) > 0) == config.endswith("bilinear")
