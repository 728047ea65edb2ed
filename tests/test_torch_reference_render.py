"""Renders of the port's reference route (`use_pallas=False`) against the
JAX package's XLA route on the JAX package's own `use_pallas=False`
scenes (carried over by `scene/convert`), `bunny_teapot` at 32x20, depth
5:

* the path tracer and Whitted for the TLAS BVH, grid forest and KD
  forest, the mono BVH, and shared instancing;
* the basics `traversal` and `tests` AOVs (the primary rays' counters as
  heatmaps).

`rays_traced` and every per-ray counter are exact: the path tracer's
sums over its depths, where the JAX package walks the dead rays too (a
pass of fewer than 4096 rays is one compaction chunk there, kept in pixel
order; `render/pathtracer.py`), the primary rays' counters of Whitted and
the basics AOVs, except on a ray whose walk counts otherwise in float64
than in float32 (`torch_rays.counter_borderline`; the test prints how
many).  Images are within atol=2e-5, rtol=1e-4 except fp-borderline
pixels (`render/borderline.py`).  The grid and KD forests are
`test_torch_reference_render_cells.py` and `_kd.py` (one file per minute
of CPU), the differentiable cases `test_torch_reference_diff.py`.

From 4096 rays a pass the JAX package cuts it into compaction chunks and
walks a dead ray only in a chunk that holds a live one; the port keeps the
one-chunk rule at every size (`render/pathtracer.py`, ROADMAP queue 3):
at 64x64 its counters equal the JAX package's with one chunk
(`CRT_COMPACTION_CHUNKS=1`), and the JAX package's default chunks count
no more than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import basics as jax_basics
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import basics, borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, jax_compile_reference, jax_reference_env, jax_scene_arrays,
)
from torch_rays import counter_borderline

W, H, DEPTH, SALT = 32, 20, 5, 3
CASES = {
    "tlas-bvh": dict(layout="tlas", accel="bvh"),
    "mono-bvh": dict(layout="mono", accel="bvh"),
    "shared": dict(layout="tlas", accel="bvh", instancing="shared"),
}


@pytest.fixture(scope="module", params=list(CASES))
def scenes(request):
    return reference_scenes(request.param, CASES[request.param])


def reference_scenes(case: str, kwargs: dict):
    """(case, the JAX package's `use_pallas=False` scene, the port's scene
    over its tables)."""
    jax_scene, _ = jax_compile_reference(BENCH_XML, **kwargs)
    port = scene_from_arrays(*jax_scene_arrays(jax_scene))
    assert port.reference is not None and not port.stack_kernels
    return case, jax_scene, port


def hold_primary_counters(port, got: np.ndarray, want: np.ndarray, label: str) -> None:
    """Per-pixel primary counters (or images of them) `got` against
    `want`: equal except on fp-borderline rays (module docstring)."""
    differ = (got != want).reshape(H * W, -1).any(axis=1)
    if differ.any():
        o, d = cam_mod.full_frame_rays(_camera()[0], device="cpu")
        unexplained = np.nonzero(differ & ~counter_borderline(port, o, d))[0]
        assert unexplained.size == 0, (label, unexplained.tolist())
    print(f"{label}: {int(differ.sum())} fp-borderline rays with other counters")


def _camera():
    return cam_mod.make_camera(W, H, **BENCH_CAMERA), jax_cam.make_camera(W, H, **BENCH_CAMERA)


def test_path_tracer_matches_jax(scenes):
    case, jax_scene, port = scenes
    camera, jcamera = _camera()
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        want, st = jax_pt.render_pass(jax_scene, jcamera, jnp.uint32(SALT), depth_limit=DEPTH)
    img, stats = pathtracer.render_pass(port, camera, SALT, DEPTH)
    assert stats["rays_traced"] == int(st["rays_traced"]) > W * H
    for k in ("traversed", "tested"):
        np.testing.assert_array_equal(stats[k].numpy(), np.asarray(st[k]), err_msg=f"{case} {k}")
    assert int(stats["traversed"].sum()) > 0 and bool(torch.isfinite(img).all())
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(port, o, d, s, DEPTH)[0],
        pathtracer.camera_rays(camera, SALT, "cpu"), img, torch.from_numpy(np.array(want)))
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


def test_whitted_matches_jax(scenes):
    case, jax_scene, port = scenes
    camera, jcamera = _camera()
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        want = jax_whitted.render(jax_scene, jcamera, depth_limit=DEPTH)
    got = whitted.render(port, camera, DEPTH)
    hold_primary_counters(port, np.stack([got[k].numpy() for k in ("traversed", "tested")], -1),
                          np.stack([np.asarray(want[k]) for k in ("traversed", "tested")], -1),
                          f"{case} whitted")
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    cmp = borderline.unexplained_pixels(
        lambda oo, dd, _: whitted.radiance(port, oo, dd, DEPTH)[0], (o, d, None), got["image"],
        torch.from_numpy(np.array(want["image"])))
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


@pytest.mark.parametrize("aov", ["traversal", "tests"])
def test_counter_aovs_match_jax(scenes, aov):
    case, jax_scene, port = scenes
    camera, jcamera = _camera()
    want = np.asarray(jax_basics.render(jax_scene, jcamera, aov=aov))
    got = basics.render(port, camera, aov).numpy()
    hold_primary_counters(port, ~np.isclose(got, want, atol=1e-6, rtol=0), np.zeros_like(got, bool),
                          f"{case} {aov} AOV")
    assert float(np.abs(got).sum()) > 0


def test_counters_past_4096_rays_follow_one_chunk():
    """64x64 = 4096 rays: per-ray counters equal the JAX package's with one
    compaction chunk; its default chunks walk fewer dead rays."""
    case, jax_scene, port = reference_scenes("tlas-bvh", CASES["tlas-bvh"])
    w = h = 64
    camera = cam_mod.make_camera(w, h, **BENCH_CAMERA)
    jcamera = jax_cam.make_camera(w, h, **BENCH_CAMERA)
    img, stats = pathtracer.render_pass(port, camera, SALT, DEPTH)
    totals = {}
    for chunks in ("1", None):
        with pytest.MonkeyPatch.context() as mp:
            jax_reference_env(mp)
            if chunks:
                mp.setenv("CRT_COMPACTION_CHUNKS", chunks)
            _, st = jax_pt.render_pass(jax_scene, jcamera, jnp.uint32(SALT), depth_limit=DEPTH)
        assert int(st["rays_traced"]) == stats["rays_traced"]
        totals[chunks] = int(np.asarray(st["traversed"]).sum())
        if chunks:
            for k in ("traversed", "tested"):
                np.testing.assert_array_equal(stats[k].numpy(), np.asarray(st[k]), err_msg=k)
    print(f"64x64 traversed: port {int(stats['traversed'].sum())}, JAX one chunk {totals['1']}, "
          f"JAX default chunks {totals[None]}")
    assert totals[None] <= totals["1"]
