"""The port's primary-ray AOVs (`render/basics.py`, `render/debug.py`)
against the JAX package's.

* Albedo, normal, depth, edges and object id of `basics.render` against
  the JAX package's on the same scene, TLAS and mono layouts, within
  atol=2e-5, rtol=1e-4, except pixels the nudge probe shows borderline
  (`render/borderline.py`).  The JAX scenes run their packet kernels in
  interpret mode.
* The traversal and test heatmaps: the colouring against the JAX
  package's on the same counter arrays; the counters are the port's walk's
  (per ray, where the JAX packet kernels count per tile, ROADMAP queue 3).
* The four colourings of `debug` on seeded inputs, and `probe`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import basics as jax_basics
from cpu_ray_tracer_tpu.render import debug as jax_debug
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit_plain
from cpu_ray_tracer_tpu_torch.ops import intersect
from cpu_ray_tracer_tpu_torch.render import basics, borderline, debug
from cpu_ray_tracer_tpu_torch.scene import query
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env

W, H = 32, 20
COMPARED = ("albedo", "normal", "depth", "edges", "obj_id")
CASES = {
    # (xml, camera, layout)
    "bunny_teapot-tlas": (BENCH_XML, BENCH_CAMERA, "tlas"),
    "bunny_teapot-mono": (BENCH_XML, BENCH_CAMERA, "mono"),
    "cube_scene-mono": (CUBE_XML, {}, "mono"),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The port's scene, camera and AOVs beside the JAX package's AOVs."""
    xml, cam, layout = CASES[request.param]
    jax_scene, _ = jax_compile(xml, layout=layout)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        camera = jax_cam.make_camera(W, H, **cam)
        want = {aov: np.array(jax_basics.render(jax_scene, camera, aov)) for aov in COMPARED}
        probes = [jax_basics.probe(jax_scene, camera, x, y)
                  for x, y in ((3, 2), (16, 10), (25, 17), (W - 1, H - 1))]
    port, _ = compile_scene(xml, layout=layout, device="cpu")
    return port, cam_mod.make_camera(W, H, **cam), want, probes


@pytest.mark.parametrize("aov", COMPARED)
def test_aov_matches_jax(case, aov):
    port, camera, want, _ = case
    img = basics.render(port, camera, aov)
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    cmp = borderline.unexplained_pixels(lambda oo, dd, _: basics.aov_of_rays(port, oo, dd, aov),
                                        (o, d, None), img, torch.from_numpy(want[aov]))
    assert cmp["unexplained"].numel() == 0, (
        f"{aov}: pixels {cmp['unexplained'].tolist()} differ and are not fp-borderline")


def test_barycentrics_zero_off_triangles(case):
    """The edges AOV reads (u, v): on floor, light and miss lanes they are
    0, as the JAX package's traversal leaves them (ops/traverse_bvh.py:75-76)."""
    port, camera, _, _ = case
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    res = query.find_nearest(port, o, d)
    off = res["tri_idx"] < 0
    assert bool(off.any()) and bool((~off).any())
    assert not bool(res["u"][off].any()) and not bool(res["v"][off].any())


@pytest.mark.parametrize("aov", ["traversal", "tests"])
def test_heatmap_of_the_walk_counters(case, aov):
    """The heatmap is the JAX colouring of the port's walk counters (the
    plain walk here, on the CPU), scaled by the frame's peak."""
    port, camera, _, _ = case
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    t0, _ = intersect.primitive_hits(port, o, d)
    count = closest_hit_plain(port, o, d, t0, torch.ones(o.shape[0], dtype=torch.bool))[
        "traversed" if aov == "traversal" else "tested"]
    want = jax_debug.traverse_count_color(jnp.asarray(count.numpy()), int(count.max()))
    got = basics.render(port, camera, aov)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(H, W, 3))


def test_probe_matches_jax(case):
    port, camera, _, probes = case
    for (x, y), want in zip(((3, 2), (16, 10), (25, 17), (W - 1, H - 1)), probes):
        got = basics.probe(port, camera, x, y)
        assert (got["obj_idx"], got["tri_idx"]) == (want["obj_idx"], want["tri_idx"]), (x, y)
        assert got["t"] == pytest.approx(want["t"], rel=1e-5)
    # and the frame's object id colour at that pixel
    img = basics.render(port, camera, "obj_id")
    p = basics.probe(port, camera, 16, 10)
    torch.testing.assert_close(img[10, 16], debug.id_color(torch.tensor(p["obj_idx"])))


def test_unknown_aov_is_refused(case):
    port, camera, _, _ = case
    with pytest.raises(ValueError, match="unknown AOV"):
        basics.render(port, camera, "bogus")


def _counts(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 200, 1000).astype(np.int32)


@pytest.mark.parametrize("peak", [0, 1, 57, 199])
def test_traverse_count_color_matches_jax(peak):
    c = _counts(peak)
    np.testing.assert_array_equal(debug.traverse_count_color(torch.from_numpy(c), peak).numpy(),
                                  np.asarray(jax_debug.traverse_count_color(jnp.asarray(c), peak)))


@pytest.mark.parametrize("max_depth", [0, 20, 64])
def test_depth_color_matches_jax(max_depth):
    c = _counts(max_depth) % 70
    np.testing.assert_array_equal(debug.depth_color(torch.from_numpy(c), max_depth).numpy(),
                                  np.asarray(jax_debug.depth_color(jnp.asarray(c), max_depth)))


def test_edge_color_matches_jax():
    rng = np.random.default_rng(5)
    bary = rng.uniform(-0.1, 1.1, (4000, 2)).astype(np.float32)
    bary[:8] = [[0.0, 0.0], [0.0299, 0.5], [0.0301, 0.5], [0.5, 0.97], [0.5, 0.9701],
                [1.0, 0.0], [-0.02, 0.4], [0.4, 1.029]]
    np.testing.assert_array_equal(debug.edge_color(torch.from_numpy(bary)).numpy(),
                                  np.asarray(jax_debug.edge_color(jnp.asarray(bary))))


def test_id_color_matches_jax():
    """The uint32 hash, done in int64 with its product split: ids from -1
    up to 2**31 - 1."""
    rng = np.random.default_rng(9)
    ids = np.concatenate([np.arange(-3, 80), rng.integers(0, 2**31 - 1, 2000),
                          [2**31 - 1, 2**31 - 2, 2**16, 2**16 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(debug.id_color(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jax_debug.id_color(jnp.asarray(ids))))
