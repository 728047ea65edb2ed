"""The wide (8-ary) BVH of the PyTorch port against the JAX package.

* Tables: the collapse the port packs (`compile_scene(wide=True)`) equals
  the JAX package's `packed_wide` (`CRT_WIDE=1`, accel/wide.py): each wide
  node's 8 child boxes (NaN for empty slots), its 8 per-octant order words,
  its interior children, and the triangles of its leaf children (the port
  names the binary pack's slots where the JAX package regroups rows).
* The wide walk: `closest_hit_wide_plain` / `occluded_wide_plain` (the CUDA
  kernel's plain versions) against the JAX package's wide kernel
  `wide_bvh.traverse` in interpret mode (`_kernel`, wide_bvh.py:54),
  closest and any hit, on camera rays, rays from inside and around the
  scene with a mask, and rays whose t0 cuts hits: t, u, v at the parity
  tolerance (atol=2e-5, rtol=1e-4), ids exact except at ties, the any-hit
  booleans exact.
* Interchange: the wide walk's hits equal the binary walk's (t exact where
  the triangle agrees).
* Routes: `wide=True` takes the host route by default and refuses the
  kernel routes; `wide="bounce"` keeps the wavefront and Whitted level
  kernels on the binary tables and sends the host queries wide.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.ops.pallas import wide_bvh as jax_wide
from cpu_ray_tracer_tpu_torch.accel import wide
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import closest_hit, intersect, wavefront_pt, whitted_wf, wide_bvh
from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import query
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, assert_wide_tables_equal, jax_compile_wide,
)
from torch_rays import assert_hits_agree, node_bounds, random_rays, shadow_rays

XMLS = {"cube_scene": CUBE_XML, "bunny_teapot": BENCH_XML}
KINDS = ("primary", "random", "shadow")


@pytest.fixture(scope="module", params=list(XMLS))
def pair(request):
    jax_scene, _ = jax_compile_wide(XMLS[request.param])
    port, _ = compile_scene(XMLS[request.param], wide=True, device="cpu")
    return jax_scene, port


def test_wide_tables_equal(pair):
    jax_scene, port = pair
    assert port.walk == "wide" and not port.stack_kernels
    assert_wide_tables_equal(jax_scene, port)


def _rays(kind, port):
    if kind == "primary":
        cam = cam_mod.make_camera(64, 40, **BENCH_CAMERA)
        o, d, _ = pathtracer.camera_rays(cam, 2, "cpu")
        t0, _ = intersect.primitive_hits(port, o, d)
        return o.numpy(), d.numpy(), t0.numpy(), np.ones(o.shape[0], bool)
    bmin, bmax = node_bounds(port.nodes.numpy())
    return (random_rays if kind == "random" else shadow_rays)(bmin, bmax, 2048, seed=13)


@pytest.mark.parametrize("kind", KINDS)
def test_wide_walk_plain_matches_jax_kernel(pair, kind):
    jax_scene, port = pair
    o, d, t0, mask = _rays(kind, port)
    args = [torch.from_numpy(x) for x in (o, d, t0, mask)]
    jargs = [jnp.asarray(x) for x in (o, d, t0)]
    want = jax_wide.traverse(jax_scene.packed_wide, jax_scene.tris, *jargs,
                             mask=jnp.asarray(mask), interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in wide_bvh.closest_hit_wide_plain(port, *args).items()}
    same = assert_hits_agree(got, want, port.pool.numpy(), o, d)
    hit = same & (got["tri_idx"] >= 0)
    assert hit.any()
    for key in ("obj_id", "mat_id"):
        np.testing.assert_array_equal(got[key][same], want[key][same])
    np.testing.assert_allclose(got["u"][hit], want["bary"][hit, 0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got["v"][hit], want["bary"][hit, 1], atol=2e-5, rtol=1e-4)
    assert (got["slot"][~mask] == -1).all() and (got["traversed"][~mask] == 0).all()
    assert (got["traversed"][mask] >= 1).all()

    want_any = jax_wide.traverse(jax_scene.packed_wide, jax_scene.tris, *jargs,
                                 mask=jnp.asarray(mask), any_hit=True, interpret=True)
    got_any = wide_bvh.occluded_wide_plain(port, *args).numpy()
    np.testing.assert_array_equal(got_any, np.asarray(want_any["tri_idx"]) >= 0)
    np.testing.assert_array_equal(got_any, got["slot"] >= 0)


@pytest.mark.parametrize("kind", KINDS)
def test_wide_hits_equal_binary_bvh(kind):
    """One walk per ray over 8-wide nodes finds the same triangles at the
    same t as the binary walk over the same leaves and slots."""
    port, _ = compile_scene(BENCH_XML, wide=True, device="cpu")
    o, d, t0, mask = _rays(kind, port)
    args = [torch.from_numpy(x) for x in (o, d, t0, mask)]
    want = {k: v.numpy() for k, v in closest_hit.closest_hit_plain(port, *args).items()}
    got = {k: v.numpy() for k, v in wide_bvh.closest_hit_wide_plain(port, *args).items()}
    same = assert_hits_agree(got, want, port.pool.numpy(), o, d, atol=0.0, rtol=0.0)
    assert (got["tri_idx"] >= 0).any()
    for key in ("u", "v", "obj_id", "mat_id"):
        np.testing.assert_array_equal(got[key][same], want[key][same], err_msg=key)
    np.testing.assert_array_equal(wide_bvh.occluded_wide_plain(port, *args).numpy(),
                                  got["slot"] >= 0)


def test_forest_roots_seed_the_stack():
    """A wide pack of several roots walks every tree: the first root starts
    the walk, the others wait on the stack as mask-0 words.  Two copies of
    the binary forest under two roots give the single-root hits."""
    port, _ = compile_scene(BENCH_XML, wide=True, device="cpu")
    o, d, t0, mask = (torch.from_numpy(x) for x in _rays("random", port))
    want = wide_bvh.closest_hit_wide_plain(port, o, d, t0, mask)
    # a second root: wide node 0 again, so each ray walks the tree twice
    port.wide_roots = torch.tensor([0, 0], dtype=torch.int32)
    got = wide_bvh.closest_hit_wide_plain(port, o, d, t0, mask)
    for key in ("t", "slot", "tri_idx"):
        assert torch.equal(got[key], want[key]), key
    live = mask & (want["traversed"] > 0)
    assert bool((got["traversed"][live] > want["traversed"][live]).all())


def _counting(mp, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    mp.setattr(module, name, counted)
    return calls


def test_bounce_keeps_the_kernels_and_sends_host_queries_wide():
    port, _ = compile_scene(BENCH_XML, wide="bounce", device="cpu")
    assert port.walk == "wide" and port.stack_kernels
    cam = cam_mod.make_camera(24, 16, **BENCH_CAMERA)
    with pytest.MonkeyPatch.context() as mp:
        k3 = _counting(mp, wavefront_pt, "trace_plain")
        k4 = _counting(mp, whitted_wf, "trace_level0_plain")
        wide_hit = _counting(mp, wide_bvh, "closest_hit_wide_plain")
        wide_any = _counting(mp, wide_bvh, "occluded_wide_plain")
        binary = _counting(mp, query, "closest_hit") + _counting(mp, query, "occluded")
        pathtracer.render_pass(port, cam, 1)  # depth 0 in the kernel, the rest host
        assert len(k3) == 1 and len(wide_hit) >= 1
        whitted.render(port, cam)  # every level in the level kernel
        assert len(k4) >= 1
        whitted.render(port, cam, level_kernel=False)
        assert len(wide_any) >= 1
        assert not binary  # host queries never take the binary walk


def test_wide_only_refuses_kernel_routes():
    port, _ = compile_scene(CUBE_XML, wide=True, device="cpu")
    cam = cam_mod.make_camera(8, 6)
    with pytest.raises(ValueError, match="wavefront_depths=6"):
        pathtracer.render_pass(port, cam, 1, wavefront_depths=6)
    with pytest.raises(ValueError, match="level_kernel=True"):
        whitted.radiance(port, *cam_mod.full_frame_rays(cam, device="cpu"), level_kernel=True)
    img, stats = pathtracer.render_pass(port, cam, 1)
    assert stats["rays_traced"] > 0 and bool(torch.isfinite(img).all())


def test_wide_wrappers_take_plain_version_on_cpu():
    port, _ = compile_scene(CUBE_XML, wide=True, device="cpu")
    o, d, t0, mask = (torch.from_numpy(x) for x in _rays("shadow", port))
    a = wide_bvh.closest_hit_wide(port, o, d, t0, mask)
    b = wide_bvh.closest_hit_wide_plain(port, o, d, t0, mask)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(wide_bvh.occluded_wide(port, o, d, t0, mask),
                       wide_bvh.occluded_wide_plain(port, o, d, t0, mask))
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wide_bvh.occluded_wide(port, meta, meta, torch.zeros(4, device="meta"))
    bvh, _ = compile_scene(CUBE_XML, device="cpu")
    for fn in (wide_bvh.closest_hit_wide, wide_bvh.occluded_wide):
        with pytest.raises(ValueError, match="no wide tables"):
            fn(bvh, o, d, t0)


def _comb(levels: int):
    """A spine of `levels` binary nodes, each with a small interior subtree
    (an interior node over two leaves, a smaller box) beside the next
    spine node, ending in an interior node over two leaves: a wide node
    opens 7 spine levels and keeps 8 interior children, so a walk down the
    spine leaves 7 node ids per wide level on the stack, about one per
    spine level.  Arguments of `wide.pack_wide`."""
    n = 4 * levels + 3
    left, right = np.full(n, -1, np.int32), np.full(n, -1, np.int32)
    count = np.zeros(n, np.int32)
    lo, hi = np.zeros((n, 3), np.float32), np.ones((n, 3), np.float32)
    for i in range(levels):
        spine, small = 4 * i, 4 * i + 1
        left[spine], right[spine] = small, 4 * (i + 1)
        left[small], right[small] = small + 1, small + 2
        count[small + 1] = count[small + 2] = 1
        hi[small:small + 3] = 0.5
    last = 4 * levels
    left[last], right[last] = last + 1, last + 2
    count[last + 1] = count[last + 2] = 1
    return lo, hi, left, right, count, 0, np.arange(n), count, True


def test_wide_stack_capacity_is_checked_at_pack_time():
    """A tree whose pending interior children would overrun the wide
    stack is refused when packed, never overrun in the walk."""
    packed = wide.pack_wide(*_comb(64))
    assert 56 <= packed.stack <= 70
    with pytest.raises(ValueError, match="capacity"):
        wide.pack_wide(*_comb(wide.WIDE_STACK_CAP + 16))
