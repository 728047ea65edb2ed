"""Binary BVHs deeper than the stack walk held, in both packages.

The JAX package walks a BVH with its stack up to `STACK_CAP` = 128 levels
(ops/pallas/packet_bvh.py:114, gate :830-843) and by its hit/miss links
beyond that: `packet_bvh._kernel` for the host queries and
`traverse_links` (ops/pallas/ptraverse.py:243) inside the wavefront and
Whitted kernels (gates wavefront_pt.py:563-568, whitted_wf.py:380).  The
port's stack walk holds 128 entries too (`accel/pack.STACK_CAP`), and a
deeper BVH is threaded at pack time and walked by links: the link walk for
the host queries (`DeviceScene.walk` "links"), the link branch of the
wavefront and Whitted kernels (`DeviceScene.stack_walk` False).

The tree is built by hand (`scene/synthetic.caterpillar`): spine node i
has the next spine node as its near child (split axis z, rays towards +z)
and a small interior subtree of two one-triangle leaves as its far child,
every box the whole scene's, so that a ray visits every node and the stack
walk pushes a far child at each spine level: more than 64 entries at 100
levels (both packages' stack walks) and a link walk at 140 (both
packages' link walks).  Both packages pack the same arrays (JAX: `pack_host` +
`attach_stack_tables`; the port: `scene_from_arrays` and `pack.pack_bvh`,
which agree table for table).  Closest hit, any hit, the wavefront kernel
at k = 2 and the Whitted level are held to the JAX kernels in interpret
mode: ids, flags and counts exact, floats at the parity tolerance
(atol=2e-5, rtol=1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.ops.pallas import packet_bvh
from cpu_ray_tracer_tpu.ops.pallas import wavefront_pt as jax_wf
from cpu_ray_tracer_tpu.ops.pallas import whitted_wf as jax_wwf
from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import intersect, wavefront_pt, whitted_wf
from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit_plain, occluded_plain
from cpu_ray_tracer_tpu_torch.ops.link_walk import closest_hit_links_plain, occluded_links_plain
from cpu_ray_tracer_tpu_torch.render import pathtracer
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from cpu_ray_tracer_tpu_torch.scene.synthetic import caterpillar, flat_shading
from torch_parity import jax_scene_arrays, jax_scene_over

W, H, DEPTH = 32, 20, 5
TOL = dict(atol=2e-5, rtol=1e-4)
LEVEL_KEYS = ("t", "irr_scale", "r_dir", "t_dir", "fr")
LEVEL_EXACT = ("miss", "lit", "surf", "vis", "emit1", "emit2", "mat", "tex_idx")


@pytest.fixture(scope="module", params=[100, 140], ids=["stack_100", "links_140"])
def scenes(request):
    """The JAX scene (the cube scene's materials, light and textures over
    the caterpillar) and the port's, carried over from it."""
    host = caterpillar(request.param)
    n = host["tri_v"].shape[0]
    ids = np.full(n, 2, np.int32)
    jax_scene = jax_scene_over(host, flat_shading(host["tri_v"]), ids, ids)
    port = scene_from_arrays(*jax_scene_arrays(jax_scene))
    return request.param, host, jax_scene, port


def test_both_packages_gate_the_walk_alike(scenes):
    levels, host, jax_scene, port = scenes
    depth = levels + 2
    assert jax_scene.packed.stack_depth == port.depth == depth > 64 + 2
    deep = depth > pack.STACK_CAP
    assert port.stack_walk == (not deep) and port.stack_kernels
    assert port.walk == ("links" if deep else "stack")
    assert (port.links is not None) == deep
    # the port's own pack of the same host arrays gives the same tables
    own = pack.pack_bvh(
        host["node_min"], host["node_max"], host["left"], host["right"], host["axis"],
        host["left_first"], host["tri_count"], host["tri_indices"], host["tri_v"],
        flat_shading(host["tri_v"]), np.full(host["tri_v"].shape[0], 2, np.int32),
        np.full(host["tri_v"].shape[0], 2, np.int32), root=0,
    )
    assert own.depth == depth and own.stack == (not deep)
    for name in ("nodes", "node_records", "tris4", "links", "link_records"):
        got, want = getattr(own, name), getattr(port, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
    if deep:
        # the links the port threads are the JAX package's
        links = port.links.numpy().reshape(-1, 8, 2).transpose(1, 2, 0)  # [8, 2, M]
        np.testing.assert_array_equal(links, np.asarray(jax_scene.packed.node_links))


def _primary(port):
    cam = cam_mod.make_camera(W, H)
    o, d, seeds = pathtracer.camera_rays(cam, 1, "cpu")
    t0, _ = intersect.primitive_hits(port, o, d)
    return o, d, t0, seeds


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_walks_match_jax_kernels(scenes, any_hit):
    levels, _, jax_scene, port = scenes
    o, d, t0, _ = _primary(port)
    want = packet_bvh.traverse(
        jax_scene.packed, jax_scene.tris, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(t0.numpy()), any_hit=any_hit, interpret=True,
    )
    want = {k: np.asarray(v) for k, v in want.items()}
    stack = levels + 2 <= pack.STACK_CAP
    if any_hit:
        fn = occluded_plain if stack else occluded_links_plain
        got = fn(port, o, d, t0).numpy()
        np.testing.assert_array_equal(got, want["tri_idx"] >= 0)
        assert got.any() and not got.all()
        return
    fn = closest_hit_plain if stack else closest_hit_links_plain
    got = {k: v.numpy() for k, v in fn(port, o, d, t0).items()}
    for key in ("tri_idx", "obj_id", "mat_id"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["t"], want["t"], **TOL)
    np.testing.assert_allclose(np.stack([got["u"], got["v"]], 1), want["bary"], **TOL)
    hit = got["tri_idx"] >= 0
    assert hit.any() and not hit.all()
    # every hit ray visited the whole tree: 4L + 1 nodes by links, the
    # spine and side subtrees' 2L interior steps by the stack
    steps = 4 * levels + 1 if not stack else 2 * levels
    assert (got["traversed"][hit] == steps).all()


def test_wavefront_matches_jax_kernel(scenes):
    _, _, jax_scene, port = scenes
    o, d, _, seeds = _primary(port)
    k = 2
    want = jax_wf.trace(
        jax_scene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(seeds.numpy().astype(np.uint32)), k, DEPTH, interpret=True,
    )
    want = {key: np.asarray(v) for key, v in want.items()}
    got = {key: v.numpy() for key, v in wavefront_pt.trace(port, o, d, seeds, k, DEPTH).items()}
    np.testing.assert_array_equal(got["live_counts"], want["live_counts"])
    for key in ("missed", "lit", "alive", "inside"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # texel indices exact but where a bounce ray's floor point sits on a
    # texel edge: there the point, equal at the parity tolerance, truncates
    # to the next texel in x or y (at most 1% of the entries)
    tex_w = int(port.mat_tex_w[1])
    apart = got["tex_idx"] != want["tex_idx"]
    step = np.abs(got["tex_idx"] - want["tex_idx"])[apart]
    assert apart.sum() <= 0.01 * apart.size and np.isin(step, (1, tex_w)).all()
    assert (got["tex_idx"][apart] >= 0).all() and (want["tex_idx"][apart] >= 0).all()
    # the JAX packing pads every leaf's one triangle to a row of 8 slots
    jax_slot = np.nonzero(np.asarray(jax_scene.packed.slot_tri) >= 0)[0]
    locus = np.where(got["locus"] >= 0, jax_slot[np.maximum(got["locus"], 0)], -1)
    np.testing.assert_array_equal(locus, want["locus"])
    for key in ("tp", "o", "d"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    alive = got["alive"]
    np.testing.assert_array_equal(got["seed"][alive], want["seed"][alive].astype(np.int64))
    assert got["live_counts"][1] > 0 and (got["locus"] >= 0).any()


def test_whitted_level_matches_jax_kernel(scenes):
    _, _, jax_scene, port = scenes
    o, d, _, _ = _primary(port)
    inside = torch.zeros(o.shape[0], dtype=torch.bool)
    want = jax_wwf.trace_level0(jax_scene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                jnp.asarray(inside.numpy()), interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in whitted_wf.trace_level0(port, o, d, inside).items()}
    for key in LEVEL_EXACT:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in LEVEL_KEYS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert got["surf"].any() and got["vis"].any() and not got["vis"].all()
