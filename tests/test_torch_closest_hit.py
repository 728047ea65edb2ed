"""`closest_hit_plain` (the CUDA kernel's plain PyTorch version) against the
JAX package's packet kernel `packet_bvh.traverse` in interpret mode, on the
same tables (`scene_from_arrays`) and the same numpy-made rays.

t, u and v agree at the JAX package's parity tolerance (atol=2e-5,
rtol=1e-4).  Hit ids agree except at ties: the strict `tt < t` keeps the
first-tested of equal hits, and the port walks each ray in its own octant
order where the TPU kernel takes the tile's majority octant, so on a shared
edge the two may keep different triangles at the same t.  The JAX
counters are per-tile unions (packet_bvh.py:864-868) and are not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.ops.pallas import packet_bvh
from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import intersect
from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit, closest_hit_plain
from cpu_ray_tracer_tpu_torch.render import pathtracer
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, OUR_ASSETS, jax_compile, jax_scene_arrays,
)
from torch_rays import axis_aligned_rays, flat_quads_xml, in_plane_rays, node_bounds, random_rays

XMLS = {"cube_scene": CUBE_XML, "bunny_teapot": BENCH_XML}


@pytest.fixture(scope="module")
def flat_xml(tmp_path_factory):
    return flat_quads_xml(str(tmp_path_factory.mktemp("flat")), OUR_ASSETS)


@pytest.fixture(scope="module", params=[*XMLS, "flat_quads"])
def scenes(request, flat_xml):
    jax_scene, _ = jax_compile(XMLS.get(request.param, flat_xml))
    return jax_scene, scene_from_arrays(*jax_scene_arrays(jax_scene))


def _rays(kind, port):
    if kind == "primary":
        cam = cam_mod.make_camera(64, 40, **BENCH_CAMERA)
        o, d, _ = pathtracer.camera_rays(cam, 2)
        t0, _ = intersect.primitive_hits(port, o, d)
        return o.numpy(), d.numpy(), t0.numpy(), np.ones(o.shape[0], bool)
    bmin, bmax = node_bounds(port.nodes.numpy())
    if kind == "random":
        return random_rays(bmin, bmax, 2048, seed=1)
    return axis_aligned_rays(bmin, bmax, 1024, seed=2)


def _mt64(pool, tri, o, d):
    """Moller-Trumbore in float64 of rays against pool triangles: (t, u, v)
    and a first-order bound of the float32 rounding error of u and v: a few
    roundings of each operand, amplified by 1/det (large for slivers and
    near-tangent rays)."""
    v0, e1, e2 = (pool[tri, 3 * k : 3 * k + 3].astype(np.float64) for k in range(3))
    o, d = o.astype(np.float64), d.astype(np.float64)
    h = np.cross(d, e2)
    f = 1.0 / np.einsum("ij,ij->i", e1, h)
    s = o - v0
    q = np.cross(s, e1)
    u, v = f * np.einsum("ij,ij->i", s, h), f * np.einsum("ij,ij->i", d, q)
    n = lambda x: np.linalg.norm(x, axis=-1)  # noqa: E731
    scale = (n(o) + n(v0)) * n(d) * (n(e1) + n(e2)) * (1.0 + np.abs(u) + np.abs(v))
    err = 8 * 2.0**-24 * np.abs(f) * scale
    return f * np.einsum("ij,ij->i", e2, q), u, v, err


def _nan_on_path(port, tri, o, d) -> bool:
    """Whether the ray's own slab test is NaN at a node on the path from
    the root's children down to the leaf holding pool triangle `tri`."""
    nodes = port.nodes.numpy()
    meta = port.shade.numpy().view(np.int32)[:, 15] & 0xFFFFF
    slot = int(np.nonzero(meta == tri)[0][0])
    first, count = nodes[:, pack.N_FIRST], nodes[:, pack.N_COUNT]
    node = int(np.nonzero((count > 0) & (first <= slot) & (slot < first + count))[0][0])
    parent = {}
    for n in np.nonzero(count == 0)[0]:
        for c in nodes[n, pack.N_NEARFAR : pack.N_NEARFAR + 2]:
            parent[int(c)] = int(n)
    bounds = nodes[:, 0:6].view(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        rd = np.float32(1.0) / d
        while node != port.root or port.root_is_leaf:
            t = np.concatenate([(bounds[node, 0:3] - o) * rd, (bounds[node, 3:6] - o) * rd])
            if np.isnan(t).any():
                return True
            if node == port.root:
                break
            node = parent[node]
    return False


@pytest.mark.parametrize("kind", ["primary", "random", "axis_aligned"])
def test_plain_matches_jax_packet_kernel(scenes, kind):
    jax_scene, port = scenes
    o, d, t0, mask = _rays(kind, port)
    want = packet_bvh.traverse(
        jax_scene.packed, jax_scene.tris, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
        mask=jnp.asarray(mask), interpret=True,
    )
    want = {k: np.asarray(v) for k, v in want.items()}
    got = closest_hit_plain(
        port, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t0), torch.from_numpy(mask)
    )
    got = {k: v.numpy() for k, v in got.items()}

    # The packet kernel tests a leaf's triangles for every live ray of its
    # tile once ANY ray hit the leaf's box, so a ray can be handed a hit its
    # own walk excludes: with an origin on a slab plane and a zero direction
    # component, (plane - o) * inf is NaN and the ray's own slab test fails
    # (packet_bvh.py:572-589, kept by the port).  Only such rays may differ.
    apart = ~np.isclose(got["t"], want["t"], atol=2e-5, rtol=1e-4)
    for i in np.nonzero(apart)[0]:
        assert want["t"][i] < got["t"][i], i
        assert _nan_on_path(port, want["tri_idx"][i], o[i], d[i]), i
    if kind != "axis_aligned":
        assert not apart.any()
    keep = ~apart
    o, d, t0, mask = o[keep], d[keep], t0[keep], mask[keep]
    got = {k: v[keep] for k, v in got.items()}
    want = {k: v[keep] for k, v in want.items()}
    # (the cube's only box has every axis-aligned ray on a slab plane)
    assert (got["tri_idx"] >= 0).any() or (kind == "axis_aligned" and port.root_is_leaf)
    differ = got["tri_idx"] != want["tri_idx"]
    # ids equal wherever t differs by more than 1e-6 relative ...
    far_apart = np.abs(got["t"] - want["t"]) > 1e-6 * np.abs(want["t"])
    assert not (differ & far_apart).any()
    # ... and where the triangles differ, both are hits of the ray at that t
    # (a tie on a shared edge or vertex)
    tie = np.nonzero(differ)[0]
    if tie.size:
        assert (got["tri_idx"][tie] >= 0).all() and (want["tri_idx"][tie] >= 0).all()
        pool = port.pool.numpy()
        for ids in (got["tri_idx"][tie], want["tri_idx"][tie]):
            t, u, v, _ = _mt64(pool, ids, o[tie], d[tie])
            np.testing.assert_allclose(t, got["t"][tie], rtol=1e-5)
            assert ((u > -1e-5) & (v > -1e-5) & (u + v < 1 + 1e-5)).all()
    same = ~differ
    for key in ("obj_id", "mat_id"):
        np.testing.assert_array_equal(got[key][same], want[key][same])
    hit = same & (got["tri_idx"] >= 0)
    assert (got["u"][~hit & same] == 0).all() and (got["v"][~hit & same] == 0).all()
    # Barycentrics of the same hit.  A ray through a triangle's vertex or
    # along an edge's line (the axis-aligned set makes them) is
    # ill-conditioned in u, v, and there XLA on the CPU evaluates `uu` in
    # separate fusions with different multiply-add contraction (it can even
    # leave u != 0 on a miss); there the port must agree with a float64
    # evaluation of the same hit instead.
    _, u64, v64, err = _mt64(port.pool.numpy(), got["tri_idx"][hit], o[hit], d[hit])
    for key, j, ref in (("u", 0, u64), ("v", 1, v64)):
        near_jax = np.isclose(got[key][hit], want["bary"][hit, j], atol=2e-5, rtol=1e-4)
        near_f64 = np.abs(got[key][hit] - ref) <= 2e-5 + 1e-4 * np.abs(ref) + err
        assert (near_jax | near_f64).all(), key
        if kind != "axis_aligned":
            assert near_jax.all(), key
    # dead rays do nothing
    dead = ~mask
    np.testing.assert_array_equal(got["t"][dead], t0[dead])
    assert (got["slot"][dead] == -1).all()
    assert (got["traversed"][dead] == 0).all() and (got["tested"][dead] == 0).all()
    if not port.root_is_leaf:
        assert (got["traversed"][mask] >= 1).all()


def test_rays_in_a_flat_leafs_plane_enter_no_leaf(flat_xml):
    """The NaN rule, where it decides: a ray with d.y == 0 in the plane of a
    leaf box of zero height meets NaN on both y slabs and must not enter the
    leaf (a NaN-dropping min/max would let it in and test the quad)."""
    port, _ = compile_scene(flat_xml)
    o, d, t0, mask = (torch.from_numpy(x) for x in in_plane_rays(256, seed=5))
    got = closest_hit_plain(port, o, d, t0, mask)
    assert (got["traversed"] >= 1).all()
    assert (got["tested"] == 0).all() and (got["tri_idx"] == -1).all()


def test_wrapper_takes_plain_version_on_cpu(scenes):
    _, port = scenes
    o, d, t0, mask = (torch.from_numpy(x) for x in _rays("random", port))
    a = closest_hit(port, o, d, t0, mask)
    b = closest_hit_plain(port, o, d, t0, mask)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_wrapper_rejects_other_devices(scenes):
    _, port = scenes
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        closest_hit(port, o, o, torch.zeros(4, device="meta"))
