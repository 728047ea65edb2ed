"""The port's reference walks (`ops/traverse_bvh.py`, `ops/traverse_grid.py`,
`ops/traverse_kd.py`, `ops/forest.py`) against the JAX package's XLA walks
(`cpu_ray_tracer_tpu/ops/traverse_*.py`, `ops/forest.py`) on the JAX
package's own tables, carried over by `scene/convert.reference_tables`,
and the same rays, made with numpy from a seed.

* Triangle soups (as `tests/test_bvh.py` and `tests/test_grid_kd.py` make
  them): random rays through them, rays starting inside the grid, rays
  with t0 cuts, and axis-aligned rays (direction components exactly 0,
  where the slab tests and the DDA meet infinities and NaN); the grid and
  KD forests over the soup cut into three instances; and a `max_steps`
  small enough to bind.
* 64x40 camera rays on `bunny_teapot.xml` through the JAX package's
  `use_pallas=False` scenes: the TLAS BVH, grid forest and KD forest and
  the mono grid and KD tree.

Closest and any hit.  `tri_idx`, `obj_id`, `mat_id`, `traversed` and
`tested` equal, `t` and the barycentrics within atol=2e-5, rtol=1e-4
(XLA fuses multiply-adds where the port rounds each operation, so the
floats differ in their last bits).  A different id must be a tie (both
triangles hits at one t), and a different counter must be on a ray whose
float32 walk the float64 walk over the same tables does not reproduce
(fp-borderline); the test prints how many there are.  The intersection
tests, `ray_octants` and `interpolate_hit` are held to the JAX
package's too.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu import constants
from cpu_ray_tracer_tpu.accel import compile as jcompile, grid_builder as jgrid_b
from cpu_ray_tracer_tpu.accel import kdtree_builder as jkd_b
from cpu_ray_tracer_tpu.ops import forest as jforest, intersect as jintersect
from cpu_ray_tracer_tpu.ops import traverse_bvh as jbvh, traverse_grid as jgrid, traverse_kd as jkd
from cpu_ray_tracer_tpu.scene import query as jquery
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import intersect, traverse_bvh
from cpu_ray_tracer_tpu_torch.scene.convert import reference_tables
from torch_parity import BENCH_CAMERA, BENCH_XML, jax_compile_reference, jax_walk_arrays
from torch_rays import assert_hits_agree

JAX_WALKS = dict(bvh=jbvh.traverse, grid=jgrid.traverse, kdtree=jkd.traverse)
RAY_FAR = np.float32(constants.RAY_FAR)


def _soup(n=300, spread=4.0, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    return (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)


def _jax_structs(accel: str, tri_v: np.ndarray, parts: int = 1):
    """The JAX package's structure over tri_v, or with `parts` > 1 a tuple
    of grids or KD trees over consecutive slices (global triangle ids)."""
    if accel == "bvh":
        return jcompile.compile_bvh(tri_v, force_split_cap=None)[0]
    builder = jgrid_b if accel == "grid" else jkd_b
    out, base = [], 0
    for v in np.array_split(tri_v, parts):
        host, _ = builder.build_grid(v) if accel == "grid" else builder.build_kdtree(v)
        key = "cell_tris" if accel == "grid" else "tri_ids"
        host[key] = host[key] + base
        out.append(builder.to_device(host))
        base += v.shape[0]
    return tuple(out) if parts > 1 else out[0]


def _jax_walk(accel, structs, pool, o, d, t0, any_hit, max_steps=None):
    o, d, t0 = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0)
    if isinstance(structs, tuple):
        return jforest.traverse_forest(JAX_WALKS[accel], structs, pool, o, d, t0, any_hit=any_hit)
    return JAX_WALKS[accel](structs, pool, o, d, t0, any_hit=any_hit, max_steps=max_steps)


def _port_walk(tables, o, d, t0, any_hit, max_steps=None):
    """The port's walk of `tables` (ReferenceTables), or with `max_steps`
    the one walk of its first structure."""
    o, d, t0 = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t0)
    if tables.tris.rows.dtype == torch.float64:
        o, d, t0 = o.double(), d.double(), t0.double()
    if max_steps is None:
        return tables.walk(o, d, t0, any_hit)
    from cpu_ray_tracer_tpu_torch.ops import traverse_grid, traverse_kd

    fn = dict(bvh=traverse_bvh.traverse, grid=traverse_grid.traverse,
              kdtree=traverse_kd.traverse)[tables.accel]
    return fn(tables.structs[0], tables.tris, o, d, t0, any_hit, max_steps)


def hold(tables, jres, o, d, t0, any_hit, max_steps=None, label=""):
    """The module docstring's rule for the port's walk of `tables` against
    the JAX result `jres` on rays (o, d, t0)."""
    got = {k: v.numpy() if torch.is_tensor(v) else v
           for k, v in _port_walk(tables, o, d, t0, any_hit, max_steps).items()}
    want = {k: np.asarray(v) for k, v in jres.items()}
    want["u"], want["v"] = want["bary"][:, 0], want["bary"][:, 1]
    if any_hit:
        # the first recorded hit: a hit in both where one exists
        np.testing.assert_array_equal(got["tri_idx"] >= 0, want["tri_idx"] >= 0)
        agree = got["tri_idx"] == want["tri_idx"]
        tie = np.zeros_like(agree)
    else:
        agree = assert_hits_agree(got, want, tables.tris.rows.numpy()[:, :9], o, d)
        tie = ~agree
    for k in ("obj_id", "mat_id"):
        np.testing.assert_array_equal(got[k][agree], want[k][agree])
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k][agree], want[k][agree], atol=2e-5, rtol=1e-4)
    differ = ((got["traversed"] != want["traversed"]) | (got["tested"] != want["tested"])
              | (got["tri_idx"] != want["tri_idx"]))
    n_border = 0
    if differ.any():
        t64 = copy.deepcopy(tables).double()
        w64 = {k: v.numpy() for k, v in _port_walk(t64, o, d, t0, any_hit, max_steps).items()
               if torch.is_tensor(v)}
        border = ((w64["traversed"] != got["traversed"]) | (w64["tested"] != got["tested"])
                  | (w64["tri_idx"] != got["tri_idx"]))
        unexplained = np.nonzero(differ & ~border & ~tie)[0]
        assert unexplained.size == 0, (label, unexplained[:20].tolist())
        n_border = int(differ.sum())
    print(f"{label}: {o.shape[0]} rays, {int((want['tri_idx'] >= 0).sum())} hits, "
          f"{n_border} fp-borderline rays with other ids or counters, "
          f"{got['loop_steps']} loop steps, {got['syncs']} host syncs")
    return got


# --- ray sets --------------------------------------------------------------

def _rays(kind: str, n: int, seed: int, lo=-6.0, hi=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t0 = np.full(n, RAY_FAR, np.float32)
    if kind == "inside":
        o = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    elif kind == "t0cut":
        t0 = rng.uniform(0.05, 4.0, size=n).astype(np.float32)
    elif kind == "axis":
        # one or two direction components exactly 0, origins on cell planes
        d[: n // 2, 0] = 0.0
        d[n // 4: 3 * n // 4, 2] = 0.0
        o[::3] = np.round(o[::3])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32), t0


SOUP = _soup()
SOUP_POOL = jcompile.make_triangle_pool(SOUP, obj_id=(np.arange(SOUP.shape[0]) % 5 + 2).astype(
    np.int32), mat_id=(np.arange(SOUP.shape[0]) % 3).astype(np.int32))


def _soup_tables(accel: str, parts: int = 1):
    structs = _jax_structs(accel, SOUP, parts)
    arrays, ref = jax_walk_arrays(SOUP_POOL, accel, structs)
    return structs, reference_tables(arrays, ref)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("rays", ["soup", "inside", "t0cut", "axis"])
@pytest.mark.parametrize("accel", ["bvh", "grid", "kdtree"])
def test_walk_matches_jax_on_a_soup(accel, rays, any_hit):
    structs, tables = _soup_tables(accel)
    o, d, t0 = _rays(rays, 1500, seed=("bvh", "grid", "kdtree").index(accel) * 10 + len(rays))
    jres = _jax_walk(accel, structs, SOUP_POOL, o, d, t0, any_hit)
    hold(tables, jres, o, d, t0, any_hit, label=f"{accel} {rays} any_hit={any_hit}")


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("accel", ["grid", "kdtree"])
def test_forest_matches_jax(accel, any_hit):
    """The soup cut into three instances, one grid or KD tree each,
    chained with the running t (`ops/forest.py`)."""
    structs, tables = _soup_tables(accel, parts=3)
    assert len(tables.structs) == 3
    o, d, t0 = _rays("soup", 1500, seed=7)
    jres = _jax_walk(accel, structs, SOUP_POOL, o, d, t0, any_hit)
    got = hold(tables, jres, o, d, t0, any_hit, label=f"{accel} forest any_hit={any_hit}")
    assert got["loop_steps"] > 0


@pytest.mark.parametrize("accel", ["bvh", "grid", "kdtree"])
def test_max_steps_binds_as_in_jax(accel):
    """A bound of 5 steps, below what the rays need: the walks stop after
    exactly 5 steps in both packages."""
    structs, tables = _soup_tables(accel)
    o, d, t0 = _rays("soup", 800, seed=3)
    jres = _jax_walk(accel, structs, SOUP_POOL, o, d, t0, False, max_steps=5)
    got = hold(tables, jres, o, d, t0, False, max_steps=5, label=f"{accel} max_steps=5")
    assert got["loop_steps"] == 5
    free = tables.walk(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t0), False)
    assert int(free["traversed"].sum() + free["tested"].sum()) > int(
        got["traversed"].sum() + got["tested"].sum())


# --- bunny_teapot camera rays ---------------------------------------------

@pytest.fixture(scope="module")
def camera_rays():
    cam = cam_mod.make_camera(64, 40, **BENCH_CAMERA)
    o, d = cam_mod.full_frame_rays(cam, device="cpu")
    return o.numpy(), d.numpy(), np.full(o.shape[0], RAY_FAR, np.float32)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("layout, accel", [("tlas", "bvh"), ("tlas", "grid"), ("tlas", "kdtree"),
                                           ("mono", "grid"), ("mono", "kdtree")])
def test_camera_rays_match_jax(camera_rays, layout, accel, any_hit):
    scene, _ = jax_compile_reference(BENCH_XML, layout=layout, accel=accel)
    structs = dict(bvh=scene.bvh, grid=scene.grid, kdtree=scene.kd)[accel]
    arrays, ref = jax_walk_arrays(scene.tris, accel, structs)
    tables = reference_tables(arrays, ref)
    assert len(tables.structs) == (3 if layout == "tlas" and accel != "bvh" else 1)
    o, d, t0 = camera_rays
    jres = jquery._traverse_accel(scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
                                  any_hit=any_hit)
    got = hold(tables, jres, o, d, t0, any_hit, label=f"bunny {layout} {accel} any={any_hit}")
    assert (got["tri_idx"] >= 0).sum() > 100


# --- the pieces -------------------------------------------------------------

def test_intersection_tests_match_jax():
    """`moller_trumbore` and `slab_aabb` against the JAX package's on
    random rays and triangles (with NaN directions for the slab test):
    hit flags equal away from the tests' edges, values at the
    tolerance."""
    rng = np.random.default_rng(11)
    n = 4000
    o, d, _ = _rays("soup", n, seed=11, lo=-1.0, hi=1.0)
    tri = _soup(n, spread=1.0, seed=12)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    # aim most rays near each triangle's middle, some past its edges
    aim = v0 + rng.uniform(-0.2, 0.8, size=(n, 1)) * e1 + rng.uniform(-0.2, 0.8, size=(n, 1)) * e2
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    tmax = rng.uniform(0.5, 5.0, size=n).astype(np.float32)
    jt, ju, jv, jh = (np.asarray(x) for x in jintersect.moller_trumbore(
        *(jnp.asarray(x) for x in (o, d, v0, e1, e2, tmax))))
    pt, pu, pv, ph = (x.numpy() for x in intersect.moller_trumbore(
        *(torch.from_numpy(x) for x in (o, d, v0, e1, e2, tmax))))
    edge = ((np.abs(ju) < 1e-4) | (np.abs(jv) < 1e-4) | (np.abs(ju + jv - 1) < 1e-4)
            | (np.abs(jt - tmax) < 1e-4 * tmax))
    np.testing.assert_array_equal(ph[~edge], jh[~edge])
    assert jh.sum() > 1000
    for a, b in ((pt, jt), (pu, ju), (pv, jv)):
        np.testing.assert_allclose(a[jh & ph], b[jh & ph], atol=2e-5, rtol=1e-4)

    d[::7, 1] = 0.0
    o[::14, 1] = 0.25  # on the box's plane: 0 * inf = NaN
    rd = (1.0 / d).astype(np.float32)
    bmin = np.full((n, 3), -0.25, np.float32)
    bmax = np.full((n, 3), 0.25, np.float32)
    jmin, jhit = (np.asarray(x) for x in jintersect.slab_aabb(
        *(jnp.asarray(x) for x in (o, rd, tmax, bmin, bmax))))
    pmin, phit = (x.numpy() for x in intersect.slab_aabb(
        *(torch.from_numpy(x) for x in (o, rd, tmax, bmin, bmax))))
    np.testing.assert_array_equal(phit, jhit)
    np.testing.assert_array_equal(np.isnan(pmin), np.isnan(jmin))
    assert np.isnan(pmin).any() and jhit.any()
    np.testing.assert_array_equal(pmin[~np.isnan(pmin)], jmin[~np.isnan(jmin)])


def test_octants_and_interpolate_hit_match_jax():
    o, d, _ = _rays("axis", 500, seed=5)
    np.testing.assert_array_equal(traverse_bvh.ray_octants(torch.from_numpy(d)).numpy(),
                                  np.asarray(jbvh.ray_octants(jnp.asarray(d))))
    rng = np.random.default_rng(6)
    idx = rng.integers(-1, SOUP.shape[0], size=500).astype(np.int32)
    bary = rng.uniform(0, 0.5, size=(500, 2)).astype(np.float32)
    jn, juv = jbvh.interpolate_hit(SOUP_POOL, jnp.asarray(idx), jnp.asarray(bary))
    _, tables = _soup_tables("bvh")
    pn, puv = traverse_bvh.interpolate_hit(tables.tris.shade, torch.from_numpy(idx),
                                           torch.from_numpy(bary[:, 0]),
                                           torch.from_numpy(bary[:, 1]))
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(puv.numpy(), np.asarray(juv), atol=2e-6, rtol=1e-5)
