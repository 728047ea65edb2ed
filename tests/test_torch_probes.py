"""The port's probe kernels' plain versions against the JAX package's TPU
probes: the leaf tests per ray (K6, `make_vpu_kernel`) and as a matrix
product (K7, `make_mxu_kernel(m)`) of `benchmarks/mxu_probe.py`, and the
node-step walk (K8, `make_kernel(variant)`) of `benchmarks/sync_probe.py`,
each run in its own `pl.pallas_call(..., interpret=True)` with the probe's
block specs at 2 tiles, on the same inputs.

K8's outputs are small integers in float32 (or 1e30) and must be equal,
on the camera's rays and on NaN-case rays (`sync_probe.nan_rays`).
K6 and K7 are compared at rtol 1e-5; a ray beyond that passes only if a
float64 evaluation explains it (`leaf_tolerance.explained`): moving each
candidate's a, u*a, v*a, t*a by 1e-5 of its magnitude (the sum of its
absolute terms) can flip an acceptance or let another candidate reach the
least t, or both outputs are the float64 winner's within those moves.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cpu_ray_tracer_tpu_torch.benchmarks import leaf_tolerance, mxu_probe
from cpu_ray_tracer_tpu_torch.benchmarks import sync_probe as sync_bench
from cpu_ray_tracer_tpu_torch.ops import leaf_probe, sync_probe
from cpu_ray_tracer_tpu_torch.scene.build import tlas_node_tables
from torch_parity import BENCH_XML, jax_compile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES = 2
RTOL = TOL = 1e-5


def _jax_probe(name: str):
    """A JAX probe module of `benchmarks/` (no package there), by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def leaf_inputs():
    return mxu_probe.inputs(TILES, "cpu")


def _unexplained(got, want, quantities, positions, with_uv):
    """`leaf_tolerance.disagreements` of the port's output and the JAX
    probe's; `positions(p)` maps flat positions of `got` to the rays
    `quantities` takes."""
    want = torch.from_numpy(np.array(want))
    return leaf_tolerance.disagreements(got, want, lambda p: quantities(positions(p)), with_uv,
                                    RTOL, TOL)


def test_vpu_plain_matches_jax_probe(leaf_inputs):
    mod = _jax_probe("mxu_probe")
    tile_spec = pl.BlockSpec((1, *mod.TS), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    tris, comps = leaf_inputs["tris"], leaf_inputs["comps"]
    want = pl.pallas_call(
        mod.make_vpu_kernel(), grid=(TILES,),
        out_shape=jax.ShapeDtypeStruct((TILES, *mod.TS), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] + [tile_spec] * 6,
        out_specs=tile_spec, interpret=True,
    )(jnp.asarray(tris.numpy()), *(jnp.asarray(c.numpy()) for c in comps))
    got = leaf_probe.vpu_leaf(tris, *comps)
    assert got.shape == (TILES, 32, 128) and got.dtype == torch.float32
    hits = got < 1e29
    assert 0.5 < float(hits.float().mean()) < 1.0  # hits and misses both
    beyond, bad = _unexplained(
        got, want, lambda r: leaf_tolerance.vpu_quantities(tris, comps, r), lambda p: p,
        with_uv=True)
    print(f"K6: {beyond.numel()} rays beyond rtol {RTOL}, {bad.numel()} not borderline")
    assert bad.numel() == 0, bad.tolist()


@pytest.mark.parametrize("m", leaf_probe.WIDTHS)
def test_mxu_plain_matches_jax_probe(leaf_inputs, m):
    mod = _jax_probe("mxu_probe")
    c_tab, phi = leaf_inputs["per_m"][m]
    want = pl.pallas_call(
        mod.make_mxu_kernel(m), grid=(TILES,),
        out_shape=jax.ShapeDtypeStruct((TILES, 1, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 16, mod.TILE), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(c_tab.numpy()), jnp.asarray(phi.numpy()))
    full = leaf_probe.mxu_leaf(c_tab, phi, m)
    assert full.shape == (TILES, leaf_probe.TILE)
    got = mxu_probe.mxu(leaf_inputs, m)
    assert torch.equal(got, full[:, None, :128])
    assert bool((got < 1e29).any())
    beyond, bad = _unexplained(
        got, want, lambda r: leaf_tolerance.mxu_quantities(c_tab, phi, m, r),
        lambda p: (p // 128) * leaf_probe.TILE + p % 128, with_uv=False)
    print(f"K7 m={m}: {beyond.numel()} rays beyond rtol {RTOL}, {bad.numel()} not borderline")
    assert bad.numel() == 0, bad.tolist()


def test_packed_c_gives_each_lane_one_triangle():
    """The kernel's fragment reads of the packed C: in pair P (block P %
    a_blocks(m)), register r of lane 4g + q of warp w holds row g + 8 (r &
    1), column 8 ks + q + 4 (r >> 1) of its warp's slice of accumulator h,
    which must be quantity 2h + (r & 1) (a, u*a; v*a, t*a) of triangle
    slot 32P + 8w + g: triangle slot % m of group (slot // m) % 4, the
    probe's flush slot // m."""
    for m in leaf_probe.WIDTHS:
        c = torch.arange(16 * m * 16, dtype=torch.float32).reshape(16 * m, 16)
        packed = leaf_probe.pack_c(c, m).reshape(leaf_probe.a_blocks(m), 2, 2, 4, 8, 4, 4)
        for pair in range(leaf_probe.PAIRS):
            block = packed[pair % leaf_probe.a_blocks(m)]
            for h in range(2):
                for w in range(4):
                    for g in range(8):
                        slot = 32 * pair + 8 * w + g
                        group, tri = (slot // m) % 4, slot % m
                        for r in range(4):
                            row = group * 4 * m + (2 * h + (r & 1)) * m + tri
                            for ks in range(2):
                                cols = 8 * ks + torch.arange(4) + 4 * (r >> 1)
                                assert torch.equal(block[h, ks, w, g, :, r], c[row, cols])


def test_uncertain_flags_near_decisions_only():
    """One ray, candidates given by (a, u*a, v*a, t*a): clear hits and
    misses are certain; a barycentric or a t at its threshold, or two
    candidates at nearly the same t, are not."""
    def one(*cands):
        q = torch.tensor(cands, dtype=torch.float64).T[:, :, None]  # [4, K, 1]
        return bool(leaf_tolerance.uncertain(q, q.abs() + 1.0, 1e-5)[0])

    assert not one((2.0, 0.5, 0.5, 4.0))  # u = v = 0.25, t = 2
    assert not one((2.0, 0.5, 0.5, 4.0), (2.0, 0.5, 0.5, 8.0))  # the nearer wins clearly
    assert not one((2.0, 3.0, 0.5, 4.0))  # u = 1.5: a clear miss
    assert one((2.0, 0.0, 0.5, 4.0))  # u at 0
    assert one((2.0, 1.0, 1.0, 4.0))  # u + v at 1
    assert one((2.0, 0.5, 0.5, 4.0), (2.0, 0.5, 0.5, 4.00001))  # a near tie


def test_explained_allows_an_ill_conditioned_t_of_a_certain_hit():
    """A certain hit whose t*a is a small difference of large terms: its t
    may move by the bound of t*a's error over a, and no further; a wrong
    slot or a miss is not explained."""
    q = torch.tensor([[4.0, 1.0, 1.0, 0.004], [4.0, 3.0, 0.5, 8.0]], dtype=torch.float64)
    q = q.T[:, :, None]  # two candidates, one ray: slot 0 hits at t = 0.001
    scale = torch.full_like(q, 10.0)  # t*a may move by 1e-4: t by about 2.5e-5

    def ok(out):
        return bool(leaf_tolerance.explained([torch.tensor([out])], q, scale, 1e-5, False)[0])

    assert ok(0.001) and ok(0.00102) and ok(0.00098)
    assert not ok(0.0011) and not ok(1.001) and not ok(1e30)


@pytest.fixture(scope="module")
def jax_tables():
    scene, _ = jax_compile(BENCH_XML)
    return np.asarray(scene.packed.node_aabb), np.asarray(scene.packed.node_links)


def test_node_tables_equal_jax(jax_tables):
    aabb, links = tlas_node_tables(BENCH_XML)
    j_aabb, j_links = jax_tables
    assert aabb.dtype == np.float32 and links.dtype == np.int32
    np.testing.assert_array_equal(aabb, j_aabb)
    np.testing.assert_array_equal(links, j_links)
    assert aabb.shape == (6, 1333) and links.shape == (8, 2, 1333)
    # the probe's octant-0 links, as its entry point builds them
    inp = sync_bench.inputs(1, "cpu")
    np.testing.assert_array_equal(inp["links"].numpy(), j_links[0])
    np.testing.assert_array_equal(inp["aabb"].numpy(), j_aabb)


@pytest.fixture(scope="module")
def sync_inputs():
    """Two tiles from the middle of the frame, where rays hit the scene."""
    inp = sync_bench.inputs(sync_bench.N_TILES, "cpu")
    inp["comps"] = [c[110:110 + TILES].contiguous() for c in inp["comps"]]
    return inp


def _jax_node_walk(aabb, links, comps, variant: str):
    """The JAX probe's kernel in interpret mode on `TILES` tiles: aabb
    [6, M], links [8, 2, M] (the probe reads octant 0), comps six numpy
    arrays [TILES, 32, 128]."""
    mod = _jax_probe("sync_probe")
    tile_spec = pl.BlockSpec((1, *mod.TILE_SHAPE), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    smem_spec = pl.BlockSpec(memory_space=pltpu.SMEM)
    return np.asarray(pl.pallas_call(
        mod.make_kernel(variant), grid=(TILES,),
        out_shape=jax.ShapeDtypeStruct((TILES, *mod.TILE_SHAPE), jnp.float32),
        in_specs=[smem_spec, smem_spec] + [tile_spec] * 6, out_specs=tile_spec,
        scratch_shapes=[pltpu.SMEM((128,), jnp.int32)], interpret=True,
    )(jnp.asarray(aabb), jnp.asarray(links), *(jnp.asarray(c) for c in comps)))


@pytest.mark.parametrize("variant", sync_probe.VARIANTS)
def test_node_walk_plain_matches_jax_probe(jax_tables, sync_inputs, variant):
    j_aabb, j_links = jax_tables
    want = _jax_node_walk(j_aabb, j_links, [c.numpy() for c in sync_inputs["comps"]], variant)
    got = sync_bench.run(sync_inputs, variant)
    np.testing.assert_array_equal(got.numpy(), want)
    if variant[0] == "F":
        # timing shapes: t never moves off 1e30, which swamps acc + cur + sp
        assert bool((got == np.float32(1e30)).all())
    elif variant != "A":
        assert float(got.max()) > 100.0  # the middle tiles' rays hit boxes


@pytest.mark.parametrize("variant", ("B", "C", "E8"))
def test_node_walk_plain_matches_jax_probe_on_nan_rays(sync_inputs, variant, monkeypatch):
    """`sync_probe.nan_rays`: origins on slab planes with a zero direction
    component, some boxes flattened, so that NaN bounds decide the walk."""
    nan_in = sync_bench.nan_rays(sync_inputs, TILES)
    aabb, links, comps = nan_in["aabb"], nan_in["links"], nan_in["comps"]
    j_links = np.zeros((8, *links.shape), np.int32)
    j_links[0] = links.numpy()
    want = _jax_node_walk(aabb.numpy(), j_links, [c.numpy() for c in comps], variant)
    got = sync_bench.run(nan_in, variant)
    np.testing.assert_array_equal(got.numpy(), want)
    # the NaN rule decides here: min / max that drop NaN give another walk
    monkeypatch.setattr(torch, "minimum", torch.fmin)
    monkeypatch.setattr(torch, "maximum", torch.fmax)
    assert int((sync_probe.node_walk_plain(aabb, links, comps, variant) != got).sum()) > 100


def test_node_walk_refuses_small_tables(sync_inputs):
    aabb, links = sync_inputs["aabb"][:, :1000], sync_inputs["links"][:, :1000]
    for variant in ("A", "E8"):
        with pytest.raises(ValueError, match="at least 1024"):
            sync_probe.node_walk(aabb, links, sync_inputs["comps"], variant)
    with pytest.raises(ValueError, match="variant"):
        sync_probe.node_walk(sync_inputs["aabb"], sync_inputs["links"], sync_inputs["comps"], "G")


def test_probe_wrappers_reject_other_devices():
    tris = torch.zeros((64, 128), device="meta")
    comps = [torch.zeros((1, 32, 128), device="meta")] * 6
    aabb, links = torch.zeros((6, 1100), device="meta"), torch.zeros((2, 1100), device="meta")
    for call in (lambda: leaf_probe.vpu_leaf(tris, *comps),
                 lambda: leaf_probe.mxu_leaf(torch.zeros((128, 16), device="meta"),
                                             torch.zeros((1, 16, 4096), device="meta"), 8),
                 lambda: sync_probe.node_walk(aabb, links, comps, "C")):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_probe_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mxu_probe.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sync_bench.main()
