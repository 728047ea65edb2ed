"""The inputs and arithmetic of the Hopper forms of the design probes, on
the CPU: K6's packed triangles and its division-free test (a float32
mirror of `vpu_leaf_kernel` in `csrc/leaf_probe.cu`, held to the plain
version by the float64 rule of `benchmarks/leaf_tolerance.py`), and K8's
node records and NaN-case rays (on which `tests/test_torch_probes.py`
holds the plain walk to the JAX probe).
"""

import pytest
import torch

from cpu_ray_tracer_tpu_torch.benchmarks import leaf_tolerance, mxu_probe
from cpu_ray_tracer_tpu_torch.benchmarks import sync_probe as sync_bench
from cpu_ray_tracer_tpu_torch.ops import leaf_probe, sync_probe

TILES = 2


@pytest.fixture(scope="module")
def leaf_inputs():
    return mxu_probe.inputs(TILES, "cpu")


def test_pack_vpu_keeps_vertices_and_adds_the_normal(leaf_inputs):
    tris = leaf_inputs["tris"]
    packed = leaf_probe.pack_vpu(tris)
    rec = tris.reshape(-1, leaf_probe.RECORD)
    assert packed.shape == (512, leaf_probe.VPU_FLOATS) and packed.dtype == torch.float32
    assert torch.equal(leaf_inputs["vpu_packed"], packed)
    for i, cols in enumerate((slice(0, 3), slice(4, 7), slice(8, 11))):  # v0, e1, e2
        assert torch.equal(packed[:, cols], rec[:, 3 * i:3 * i + 3])
    e1, e2 = rec[:, 3:6], rec[:, 6:9]
    n = packed[:, [3, 7, 11]]
    # n = e1 x e2, each component one float32 product difference
    assert torch.equal(n[:, 0], e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1])
    assert torch.equal(n[:, 1], e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2])
    assert torch.equal(n[:, 2], e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    cross = torch.linalg.cross(e1.double(), e2.double())
    assert torch.allclose(n.double(), cross, rtol=1e-5, atol=1e-5)
    v0 = rec[:, 0:3]
    assert torch.equal(packed[:, 12], v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2])
    assert not packed[:, 13:].any()


def _flip(x, sign):
    return (x.view(torch.int32) ^ sign).view(torch.float32)


def vpu_mirror(packed, comps) -> torch.Tensor:
    """K6's arithmetic in float32 on the CPU, triangle by triangle over all
    rays (the kernel's FMAs as a product and a sum, rounded twice): m = o x d
    per ray, the four quantities from the packed normal and v0 . n, a's sign
    folded into the others, the division-free accept in slot order (the
    kernel's rounds take k, then k + 1), t = T / |a| on an accept and u, v
    divided out at the end."""
    ox, oy, oz, dx, dy, dz = (c.reshape(-1) for c in comps)
    mx, my, mz = oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx
    n = ox.numel()
    t = torch.full((n,), 1e30)
    ua, va, aa_best = torch.zeros(n), torch.zeros(n), torch.ones(n)
    slot = torch.full((n,), -1, dtype=torch.int32)
    sign_bit = torch.tensor(-0x80000000, dtype=torch.int32)
    for k in range(packed.shape[0]):
        v0x, v0y, v0z, nx, e1x, e1y, e1z, ny, e2x, e2y, e2z, nz, w = packed[k, :13].unbind(0)
        cx = -v0y * dz + (v0z * dy + mx)
        cy = -v0z * dx + (v0x * dz + my)
        cz = -v0x * dy + (v0y * dx + mz)
        a = -dz * nz + (-dy * ny + -dx * nx)
        u_a = e2z * cz + (e2y * cy + e2x * cx)
        v_a = -e1z * cz + (-e1y * cy + -e1x * cx)
        t_a = oz * nz + (oy * ny + (ox * nx - w))
        sign = a.view(torch.int32) & sign_bit
        aa, u, v, tt = a.abs(), _flip(u_a, sign), _flip(v_a, sign), _flip(t_a, sign)
        ok = ((aa >= 1e-4) & (u >= 0.0) & (v >= 0.0) & (u + v <= aa) & (tt > 1e-4 * aa)
              & (tt < t * aa))
        t = torch.where(ok, tt / aa, t)
        ua, va = torch.where(ok, u, ua), torch.where(ok, v, va)
        aa_best = torch.where(ok, aa, aa_best)
        slot = torch.where(ok, k, slot)
    hit = slot >= 0
    u = torch.where(hit, ua / aa_best, 0.0)
    v = torch.where(hit, va / aa_best, 0.0)
    return (t + u + v + slot.to(torch.float32)).reshape(comps[0].shape)


def test_division_free_leaf_test_holds_to_the_plain_version(leaf_inputs):
    """The kernel's form is not bit-equal to the probe's arithmetic; every
    ray beyond rtol 1e-5 must be one the float64 evaluation explains."""
    tris, comps = leaf_inputs["tris"], leaf_inputs["comps"]
    got = vpu_mirror(leaf_probe.pack_vpu(tris), comps)
    want = leaf_probe.vpu_leaf_plain(tris, *comps)
    hits = want < 1e29
    assert 0.5 < float(hits.float().mean()) < 1.0
    assert torch.equal(got < 1e29, hits)
    beyond, bad = leaf_tolerance.disagreements(
        got, want, lambda r: leaf_tolerance.vpu_quantities(tris, comps, r), with_uv=True)
    print(f"K6 mirror: {int((got != want).sum())} of {got.numel()} rays not bit-equal, "
          f"{beyond.numel()} beyond rtol 1e-5, {bad.numel()} unexplained")
    assert bad.numel() == 0, bad.tolist()
    assert bool((got != want).any())  # a different arithmetic, not a copy


def test_leaf_rule_catches_a_wrong_sign_fold(leaf_inputs):
    """The same mirror with u*a's sign left unfolded accepts wrong
    triangles: the rule must not explain that away."""
    tris, comps = leaf_inputs["tris"], leaf_inputs["comps"]
    packed = leaf_probe.pack_vpu(tris)
    broken = packed.clone()
    broken[:, 8:11] = -broken[:, 8:11]  # e2 negated: u*a with the wrong sign
    got = vpu_mirror(broken, comps)
    want = leaf_probe.vpu_leaf_plain(tris, *comps)
    _, bad = leaf_tolerance.disagreements(
        got, want, lambda r: leaf_tolerance.vpu_quantities(tris, comps, r), with_uv=True)
    assert bad.numel() > 100


@pytest.fixture(scope="module")
def sync_inputs():
    return sync_bench.inputs(1, "cpu")


def test_node_records_equal_the_tables(sync_inputs):
    aabb, links = sync_inputs["aabb"], sync_inputs["links"]
    rec = sync_probe.node_records(aabb, links)
    assert rec.shape == (aabb.shape[1], 8) and rec.dtype == torch.int32
    assert rec.is_contiguous() and torch.equal(sync_inputs["records"], rec)
    assert torch.equal(rec[:, :6].contiguous().view(torch.float32), aabb.t())
    assert torch.equal(rec[:, 6], links[0]) and torch.equal(rec[:, 7], links[1])
    with pytest.raises(ValueError, match="at least 1024"):
        sync_probe.node_records(aabb[:, :1000], links[:, :1000])


@pytest.fixture(scope="module")
def nan_inputs(sync_inputs):
    return sync_bench.nan_rays(sync_inputs, TILES)


def test_nan_rays_start_on_slab_planes(sync_inputs, nan_inputs):
    """Every ray has a zero direction component and its origin on a slab
    plane of some node on that axis; the flattened boxes lie on their min
    plane, and only they changed."""
    aabb = nan_inputs["aabb"]
    o = torch.stack([c.reshape(-1) for c in nan_inputs["comps"][:3]])
    d = torch.stack([c.reshape(-1) for c in nan_inputs["comps"][3:]])
    zero = d == 0.0
    assert bool((zero.sum(0) >= 1).all())
    planes = torch.cat([aabb[:3], aabb[3:]], dim=1)  # [3, 2M]
    for axis in range(3):
        rows = zero[axis]
        assert bool(torch.isin(o[axis, rows], planes[axis]).all())
    flat = (aabb[:3] == aabb[3:]).any(0)
    changed = (aabb != sync_inputs["aabb"]).any(0)
    assert int(flat.sum()) > 10 and torch.equal(flat, changed)
    assert torch.equal(nan_inputs["records"], sync_probe.node_records(aabb, nan_inputs["links"]))
