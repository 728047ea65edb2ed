"""Shared-BLAS instancing (`compile_scene(instancing="shared")`) of the
PyTorch port against the JAX package's (`tests/test_instancing.py`):

* the tables: each unique mesh's BVH and leaf triangle lists, the
  instance tables and the pool equal the JAX package's, and the scene
  carried across with `scene_from_arrays` equals the port's own compile;
* `find_nearest` and `is_occluded` against the JAX package's (its packet
  kernel in interpret mode, one masked pass per instance) on three
  instances of one mesh and on eight instances of two meshes: ids equal
  up to ties, t at the parity tolerance (atol=2e-5, rtol=1e-4);
* shared against the port's own baked scene, within the measured
  fp-flip budget of `tests/test_instancing.py`, every t beyond tolerance
  explained by the TRI_EPS cutoff in unscaled object space;
* normals of a non-uniformly scaled instance are of unit length;
* a Whitted frame and a path-tracer pass against the JAX package's at
  32x20, images at the parity tolerance except fp-borderline pixels;
* `find_nearest_diff`'s gradients against `jax.grad` (the rule of
  `tests/torch_grads.py`);
* a unique mesh deeper than the stack walk's STACK_CAP takes the link
  walk, and its hits equal a brute-force float64 search.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu import constants as jax_constants
from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.io.scene_xml import load_scene_xml as jax_load
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu.scene import query as jax_query
from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.io.scene_xml import load_scene_xml
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import query, synthetic
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene, instance_matrices
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_grads import assert_grad_close
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env, jax_scene_arrays,
)

DEPTH = 5


def dup_spec(load, xml=CUBE_XML, n_copies=3, offset=(1.5, 0.0, 0.0)):
    """The spec of `xml` (by `load`, either package's parser) with its first
    object repeated at shifted positions: N instances of one mesh (the
    JAX package's tests/test_instancing.py:26)."""
    spec = load(xml)
    base = spec.objects[0]
    for c in range(1, n_copies):
        o = copy.deepcopy(base)
        o.position = base.position + np.asarray(offset, np.float32) * c
        spec.objects.append(o)
    return spec


def bench_spec(load):
    """bunny_teapot's two meshes, four instances each (the JAX package's
    test_bench_scale_multi_mesh)."""
    spec = load(BENCH_XML)
    bunny, teapot = spec.objects[0], spec.objects[1]
    spec.objects = []
    for i in range(4):
        for base, dz in ((bunny, 0.0), (teapot, 0.9)):
            o = copy.deepcopy(base)
            o.position = base.position + np.asarray([1.1 * (i - 1.5), 0.0, dz], np.float32)
            spec.objects.append(o)
    return spec


SPECS = {
    # (spec maker, width, height, camera)
    "cube_x3": (dup_spec, 24, 16, {}),
    "bench_x8": (bench_spec, 32, 20, {}),
}


@pytest.fixture(scope="module", params=list(SPECS))
def pair(request):
    make, w, h, cam = SPECS[request.param]
    jax_scene, jax_info = jax_compile(None, spec=make(jax_load), instancing="shared")
    port, info = compile_scene(spec=make(load_scene_xml), instancing="shared", device="cpu")
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(w, h, **cam), device="cpu")
    return request.param, jax_scene, jax_info, port, info, o, d


def _jax_leaf_lists(pk):
    """{leaf node: pool triangle ids in slot order} of a JAX pack without
    shading rows (`slot_tri`, -1 on padding slots)."""
    slot_tri = np.asarray(pk.slot_tri)
    start, nrows = np.asarray(pk.node_meta2)
    out = {}
    for n in np.nonzero(nrows > 0)[0]:
        ids = slot_tri[start[n] * 8 : (start[n] + nrows[n]) * 8]
        out[int(n)] = ids[ids >= 0].tolist()
    return out


def _port_leaf_lists(mesh):
    nodes = mesh.nodes.numpy()
    meta = mesh.shade.numpy().view(np.int32)[:, 15]
    first, count = nodes[:, pack.N_FIRST], nodes[:, pack.N_COUNT]
    return {int(n): (meta[first[n] : first[n] + count[n]] & 0xFFFFF).tolist()
            for n in np.nonzero(count > 0)[0]}


def test_tables_equal_jax(pair):
    _, jax_scene, jax_info, port, info, _, _ = pair
    jsh, sh = jax_scene.shared, port.shared
    assert port.walk == "instanced" and not port.stack_kernels
    assert sh.inst_mesh == jsh.inst_mesh and sh.mesh_bounds == jsh.mesh_bounds
    assert len(sh.meshes) == len(jsh.packs) == len(set(sh.inst_mesh))
    for k in ("inst_minv", "inst_nrm", "inst_aabb_min", "inst_aabb_max", "inst_obj", "inst_mat"):
        np.testing.assert_array_equal(getattr(sh, k).numpy(), np.asarray(getattr(jsh, k)), err_msg=k)
    for mesh, pk in zip(sh.meshes, jsh.packs):
        f = mesh.nodes.numpy().view(np.float32)
        aabb = np.asarray(pk.node_aabb)
        np.testing.assert_array_equal(f[:, 0:3], aabb[:3].T)
        np.testing.assert_array_equal(f[:, 3:6], aabb[3:].T)
        assert _port_leaf_lists(mesh) == _jax_leaf_lists(pk)
        assert mesh.depth == (pk.stack_depth or 1) and mesh.walk == "stack"
    pool = port.pool.numpy()
    tris = jax_scene.tris
    np.testing.assert_array_equal(pool, np.concatenate([tris.v0, tris.e1, tris.e2], axis=1))
    # the pool holds each unique mesh once; the counts cover every instance
    assert info.triangle_count == jax_info.triangle_count > pool.shape[0]
    carried = scene_from_arrays(*jax_scene_arrays(jax_scene))
    want, got = port.state_dict(), carried.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if g.dtype == torch.float32:  # kernel_params bit-casts ints (NaN patterns)
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), k


def _object_rays(port, obj, o, d):
    """Rays (float64) in the object space of the instance of each object
    id `obj` (numpy)."""
    minv = port.shared.inst_minv.numpy().astype(np.float64)[obj - 2]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    return (np.einsum("rij,rj->ri", minv[:, :3, :3], o64) + minv[:, :3, 3],
            np.einsum("rij,rj->ri", minv[:, :3, :3], d64))


def _assert_hits_agree(port, got, want, o, d):
    """Object ids equal, t at the parity tolerance, and triangle ids equal
    except at ties: t within 1e-6 relative and both triangles hits of the
    ray at that t in their instance's object space (float64)."""
    np.testing.assert_array_equal(got["obj_idx"], want["obj_idx"])
    np.testing.assert_allclose(got["t"], want["t"], atol=2e-5, rtol=1e-4)
    tie = np.nonzero(got["tri_idx"] != want["tri_idx"])[0]
    np.testing.assert_allclose(got["t"][tie], want["t"][tie], rtol=1e-6)
    pool = port.pool.numpy().astype(np.float64)
    for ids in (got["tri_idx"][tie], want["tri_idx"][tie]):
        oo, dd = _object_rays(port, got["obj_idx"][tie], o[tie], d[tie])
        v0, e1, e2 = (pool[ids, 3 * k : 3 * k + 3] for k in range(3))
        h = np.cross(dd, e2)
        f = 1.0 / (e1 * h).sum(-1)
        s, q = oo - v0, np.cross(oo - v0, e1)
        u, v, t = f * (s * h).sum(-1), f * (dd * q).sum(-1), f * (e2 * q).sum(-1)
        np.testing.assert_allclose(t, got["t"][tie], rtol=1e-5)
        assert ((u > -1e-5) & (v > -1e-5) & (u + v < 1 + 1e-5)).all()
    return tie.size


def test_queries_match_jax(pair):
    name, jax_scene, _, port, _, o, d = pair
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    want = {k: np.asarray(v) for k, v in jax_query.find_nearest(jax_scene, jo, jd).items()}
    got = {k: v.numpy() for k, v in query.find_nearest(port, o, d).items()}
    ties = _assert_hits_agree(port, got, want, o.numpy(), d.numpy())
    hits = got["tri_idx"] >= 0
    assert hits.sum() > 20 and len(set(got["obj_idx"][hits])) >= 2
    print(f"{name}: {int(hits.sum())} triangle hits, ties {ties}")
    dist = np.full(o.shape[0], 10.0, np.float32)
    occ_want = np.asarray(jax_query.is_occluded(jax_scene, jo, jd, jnp.asarray(dist)))
    occ_got = query.is_occluded(port, o, d, torch.from_numpy(dist)).numpy()
    np.testing.assert_array_equal(occ_got, occ_want)
    # a mask limits the any hit to its rays
    mask = torch.from_numpy(np.arange(o.shape[0]) % 2 == 0)
    masked = query.triangle_occluded(port, o, d, torch.full((o.shape[0],), 1e34), mask).numpy()
    assert not masked[~mask.numpy()].any()
    assert (masked[mask.numpy()] == (got["tri_idx"] >= 0)[mask.numpy()]).all()


def test_shared_matches_baked(pair):
    """Shared against the port's baked scene of the same spec, as the JAX
    package's test_bench_scale_multi_mesh holds its own: object ids
    within twice the baked scene's measured fp-flip rate (an eps nudge of
    the origins) plus two rays; every t beyond (1e-4, 1e-4) a hit of real
    geometry whose world |det| is under TRI_EPS (Moller-Trumbore runs in
    unscaled object space, `scene/types.py` SharedInstances)."""
    name, _, _, shared, _, o, d = pair
    make = SPECS[name][0]
    baked, _ = compile_scene(spec=make(load_scene_xml), device="cpu")
    a = query.find_nearest(shared, o, d)
    b = query.find_nearest(baked, o, d)
    nudged = query.find_nearest(baked, o + d * 1e-5, d)
    flip = (b["obj_idx"] != nudged["obj_idx"]) | (b["tri_idx"] != nudged["tri_idx"])
    n = o.shape[0]
    budget = 2.0 * float(flip.float().mean()) + 2.0 / n
    obj_a, obj_b = a["obj_idx"].numpy(), b["obj_idx"].numpy()
    assert (obj_a != obj_b).mean() <= budget
    both = (obj_a == obj_b) & (obj_a >= 2)
    assert both.sum() > 20
    t_a, t_b = a["t"].numpy(), b["t"].numpy()
    viol = np.nonzero(both & ~np.isclose(t_a, t_b, rtol=1e-4, atol=1e-4))[0]
    assert len(viol) <= max(2, int(budget * both.sum()) + 1)
    pool = baked.pool.numpy().astype(np.float64)
    v0, e1, e2 = pool[:, 0:3], pool[:, 3:6], pool[:, 6:9]
    for i in viol:
        o1, d1 = o[i].numpy().astype(np.float64), d[i].numpy().astype(np.float64)
        h = np.cross(d1[None], e2)
        det = (e1 * h).sum(-1)
        f = 1.0 / np.where(np.abs(det) < 1e-30, 1e-30, det)
        s = o1[None] - v0
        u, q = f * (s * h).sum(-1), np.cross(s, e1)
        v, t = f * (d1[None] * q).sum(-1), f * (e2 * q).sum(-1)
        near = (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (
            np.abs(t - t_a[i]) <= 1e-3 * max(t_a[i], 1.0))
        assert near.any() and (np.abs(det[near]) < jax_constants.TRI_EPS).any(), i
    print(f"{name}: obj disagreements {int((obj_a != obj_b).sum())} (budget {budget * n:.1f} rays), "
          f"t beyond tolerance {len(viol)}")


def test_nonuniform_scale_normals():
    spec = dup_spec(load_scene_xml, n_copies=1)
    spec.objects[0].scale = np.asarray([1.0, 0.25, 1.0], np.float32)
    scene, _ = compile_scene(spec=spec, instancing="shared", device="cpu")
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(32, 20), device="cpu")
    hit = query.find_nearest(scene, o, d)
    normal, _, _ = query.get_hit_info(scene, hit, o + hit["t"][:, None] * d, d)
    n = normal[hit["obj_idx"] >= 2]
    assert n.shape[0] > 0
    torch.testing.assert_close(torch.linalg.vector_norm(n, dim=-1), torch.ones(n.shape[0]),
                               atol=1e-4, rtol=0)
    # the normal matrix is the inverse-transpose of the linear part
    m, _, nrm = instance_matrices(spec.objects[0])
    np.testing.assert_allclose(nrm.T @ m[:3, :3], np.eye(3), atol=1e-6)


@pytest.mark.parametrize("case", ["whitted-bunny_teapot", "pathtracer-cube_x3"])
def test_render_matches_jax(case):
    kind, name = case.split("-")
    if name == "cube_x3":
        jax_scene, _ = jax_compile(None, spec=dup_spec(jax_load), instancing="shared")
        cam = {}
    else:
        jax_scene, _ = jax_compile(BENCH_XML, instancing="shared")
        cam = BENCH_CAMERA
    port = scene_from_arrays(*jax_scene_arrays(jax_scene))
    camera = cam_mod.make_camera(32, 20, **cam)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WHITTED_WF", "0")
        jcam = jax_cam.make_camera(32, 20, **cam)
        if kind == "whitted":
            ref = np.asarray(jax_whitted.render(jax_scene, jcam, depth_limit=DEPTH)["image"])
        else:
            ref, stats = jax_pt.render_pass(jax_scene, jcam, jnp.uint32(1))
            ref, rays = np.asarray(ref), int(stats["rays_traced"])
    if kind == "whitted":
        img = whitted.render(port, camera, DEPTH)["image"]
        radiance = lambda o, d, _: whitted.radiance(port, o, d, DEPTH)[0]  # noqa: E731
        ray_set = (*cam_mod.full_frame_rays(camera, device="cpu"), None)
    else:
        img, st = pathtracer.render_pass(port, camera, 1)
        assert st["rays_traced"] == rays
        radiance = lambda o, d, s: pathtracer.sample_radiance(port, o, d, s)[0]  # noqa: E731
        ray_set = pathtracer.camera_rays(camera, 1, "cpu")
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    cmp = borderline.unexplained_pixels(radiance, ray_set, img, torch.from_numpy(ref.copy()))
    print(f"{case}: pixels beyond tolerance {cmp['bad'].numel()}, all fp-borderline")
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


def test_find_nearest_diff_grads_match_jax(rng):
    """Gradients of a random weighting of t, u, v of two instances of the
    cube with respect to the rays and the object-space pool, against
    `jax.grad` of the JAX package's `find_nearest_diff` (the counterpart
    of test_instancing.py::test_diff_grad_flows)."""
    jax_scene, _ = jax_compile(None, spec=dup_spec(jax_load, n_copies=2), instancing="shared")
    scene = scene_from_arrays(*jax_scene_arrays(jax_scene))
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(16, 10), device="cpu")
    w = rng.standard_normal((o.shape[0], 3)).astype(np.float32)
    tris = jax_scene.tris

    def jax_f(o, d, v0, e1, e2):
        sc = jax_scene.replace(tris=tris.replace(v0=v0, e1=e1, e2=e2))
        hit = jax_query.find_nearest_diff(sc, o, d)
        t = jnp.where(hit["obj_idx"] < 0, 0.0, hit["t"])
        return jnp.sum(w[:, 0] * t + w[:, 1] * hit["bary"][:, 0] + w[:, 2] * hit["bary"][:, 1])

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        g_j = jax.grad(jax_f, argnums=(0, 1, 2, 3, 4))(
            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), tris.v0, tris.e1, tris.e2)

    from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod

    leaves = [x.clone().requires_grad_() for x in
              (o, d, scene.pool[:, 0:3], scene.pool[:, 3:6], scene.pool[:, 6:9])]
    sc = grad_mod.apply_params(scene, dict(zip(("v0", "e1", "e2"), leaves[2:])))
    hit = query.find_nearest_diff(sc, leaves[0], leaves[1])
    assert int((hit["obj_idx"] >= 2).sum()) > 10 and set(hit["obj_idx"].tolist()) >= {2, 3}
    t = torch.where(hit["obj_idx"] < 0, 0.0, hit["t"])
    tw = torch.tensor(w)
    (tw[:, 0] * t + tw[:, 1] * hit["u"] + tw[:, 2] * hit["v"]).sum().backward()
    for name, leaf, want in zip(("o", "d", "v0", "e1", "e2"), leaves, g_j):
        assert bool(torch.isfinite(leaf.grad).all()) and float(leaf.grad.abs().sum()) > 0, name
        assert_grad_close(leaf.grad.numpy(), want, name)


def test_deep_mesh_takes_the_link_walk(monkeypatch):
    """Two instances of a mesh whose BVH has 140 levels (past the stack
    walk's STACK_CAP): the mesh is threaded with links, each instance pass
    takes the link walk, and the hits equal a brute-force float64 search
    over both instances' world-space triangles."""
    host = synthetic.caterpillar(140)
    tri_v = host["tri_v"]
    n = tri_v.shape[0]
    spec = dup_spec(load_scene_xml, n_copies=2, offset=(0.7, 0.3, 0.5))
    spec.objects[1].rotation = np.asarray([0.0, 20.0, 5.0], np.float32)
    scene = synthetic.shared_scene_over(compile_scene(CUBE_XML, device="cpu")[0], host, spec)
    mesh = scene.shared.meshes[0]
    assert mesh.depth > pack.STACK_CAP and mesh.walk == "links"
    calls = []
    link_walk = query.closest_hit_links
    monkeypatch.setattr(query, "closest_hit_links",
                        lambda *a: calls.append(1) or link_walk(*a))
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(32, 20), device="cpu")
    got = query.triangle_hit(scene, o, d, torch.full((o.shape[0],), 1e34))
    assert len(calls) == 2
    # brute force in float64 over both instances in world space
    mats = [instance_matrices(obj)[0].astype(np.float64) for obj in spec.objects]
    world = [tri_v.astype(np.float64) @ m[:3, :3].T + m[:3, 3] for m in mats]
    wv = np.concatenate(world)
    wv0, we1, we2 = wv[:, 0], wv[:, 1] - wv[:, 0], wv[:, 2] - wv[:, 0]
    o64, d64 = o.numpy().astype(np.float64), d.numpy().astype(np.float64)
    h = np.cross(d64[:, None], we2[None])
    det = (we1[None] * h).sum(-1)
    f = 1.0 / det
    s = o64[:, None] - wv0[None]
    u = f * (s * h).sum(-1)
    q = np.cross(s, we1[None])
    v = f * (d64[:, None] * q).sum(-1)
    t = f * (we2[None] * q).sum(-1)
    ok = (np.abs(det) >= 1e-4) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    t_best = np.where(ok, t, np.inf).min(axis=1)
    hit = np.isfinite(t_best)
    assert hit.sum() > 20
    np.testing.assert_array_equal(got["slot"].numpy() >= 0, hit)
    np.testing.assert_allclose(got["t"].numpy()[hit], t_best[hit], rtol=1e-4, atol=2e-5)
    inst = np.where(ok, t, np.inf).argmin(axis=1) // n
    np.testing.assert_array_equal(got["obj_id"].numpy()[hit], 2 + inst[hit])

