"""The grid and KD tree of the PyTorch port against the JAX package.

* Tables: the cell forests the port compiles (`compile_scene(accel=...)`)
  equal the JAX package's (`compile_scene(use_pallas=True)`, accel/
  cell_tree.py): node bounds, children, leaf triangle lists, triangle
  records, per-octant hit/miss links and the root list.
* The link walk: `closest_hit_links_plain` / `occluded_links_plain` (the
  CUDA kernel's plain versions) against the JAX package's link walk
  `packet_bvh.traverse` in interpret mode (`_kernel`, packet_bvh.py:133),
  closest and any hit, on camera rays, rays from inside and around the
  scene with a mask, and shadow-like rays whose t0 cuts hits: t, u, v at
  the parity tolerance (atol=2e-5, rtol=1e-4), triangle, object and
  material ids exact except at ties, the any-hit booleans exact.  A
  triangle may sit in several leaves, so hits compare by triangle id, not
  slot.  The JAX counters are tile unions and are not compared.
* Interchange: the port's grid and KD hits equal its binary BVH's (t exact
  where the triangle agrees), and the JAX package's XLA DDA and KD
  descent (`use_pallas=False`) on hit t.
* Routes: the wavefront and Whitted level kernels walk the binary tables,
  so a cell forest defaults to the host route and an explicit kernel
  route raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.ops.pallas import packet_bvh
from cpu_ray_tracer_tpu.scene import query as jax_query
from cpu_ray_tracer_tpu_torch.accel import bvh_builder, cell_tree, pack
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import intersect, link_walk
from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit_plain
from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_compile_xla
from torch_rays import assert_hits_agree, node_bounds, random_rays, shadow_rays

XMLS = {"cube_scene": CUBE_XML, "bunny_teapot": BENCH_XML}
ACCELS = ("grid", "kdtree")
KINDS = ("primary", "random", "shadow")


@pytest.fixture(scope="module", params=[(a, x) for a in ACCELS for x in XMLS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    accel, name = request.param
    jax_scene, _ = jax_compile(XMLS[name], accel=accel)
    port, info = compile_scene(XMLS[name], accel=accel, device="cpu")
    return jax_scene, port, info


def _jax_leaf_lists(pk):
    """{leaf node: pool triangle ids in slot order} of the JAX packing (8
    slots per row, padding slots -1)."""
    slot_tri = np.asarray(pk.slot_tri)
    start, nrows = np.asarray(pk.node_meta2)
    out = {}
    for n in np.nonzero(nrows > 0)[0]:
        ids = slot_tri[start[n] * 8 : (start[n] + nrows[n]) * 8]
        out[int(n)] = ids[ids >= 0].tolist()
    return out


def _port_leaf_lists(scene):
    nodes = scene.nodes.numpy()
    meta = scene.shade.numpy().view(np.int32)[:, 15]
    first, count = nodes[:, pack.N_FIRST], nodes[:, pack.N_COUNT]
    return {int(n): (meta[first[n] : first[n] + count[n]] & 0xFFFFF).tolist()
            for n in np.nonzero(count > 0)[0]}


def test_cell_forest_tables_equal(pair):
    jax_scene, port, info = pair
    pk = jax_scene.packed
    assert port.walk == "links" and not port.stack_kernels
    f = port.nodes.numpy().view(np.float32)
    aabb = np.asarray(pk.node_aabb)
    np.testing.assert_array_equal(f[:, 0:3], aabb[:3].T)
    np.testing.assert_array_equal(f[:, 3:6], aabb[3:].T)
    nf = port.nodes.numpy()[:, pack.N_NEARFAR:].reshape(-1, 8, 2).transpose(1, 2, 0)
    links = port.links.numpy().reshape(-1, 8, 2).transpose(1, 2, 0)
    np.testing.assert_array_equal(links, np.asarray(pk.node_links))
    if pk.node_nearfar is None:
        # a one-leaf tree (the cube's KD tree): the JAX packer attaches no
        # child table and no root list
        assert port.root_is_leaf and (nf == -1).all() and port.roots == (pk.root,) == (0,)
        assert info.tree_depth == 1
    else:
        np.testing.assert_array_equal(nf, np.asarray(pk.node_nearfar))
        assert port.roots == tuple(pk.stack_roots) and port.root == pk.root
        # the JAX stack depth counts a forest's chained roots as extra levels
        assert info.tree_depth == pk.stack_depth - (len(port.roots) - 1)
    assert _port_leaf_lists(port) == _jax_leaf_lists(pk)
    rows = np.asarray(pk.tri_rows).reshape(-1, 16)
    np.testing.assert_array_equal(port.tris.numpy(), rows[np.asarray(pk.slot_tri) >= 0, :9])


def test_bunny_forest_sizes():
    """The main-path scene's forests: three trees each, and grid cells that
    multi-insert triangles (more slots than triangles)."""
    for accel, nodes, roots in (("grid", 5745, (0, 1737, 4392)), ("kdtree", 4131, (0, 1877, 2962))):
        port, info = compile_scene(BENCH_XML, accel=accel, device="cpu")
        assert (info.num_nodes, port.roots) == (nodes, roots), accel
        assert port.tris.shape[0] > info.triangle_count


def _rays(kind, port):
    """(o, d, t0, mask) numpy rays of one kind."""
    if kind == "primary":
        cam = cam_mod.make_camera(64, 40, **BENCH_CAMERA)
        o, d, _ = pathtracer.camera_rays(cam, 2, "cpu")
        t0, _ = intersect.primitive_hits(port, o, d)
        return o.numpy(), d.numpy(), t0.numpy(), np.ones(o.shape[0], bool)
    bmin, bmax = node_bounds(port.nodes.numpy())
    return (random_rays if kind == "random" else shadow_rays)(bmin, bmax, 2048, seed=11)


@pytest.mark.parametrize("kind", KINDS)
def test_link_walk_plain_matches_jax_kernel(pair, kind):
    jax_scene, port, _ = pair
    o, d, t0, mask = _rays(kind, port)
    args = [torch.from_numpy(x) for x in (o, d, t0, mask)]
    jargs = [jnp.asarray(x) for x in (o, d, t0)]
    want = packet_bvh.traverse(jax_scene.packed, jax_scene.tris, *jargs, mask=jnp.asarray(mask),
                               interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in link_walk.closest_hit_links_plain(port, *args).items()}
    same = assert_hits_agree(got, want, port.pool.numpy(), o, d)
    hit = same & (got["tri_idx"] >= 0)
    assert hit.any()
    for key in ("obj_id", "mat_id"):
        np.testing.assert_array_equal(got[key][same], want[key][same])
    np.testing.assert_allclose(got["u"][hit], want["bary"][hit, 0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got["v"][hit], want["bary"][hit, 1], atol=2e-5, rtol=1e-4)
    # dead rays do nothing; a live ray visits at least the first root
    assert (got["slot"][~mask] == -1).all() and (got["traversed"][~mask] == 0).all()
    assert (got["traversed"][mask] >= 1).all()

    want_any = packet_bvh.traverse(jax_scene.packed, jax_scene.tris, *jargs,
                                   mask=jnp.asarray(mask), any_hit=True, interpret=True)
    got_any = link_walk.occluded_links_plain(port, *args).numpy()
    np.testing.assert_array_equal(got_any, np.asarray(want_any["tri_idx"]) >= 0)
    np.testing.assert_array_equal(got_any, got["slot"] >= 0)  # any hit iff a closest hit


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("kind", KINDS)
def test_cell_forest_hits_equal_binary_bvh(accel, kind):
    """The accelerator interchange: the same rays find the same triangles at
    the same t through the cell forest as through the binary BVH."""
    bvh, _ = compile_scene(BENCH_XML, device="cpu")
    cells, _ = compile_scene(BENCH_XML, accel=accel, device="cpu")
    o, d, t0, mask = _rays(kind, bvh)
    args = [torch.from_numpy(x) for x in (o, d, t0, mask)]
    want = {k: v.numpy() for k, v in closest_hit_plain(bvh, *args).items()}
    got = {k: v.numpy() for k, v in link_walk.closest_hit_links_plain(cells, *args).items()}
    same = assert_hits_agree(got, want, bvh.pool.numpy(), o, d, atol=0.0, rtol=0.0)
    assert (got["tri_idx"] >= 0).any()
    for key in ("u", "v", "obj_id", "mat_id"):
        np.testing.assert_array_equal(got[key][same], want[key][same], err_msg=key)
    np.testing.assert_array_equal(link_walk.occluded_links_plain(cells, *args).numpy(),
                                  got["slot"] >= 0)


@pytest.mark.parametrize("accel", ACCELS)
def test_cell_forest_matches_jax_xla_traversal(accel):
    """Against the JAX package's reference-exact XLA traversals (the
    reference's DDA through the grid, front-to-back descent of the KD tree,
    per instance): the same rays hit, at the same t."""
    jax_scene, _ = jax_compile_xla(BENCH_XML, accel)
    port, _ = compile_scene(BENCH_XML, accel=accel, device="cpu")
    for kind in ("primary", "random"):
        o, d, t0, mask = _rays(kind, port)
        o, d, t0 = o[mask], d[mask], t0[mask]
        want = jax_query._traverse_accel(jax_scene, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(t0))
        want = {k: np.asarray(v) for k, v in want.items()}
        got = link_walk.closest_hit_links_plain(port, *(torch.from_numpy(x) for x in (o, d, t0)))
        got = {k: v.numpy() for k, v in got.items()}
        np.testing.assert_array_equal(got["tri_idx"] >= 0, want["tri_idx"] >= 0)
        assert_hits_agree(got, want, port.pool.numpy(), o, d)


def test_link_walk_wrappers_take_plain_version_on_cpu():
    port, _ = compile_scene(CUBE_XML, accel="kdtree", device="cpu")
    o, d, t0, mask = (torch.from_numpy(x) for x in _rays("random", port))
    a = link_walk.closest_hit_links(port, o, d, t0, mask)
    b = link_walk.closest_hit_links_plain(port, o, d, t0, mask)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(link_walk.occluded_links(port, o, d, t0, mask),
                       link_walk.occluded_links_plain(port, o, d, t0, mask))
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        link_walk.closest_hit_links(port, meta, meta, torch.zeros(4, device="meta"))
    bvh, _ = compile_scene(CUBE_XML, device="cpu")
    for query in (link_walk.closest_hit_links, link_walk.occluded_links):
        with pytest.raises(ValueError, match="no link table"):
            query(bvh, o, d, t0)


def test_kernel_routes_refused_on_a_cell_forest():
    """The wavefront and Whitted level kernels walk the binary stack
    tables: on a grid scene the defaults take the host route, and asking
    for a kernel route raises instead of quietly taking the host route."""
    port, _ = compile_scene(CUBE_XML, accel="grid", device="cpu")
    cam = cam_mod.make_camera(8, 6)
    with pytest.raises(ValueError, match="wavefront_depths=1"):
        pathtracer.render_pass(port, cam, 1, wavefront_depths=1)
    with pytest.raises(ValueError, match="level_kernel=True"):
        whitted.render(port, cam, level_kernel=True)
    img, stats = pathtracer.render_pass(port, cam, 1)
    assert stats["rays_traced"] > 0 and bool(torch.isfinite(img).all())
    assert whitted.render(port, cam)["rays"] > 0


def test_empty_leaf_is_refused():
    """A node with neither children nor triangles (an empty cell tree) would
    end the JAX package's link walk early; the port refuses to thread it."""
    empty = cell_tree._tree_from_grid(dict(
        resolution=(1, 1, 1), cell_start=np.zeros(2, np.int32), cell_tris=np.zeros(0, np.int32),
        bounds_min=np.zeros(3, np.float32), bounds_max=np.ones(3, np.float32)), 24)
    assert empty["tri_count"].tolist() == [0] and empty["left"].tolist() == [-1]
    with pytest.raises(ValueError, match="neither children nor triangles"):
        bvh_builder.thread_links(empty["left"], empty["right"], empty["tri_count"], empty["axis"])


def test_wide_option_only_for_bvh():
    with pytest.raises(ValueError, match="only for accel='bvh'"):
        compile_scene(CUBE_XML, accel="grid", wide=True, device="cpu")
    with pytest.raises(ValueError, match="expected 'bvh', 'grid' or 'kdtree'"):
        compile_scene(CUBE_XML, accel="octree", device="cpu")
