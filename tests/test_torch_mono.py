"""`compile_scene(layout="mono")` of the port (the reference's FileScene:
every object transformed by its full T @ S, one tree over all triangles)
against the JAX package's.

* Tables: the BVH, grid and KD cell forest equal the JAX package's mono
  tables (`use_pallas=True`): node bounds, per-octant child order or
  links, leaf triangle lists in slot order, triangle and shading records.
  With `parity=True` (the reference's normals quirk, its SAH stop and
  leaves of 2), which takes the reference route as in the JAX package,
  the reference BVH equals the JAX package's parity BVH node for node
  and the normals take the quirk.

The renders over these tables are `test_torch_mono_render.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.scene import synthetic
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from conftest import OUR_ASSETS as ASSETS
from torch_parity import BENCH_XML, CUBE_XML, jax_compile

XMLS = {"cube_scene": CUBE_XML, "bunny_teapot": BENCH_XML}
ACCELS = ("bvh", "grid", "kdtree")


def _port_slots(port):
    """(triangle id of each slot, {leaf node: triangle ids in slot order})."""
    nodes = port.nodes.numpy()
    tri = port.shade.numpy().view(np.int32)[:, 15] & 0xFFFFF
    first, count = nodes[:, pack.N_FIRST], nodes[:, pack.N_COUNT]
    return tri, {int(n): tri[first[n]:first[n] + count[n]].tolist()
                 for n in np.nonzero(count > 0)[0]}


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("name", list(XMLS))
def test_mono_tables_equal_jax(name, accel):
    jax_scene, jax_info = jax_compile(XMLS[name], layout="mono", accel=accel)
    port, info = compile_scene(XMLS[name], layout="mono", accel=accel, device="cpu")
    pk = jax_scene.packed
    f = port.nodes.numpy().view(np.float32)
    aabb = np.asarray(pk.node_aabb)
    np.testing.assert_array_equal(f[:, 0:3], aabb[:3].T)
    np.testing.assert_array_equal(f[:, 3:6], aabb[3:].T)
    assert port.root == pk.root == 0 and port.roots == (0,)
    nf = port.nodes.numpy()[:, pack.N_NEARFAR:].reshape(-1, 8, 2).transpose(1, 2, 0)
    if pk.node_nearfar is None:  # one-leaf tree
        assert port.root_is_leaf and (nf == -1).all()
    else:
        np.testing.assert_array_equal(nf, np.asarray(pk.node_nearfar))
    if accel == "bvh":
        assert port.walk == "stack" and port.stack_kernels and port.links is None
    else:
        assert port.walk == "links" and not port.stack_kernels
        np.testing.assert_array_equal(port.links.numpy().reshape(-1, 8, 2).transpose(1, 2, 0),
                                      np.asarray(pk.node_links))
    slot_tri = np.asarray(pk.slot_tri)
    start, nrows = np.asarray(pk.node_meta2)
    want = {}
    for n in np.nonzero(nrows > 0)[0]:
        ids = slot_tri[start[n] * 8:(start[n] + nrows[n]) * 8]
        want[int(n)] = ids[ids >= 0].tolist()
    tri, leaves = _port_slots(port)
    assert leaves == want
    valid = slot_tri >= 0
    rows = np.asarray(pk.tri_rows).reshape(-1, 16)[valid]
    np.testing.assert_array_equal(port.tris.numpy(), rows[:, :9])
    if accel == "bvh":  # the JAX package packs no shading rows for cell forests
        shade = np.asarray(pk.tri_shade_rows).reshape(-1, 16)[valid]
        np.testing.assert_array_equal(port.shade.numpy()[:, :15], shade[:, :15])
    assert info.triangle_count == int(jax_scene.tris.v0.shape[0])
    assert info.blas_stats == []
    for key in ("max_depth", "num_nodes", "num_leaves", "max_leaf"):
        assert getattr(info.build_stats, key) == getattr(jax_info.build_stats, key), key
    assert info.max_tree_depth == jax_info.max_tree_depth


@pytest.mark.parametrize("name", list(XMLS))
def test_parity_bvh_and_normals_equal_jax(name):
    """`parity=True`: the JAX package builds its reference tree (no SAH
    fallback, leaves of 2) for its XLA route; the port takes its reference
    route over the same tree, and the normals take the rotation-transpose
    quirk."""
    jax_scene, jax_info = jax_compile(XMLS[name], layout="mono", parity=True)
    port, info = compile_scene(XMLS[name], layout="mono", parity=True, device="cpu")
    assert port.walk == "reference"
    bvh, ours = jax_scene.bvh, port.reference.structs[0]
    np.testing.assert_array_equal(ours.box.numpy()[:, 0:3], np.asarray(bvh.node_min))
    np.testing.assert_array_equal(ours.box.numpy()[:, 3:6], np.asarray(bvh.node_max))
    np.testing.assert_array_equal(ours.leaf.numpy(), np.stack(
        [np.asarray(bvh.left_first), np.asarray(bvh.tri_count)], axis=1))
    np.testing.assert_array_equal(ours.tri_indices.numpy(), np.asarray(bvh.tri_indices))
    np.testing.assert_array_equal(ours.links.numpy()[:, 0], np.asarray(bvh.hit_link).reshape(-1))
    assert ours.max_leaf == bvh.max_leaf == info.build_stats.max_leaf
    assert info.build_stats.max_depth == jax_info.build_stats.max_depth
    assert info.build_stats.num_nodes == jax_info.build_stats.num_nodes
    normals = np.concatenate([np.asarray(getattr(jax_scene.tris, k)) for k in ("n0", "n1", "n2")],
                             axis=1)
    np.testing.assert_array_equal(port.shade.numpy()[:, :9], normals)
    # the quirk moves the normals of a rotated object
    default, _ = compile_scene(XMLS[name], layout="mono", use_pallas=False, device="cpu")
    assert not np.array_equal(port.shade.numpy()[:, :9], default.shade.numpy()[:, :9])


@pytest.mark.parametrize("accel", ["grid", "kdtree"])
def test_parity_cell_forest_differs_only_in_normals(accel):
    """The grid and KD builds take no BVH options: under `parity=True` the
    reference route's grid or KD tree is the one `use_pallas=False`
    builds, the normals the quirk's."""
    a, _ = compile_scene(BENCH_XML, layout="mono", accel=accel, use_pallas=False, device="cpu")
    b, _ = compile_scene(BENCH_XML, layout="mono", accel=accel, parity=True, device="cpu")
    for (key, x), (_, y) in zip(a.reference.named_buffers(), b.reference.named_buffers()):
        if not key.endswith("shade"):
            assert torch.equal(x, y), key
    assert torch.equal(a.shade[:, 9:], b.shade[:, 9:])
    assert not torch.equal(a.shade[:, :9], b.shade[:, :9])


def test_force_split_cap_reaches_the_builder(tmp_path):
    """`force_split_cap=None` keeps a leaf the SAH cannot split (600
    coincident triangles, `scene/synthetic.big_leaf_xml`); the default cap
    halves it at the median until no leaf passes the leaf size of 24, as
    the JAX package's builder does."""
    xml = synthetic.big_leaf_xml(str(tmp_path), ASSETS)
    for cap in (None, 4):
        _, info = compile_scene(xml, layout="mono", force_split_cap=cap, device="cpu")
        _, jax_info = jax_compile(xml, layout="mono", force_split_cap=cap)
        assert dataclasses.astuple(info.build_stats)[1:] == \
            dataclasses.astuple(jax_info.build_stats)[1:]  # all but the build time
        assert (info.build_stats.max_leaf == 600) == (cap is None)
        assert info.build_stats.max_leaf <= 24 or cap is None


def test_unknown_layout_is_refused():
    with pytest.raises(ValueError, match="layout"):
        compile_scene(CUBE_XML, layout="flat", device="cpu")
