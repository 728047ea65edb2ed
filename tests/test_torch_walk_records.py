"""The walk records the CUDA walks read (`accel/pack.py`: `node_records`,
`link_records`, `tris4`) decode back, word for word, into the tables the
plain versions read and the JAX package's tables equal (`nodes`, `links`,
`tris`), on the binary BVH, grid and KD scenes of `bunny_teapot.xml` and
`cube_scene.xml`; fields past the old 22-bit and 9-bit leaf encoding pack
and decode the same way; and packing refuses what the records cannot
hold."""

import numpy as np
import pytest

from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import BENCH_XML, CUBE_XML

XMLS = {"cube_scene": CUBE_XML, "bunny_teapot": BENCH_XML}
ACCELS = ("bvh", "grid", "kdtree")
TABLES = {"bvh": ("node_records", "tris4"),
          "grid": ("node_records", "link_records", "tris4"),
          "kdtree": ("node_records", "link_records", "tris4")}
CASES = [(x, a, t) for x in XMLS for a in ACCELS for t in TABLES[a]]
_SCENES = {}


def _scene(xml: str, accel: str):
    if (xml, accel) not in _SCENES:
        _SCENES[xml, accel] = compile_scene(XMLS[xml], accel=accel, device="cpu")[0]
    return _SCENES[xml, accel]


def _leaf(ref: np.ndarray, t4: np.ndarray, codes: bool):
    """(first, count) of leaf refs `~code`: the code is `count <<
    LEAF_SHIFT | first` where the table's leaves fit it, else the first
    slot, and the count is word 3 of that slot's `tris4` record (the
    slots from it to the leaf's end)."""
    code = ~ref
    if codes:
        return code & ((1 << pack.LEAF_SHIFT) - 1), code >> pack.LEAF_SHIFT
    return code, t4.view(np.int32)[code, 3]


def _check_node_records(scene):
    nodes, rec, t4 = scene.nodes.numpy(), scene.node_records.numpy(), scene.tris4.numpy()
    # the in-tree scenes' leaves fit the code that carries the count
    assert scene.leaf_codes
    m = nodes.shape[0]
    assert rec.shape == (m, pack.RECORD_WORDS) and rec.dtype == np.int32
    count = nodes[:, pack.N_COUNT]
    nearfar = nodes[:, pack.N_NEARFAR:].reshape(m, 8, 2)
    box = nodes[:, 0:6]
    interior = np.nonzero(count == 0)[0]
    leaves = np.nonzero(count > 0)[0]
    left_ref, right_ref = rec[interior, 12], rec[interior, 13]
    # per octant, as the kernel reads it: near is the right child where
    # the swap bit is set
    for o in range(8):
        swap = ((rec[interior, 14] >> o) & 1) == 1
        near = np.where(swap, right_ref, left_ref)
        far = np.where(swap, left_ref, right_ref)
        for ref, want in ((near, nearfar[interior, o, 0]), (far, nearfar[interior, o, 1])):
            # an interior child by its id, a leaf by its complemented code
            is_leaf = ref < 0
            np.testing.assert_array_equal(ref[~is_leaf], want[~is_leaf])
            assert (count[want[~is_leaf]] == 0).all()
            first, cnt = _leaf(ref[is_leaf], t4, scene.leaf_codes)
            np.testing.assert_array_equal(first, nodes[want[is_leaf], pack.N_FIRST])
            np.testing.assert_array_equal(cnt, count[want[is_leaf]])
    # both children's boxes, bit for bit
    left, right = nearfar[interior, 0, 0], nearfar[interior, 0, 1]
    np.testing.assert_array_equal(rec[interior, 0:6], box[left])
    np.testing.assert_array_equal(rec[interior, 6:12], box[right])
    assert (rec[interior, 15] == 0).all()
    assert (rec[interior, 14] >> 8 == 0).all()
    # leaf rows are zero but for a one-leaf tree's root, which holds its
    # box and ref; the walks start at ~root then
    if scene.root_is_leaf:
        assert scene.record_root == ~scene.root
        np.testing.assert_array_equal(rec[scene.root, 0:6], box[scene.root])
        first, cnt = _leaf(rec[scene.root, 12:13], t4, scene.leaf_codes)
        assert (int(first[0]), int(cnt[0])) == (nodes[scene.root, pack.N_FIRST], count[scene.root])
        leaves = leaves[leaves != scene.root]
    else:
        assert scene.record_root == scene.root
    assert (rec[leaves] == 0).all()


def _check_link_records(scene):
    nodes, links, rec = scene.nodes.numpy(), scene.links.numpy(), scene.link_records.numpy()
    t4 = scene.tris4.numpy()
    m = nodes.shape[0]
    assert rec.shape == (8, m, pack.LINK_RECORD_WORDS) and rec.dtype == np.int32
    count = nodes[:, pack.N_COUNT]
    leaf = count > 0
    for o in range(8):
        r = rec[o]
        np.testing.assert_array_equal(r[:, 0:6], nodes[:, 0:6])  # the box, bit for bit
        hit, miss = links[:, 2 * o], links[:, 2 * o + 1]
        np.testing.assert_array_equal(r[:, 7], miss)
        # word 6: a node id is an interior node's hit link, a negative word
        # a leaf's ~code; a leaf's hit link is its miss link
        np.testing.assert_array_equal(r[:, 6] < 0, leaf)
        np.testing.assert_array_equal(r[~leaf, 6], hit[~leaf])
        np.testing.assert_array_equal(hit[leaf], miss[leaf])
        first, cnt = _leaf(r[leaf, 6], t4, scene.leaf_codes)
        np.testing.assert_array_equal(first, nodes[leaf, pack.N_FIRST])
        np.testing.assert_array_equal(cnt, count[leaf])


def _check_tris4(scene):
    tris, t4, nodes = scene.tris.numpy(), scene.tris4.numpy(), scene.nodes.numpy()
    assert t4.shape == (tris.shape[0], 12) and t4.dtype == np.float32
    v = t4.reshape(-1, 3, 4)
    np.testing.assert_array_equal(v[:, :, :3].reshape(-1, 9).view(np.int32), tris.view(np.int32))
    assert (v[:, 1:, 3] == 0).all()
    # word 3 of v0: the slots from this one to its leaf's end
    left = v[:, 0, 3].view(np.int32)
    for n in np.nonzero(nodes[:, pack.N_COUNT] > 0)[0]:
        f, c = nodes[n, pack.N_FIRST], nodes[n, pack.N_COUNT]
        np.testing.assert_array_equal(left[f : f + c], np.arange(c, 0, -1))


@pytest.mark.parametrize("xml,accel,table", CASES, ids=["-".join(c) for c in CASES])
def test_walk_records_decode_to_the_plain_tables(xml, accel, table):
    scene = _scene(xml, accel)
    assert (scene.link_records is not None) == (accel != "bvh")
    dict(node_records=_check_node_records, link_records=_check_link_records,
         tris4=_check_tris4)[table](scene)


def _two_leaf_tree(first=(0, 1), count=(1, 1)):
    """`nodes` of an interior root 0 over leaves 1 and 2."""
    nodes = np.zeros((3, pack.NODE_WORDS), np.int32)
    nodes[:, pack.N_NEARFAR:] = -1
    nodes[0, pack.N_NEARFAR::2] = 1
    nodes[0, pack.N_NEARFAR + 1::2] = 2
    nodes[1:, pack.N_FIRST] = first
    nodes[1:, pack.N_COUNT] = count
    return nodes


# past the 22-bit first slot and the 9-bit count of the leaf code that
# carries the count (the JAX package keeps both in int32 words)
WIDE_FIRST = (1 << 22) + 5
BIG_COUNT = 600


@pytest.mark.parametrize("field", ["first", "count", "links_first"])
def test_wide_leaf_fields_pack_and_decode(field):
    """A first slot past 2^22 in `node_records` and `link_records`, and a
    600-triangle leaf in `node_records` and `tris4`, pack in the form that
    names the first slot alone and decode word for word back into the
    plain tables; a leaf that fits takes the code with the count."""
    if field == "count":
        # leaf 1: one slot; leaf 2: BIG_COUNT slots after it
        nodes = _two_leaf_tree(first=(0, 1), count=(1, BIG_COUNT))
        leaf = nodes[:, pack.N_COUNT] > 0
        first, count = nodes[leaf, pack.N_FIRST], nodes[leaf, pack.N_COUNT]
        assert not pack.codes_fit(first, count) and pack.codes_fit(first, count.clip(max=511))
        tris = np.random.default_rng(0).normal(size=(1 + BIG_COUNT, 9)).astype(np.float32)
        t4 = pack.tris4(tris, first, count)
        rec, root = pack.node_records(nodes, 0, codes=False)
        assert root == 0
        for ref, n in ((rec[0, 12], 1), (rec[0, 13], 2)):
            got = _leaf(np.array([ref]), t4, codes=False)
            assert (got[0][0], got[1][0]) == (nodes[n, pack.N_FIRST], nodes[n, pack.N_COUNT])
        np.testing.assert_array_equal(t4.reshape(-1, 3, 4)[:, :, :3].reshape(-1, 9), tris)
        with pytest.raises(ValueError, match="does not fit"):
            pack.node_records(nodes, 0, codes=True)
        return
    nodes = _two_leaf_tree(first=(3, WIDE_FIRST))
    codes = pack.codes_fit(nodes[1:, pack.N_FIRST], nodes[1:, pack.N_COUNT])
    assert not codes
    if field == "first":
        rec, _ = pack.node_records(nodes, 0, codes)
        assert ~rec[0, 12] == 3 and ~rec[0, 13] == WIDE_FIRST
        # the code that carries the count, where the leaves fit it
        small = _two_leaf_tree(first=(3, 9), count=(2, 511))
        rec, _ = pack.node_records(small, 0, codes=True)
        assert ~rec[0, 12] == 2 << pack.LEAF_SHIFT | 3 and ~rec[0, 13] == 511 << pack.LEAF_SHIFT | 9
        return
    links = np.full((3, 16), -1, np.int32)
    links[0, 0::2] = 1  # the root's hit link: its left child
    rec = pack.link_records(nodes, links, codes)
    for o in range(8):
        assert rec[o, 0, 6] == 1
        assert ~rec[o, 1, 6] == 3 and ~rec[o, 2, 6] == WIDE_FIRST
        np.testing.assert_array_equal(rec[o, :, 7], links[:, 2 * o + 1])


@pytest.mark.parametrize("fault", ["one_child", "empty_child", "shared_slot"])
def test_packing_refuses_what_the_records_cannot_hold(fault):
    nodes = _two_leaf_tree()
    assert pack.node_records(nodes, 0, True)[1] == 0  # the tree itself packs
    if fault == "shared_slot":
        # leaves [0, 2) and [1, 2): slot 1 ends both, but slot 0's leaf
        # would have it counted twice over
        tris = np.zeros((2, 9), np.float32)
        pack.tris4(tris, np.array([0, 1]), np.array([1, 1]))
        with pytest.raises(ValueError, match="share a triangle slot"):
            pack.tris4(tris, np.array([0, 0]), np.array([2, 1]))
        return
    if fault == "one_child":
        nodes[0, pack.N_NEARFAR + 1::2] = -1
    elif fault == "empty_child":
        nodes[2, pack.N_COUNT] = 0
    with pytest.raises(ValueError):
        pack.node_records(nodes, 0, True)
