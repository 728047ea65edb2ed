"""The walk records the CUDA walks read (`accel/pack.py`: `node_records`,
`link_records`, `tris4`) decode back, word for word, into the tables the
plain versions read and the JAX package's tables equal (`nodes`, `links`,
`tris`), on the binary BVH, grid and KD scenes of `bunny_teapot.xml` and
`cube_scene.xml`; and packing refuses what the encodings cannot hold."""

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


def _leaf(code: np.ndarray):
    """(first, count) of leaf codes `count << LEAF_SHIFT | first`."""
    return code & ((1 << pack.LEAF_SHIFT) - 1), code >> pack.LEAF_SHIFT


def _check_node_records(scene):
    nodes, rec = scene.nodes.numpy(), scene.node_records.numpy()
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
            first, cnt = _leaf(~ref[is_leaf])
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
        first, cnt = _leaf(~rec[scene.root, 12:13])
        assert (int(first[0]), int(cnt[0])) == (nodes[scene.root, pack.N_FIRST], count[scene.root])
        leaves = leaves[leaves != scene.root]
    else:
        assert scene.record_root == scene.root
    assert (rec[leaves] == 0).all()


def _check_link_records(scene):
    nodes, links, rec = scene.nodes.numpy(), scene.links.numpy(), scene.link_records.numpy()
    m = nodes.shape[0]
    assert rec.shape == (8, m, pack.LINK_RECORD_WORDS) and rec.dtype == np.int32
    count = nodes[:, pack.N_COUNT]
    leaf = count > 0
    for o in range(8):
        r = rec[o]
        np.testing.assert_array_equal(r[:, 0:6], nodes[:, 0:6])  # the box, bit for bit
        hit, miss = links[:, 2 * o], links[:, 2 * o + 1]
        np.testing.assert_array_equal(r[:, 7], miss)
        # word 6: a node id (< 2^LEAF_SHIFT) is an interior node's hit link,
        # a larger word a leaf's slots; a leaf's hit link is its miss link
        is_code = r[:, 6] > (1 << pack.LEAF_SHIFT) - 1
        np.testing.assert_array_equal(is_code, leaf)
        np.testing.assert_array_equal(r[~leaf, 6], hit[~leaf])
        np.testing.assert_array_equal(hit[leaf], miss[leaf])
        first, cnt = _leaf(r[leaf, 6])
        np.testing.assert_array_equal(first, nodes[leaf, pack.N_FIRST])
        np.testing.assert_array_equal(cnt, count[leaf])


def _check_tris4(scene):
    tris, t4 = scene.tris.numpy(), scene.tris4.numpy()
    assert t4.shape == (tris.shape[0], 12) and t4.dtype == np.float32
    v = t4.reshape(-1, 3, 4)
    np.testing.assert_array_equal(v[:, :, :3].reshape(-1, 9).view(np.int32), tris.view(np.int32))
    assert (v[:, :, 3] == 0).all()


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


@pytest.mark.parametrize("fault", ["first", "count", "one_child", "empty_child", "links_first"])
def test_packing_refuses_what_the_records_cannot_hold(fault):
    nodes = _two_leaf_tree()
    assert pack.node_records(nodes, 0)[1] == 0  # the tree itself packs
    if fault == "first":
        nodes[2, pack.N_FIRST] = 1 << pack.LEAF_SHIFT
    elif fault == "count":
        nodes[2, pack.N_COUNT] = 1 << (31 - pack.LEAF_SHIFT)
    elif fault == "one_child":
        nodes[0, pack.N_NEARFAR + 1::2] = -1
    elif fault == "empty_child":
        nodes[2, pack.N_COUNT] = 0
    if fault == "links_first":
        nodes[1, pack.N_FIRST] = (1 << pack.LEAF_SHIFT) + 5
        links = np.full((3, 16), -1, np.int32)
        with pytest.raises(ValueError, match="first slot"):
            pack.link_records(nodes, links)
        return
    with pytest.raises(ValueError):
        pack.node_records(nodes, 0)
