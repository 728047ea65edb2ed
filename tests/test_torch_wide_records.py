"""The wide walk's records and stack, its lane order, and K7's packs, on the
CPU.

* `wide_records` (accel/wide.py) holds `wide_nodes` word for word, the
  boxes field-major (word 8f + k: field f of child k), on the wide packs of
  `bunny_teapot.xml`, `cube_scene.xml` and the scenes of
  `scene/synthetic.py` (the 100- and 140-level caterpillars, the
  600-triangle leaf, 70 cube instances with the slot table).
* The plain wide walk over the records, whose stack holds node ids pushed
  far to near, gives outputs and counters identical to the walk it
  replaces (below: the previous plain walk, over `wide_nodes` with the
  stack word `node << 8 | pending mask` whose pop reads the parent's
  order and child words again; the JAX wide kernel's stack), closest and
  any hit, on camera rays, random rays and shadow rays.  The plain walk
  against the JAX wide kernel in interpret mode is
  `tests/test_torch_wide.py`.
* The pack refuses a tree whose stack need passes WIDE_STACK_CAP.
* `perm` on the CPU changes no output; a lane order that is not a
  permutation of the rays, or not int32 [R], raises; the host routes pass
  the camera's lane order to the wide walk at depth 0 / level 0 only.
* K7's packs (C in the kernel's fragment order, Phi ray-major) unpack to
  their inputs, and the plain version in the kernel's pair order on them
  equals `mxu_leaf_plain` (the probe's flush order) at every m.
"""

import os

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.accel import wide
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import closest_hit, intersect, kernel_lib, leaf_probe, wide_bvh
from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import query, synthetic
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import BENCH_CAMERA, BENCH_XML, CUBE_XML
from torch_rays import node_bounds, random_rays, shadow_rays

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
SCENES = ("bunny_teapot", "cube_scene", "deep_100", "deep_140", "big_leaf", "cubes70")
_CACHE = {}


def _scene(name: str, tmp_dir: str):
    if name not in _CACHE:
        if name in ("bunny_teapot", "cube_scene"):
            xml = BENCH_XML if name == "bunny_teapot" else CUBE_XML
            sc = compile_scene(xml, wide=True, device="cpu")[0]
        elif name.startswith("deep"):
            base = compile_scene(CUBE_XML, device="cpu")[0]
            sc = synthetic.scene_over(base, synthetic.caterpillar(int(name[5:])), wide=True)
        elif name == "big_leaf":
            xml = synthetic.big_leaf_xml(tmp_dir, ASSETS)
            sc = synthetic.scene_over(compile_scene(xml, device="cpu")[0],
                                      synthetic.big_leaf_bvh(), wide=True)
        else:
            sc = compile_scene(synthetic.cubes_xml(tmp_dir, ASSETS), wide=True, device="cpu")[0]
        _CACHE[name] = sc
    return _CACHE[name]


@pytest.fixture(params=SCENES)
def named(request, tmp_path_factory):
    return request.param, _scene(request.param, str(tmp_path_factory.mktemp("wide")))


def test_wide_records_hold_the_wide_nodes(named):
    _, scene = named
    nodes, rec = scene.wide_nodes.numpy(), scene.wide_records.numpy()
    assert scene.walk == "wide" and rec.shape == nodes.shape == (nodes.shape[0], wide.WIDE_WORDS)
    assert scene.wide_records.data_ptr() % 16 == 0
    for k in range(wide.WIDE):
        for f in range(wide.W_FIELDS):
            # bit for bit, NaN boxes of empty slots included
            np.testing.assert_array_equal(rec[:, 8 * f + k], nodes[:, 6 * k + f])
    np.testing.assert_array_equal(rec[:, 6 * wide.WIDE:], nodes[:, 6 * wide.WIDE:])
    # the stack bound: every node's interior children, nested
    assert 0 <= scene.wide_stack <= wide.WIDE_STACK_CAP
    assert scene.wide_stack == wide.stack_need(nodes)


def _previous_walk(scene, o, d, t0, mask, any_hit):
    """The walk the id stack replaced, in plain PyTorch: over `wide_nodes`,
    the stack word `node << 8 | pending mask`, a pop taking the nearest
    pending child of the top word from the parent's order word."""
    from cpu_ray_tracer_tpu_torch.ops.closest_hit import leaf_tests, octants, outputs, slab

    def bit(s):
        return torch.ones_like(s) << s

    def nearest(bits, order):
        sel = torch.full_like(bits, -1)
        for rank in range(wide.WIDE):
            s = (order >> (3 * rank)) & 7
            sel = torch.where((sel < 0) & (((bits >> s) & 1) > 0), s, sel)
        return sel

    nodes, tris = scene.wide_nodes.long(), scene.tris
    r = o.shape[0]
    res = outputs(t0)
    live = torch.ones(r, dtype=torch.bool) if mask is None else mask.bool()
    rd = 1.0 / d
    order_col = wide.W_ORDER + octants(d)
    boxes = scene.wide_nodes[:, : 6 * wide.WIDE].view(torch.float32).reshape(-1, wide.WIDE, 6)
    roots = scene.wide_roots.long()
    stack = torch.zeros((r, 64), dtype=torch.long)
    stack[:, : roots.numel() - 1] = roots[1:].flip(0) << 8
    sp = torch.full((r,), roots.numel() - 1, dtype=torch.long)
    cur = torch.where(live, roots[0], -1)
    while True:
        ids = torch.nonzero(cur >= 0).squeeze(1)
        if ids.numel() == 0:
            break
        n, c = ids.numel(), cur[ids]
        rec = nodes[c]
        child = rec[:, wide.W_CHILD : wide.W_CHILD + wide.WIDE]
        hit = slab(boxes[c].reshape(-1, 6), o[ids].repeat_interleave(wide.WIDE, 0),
                   rd[ids].repeat_interleave(wide.WIDE, 0),
                   res["t"][ids].repeat_interleave(wide.WIDE, 0)).reshape(n, wide.WIDE)
        for k in range(wide.WIDE):
            m = hit[:, k] & (child[:, k] < 0)
            first, count = wide_bvh.leaf_fields(scene, ~child[m, k])
            leaf_tests(tris, ids[m], first, count, o, d, res)
        ibits = ((hit & (child > 0)).long() * bit(torch.arange(wide.WIDE))).sum(1)
        sel = nearest(ibits, rec.gather(1, order_col[ids, None])[:, 0])
        down = sel >= 0
        rest = ibits & ~bit(sel.clamp_min(0))
        sp_i = sp[ids]
        top = stack[ids, (sp_i - 1).clamp_min(0)]
        p, pm = top >> 8, top & 0xFF
        prec = nodes[p]
        selp = nearest(pm, prec.gather(1, order_col[ids, None])[:, 0])
        pop_child = prec.gather(1, wide.W_CHILD + selp.clamp_min(0)[:, None])[:, 0]
        pop_to = torch.where(pm == 0, p, pop_child)
        pm_rest = pm & ~bit(selp.clamp_min(0))
        can_pop = ~down & (sp_i > 0)
        nxt = torch.where(down, child.gather(1, sel.clamp_min(0)[:, None])[:, 0],
                          torch.where(can_pop, pop_to, -1))
        push = down & (rest != 0)
        stack[ids[push], sp_i[push]] = (c[push] << 8) | rest[push]
        keep = can_pop & (pm_rest != 0)
        stack[ids[keep], sp_i[keep] - 1] = (p[keep] << 8) | pm_rest[keep]
        sp[ids] = sp_i + push.long() - (can_pop & ~keep).long()
        if any_hit:
            nxt = torch.where(res["slot"][ids] >= 0, -1, nxt)
        cur[ids] = nxt
        res["traversed"][ids] += 1
    return res


def _rays(kind, name, scene):
    if kind == "primary":
        # the synthetic scenes stand in front of the default camera
        camera = BENCH_CAMERA if name in ("bunny_teapot", "cube_scene") else {}
        cam = cam_mod.make_camera(48, 32, **camera)
        o, d, _ = pathtracer.camera_rays(cam, 2, "cpu")
        t0, _ = intersect.primitive_hits(scene, o, d)
        return o, d, t0, None
    bmin, bmax = node_bounds(scene.nodes.numpy())
    rays = (random_rays if kind == "random" else shadow_rays)(bmin, bmax, 1024, seed=21)
    return tuple(torch.from_numpy(x) for x in rays)


@pytest.mark.parametrize("kind", ["primary", "random", "shadow"])
def test_id_stack_walk_equals_the_previous_walk(named, kind):
    name, scene = named
    o, d, t0, mask = _rays(kind, name, scene)
    got = wide_bvh.closest_hit_wide_plain(scene, o, d, t0, mask)
    want = closest_hit.decode(scene, _previous_walk(scene, o, d, t0, mask, any_hit=False))
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert int(got["traversed"].sum()) > 0
    occ = wide_bvh.occluded_wide_plain(scene, o, d, t0, mask)
    assert torch.equal(occ, _previous_walk(scene, o, d, t0, mask, any_hit=True)["slot"] >= 0)
    assert torch.equal(occ, got["slot"] >= 0)


def test_pack_refuses_a_stack_past_its_capacity(monkeypatch):
    sc = _scene("bunny_teapot", "")
    need = sc.wide_stack
    assert need > 1
    wide.check_stack(need, 1)
    wide.check_stack(need, wide.WIDE_STACK_CAP - need + 1)  # extra roots wait on the stack
    with pytest.raises(ValueError, match="capacity"):
        wide.check_stack(need, wide.WIDE_STACK_CAP - need + 2)
    monkeypatch.setattr(wide, "WIDE_STACK_CAP", need - 1)
    with pytest.raises(ValueError, match="capacity"):
        compile_scene(BENCH_XML, wide=True, device="cpu")


def test_lane_order_changes_no_output_and_must_be_a_permutation():
    sc = _scene("bunny_teapot", "")
    cam = cam_mod.make_camera(48, 32, **BENCH_CAMERA)
    o, d, _ = pathtracer.camera_rays(cam, 1, "cpu")
    t0, _ = intersect.primitive_hits(sc, o, d)
    lanes = cam_mod.lane_order(cam, "cpu")
    want = wide_bvh.closest_hit_wide(sc, o, d, t0)
    got = wide_bvh.closest_hit_wide(sc, o, d, t0, perm=lanes)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(wide_bvh.occluded_wide(sc, o, d, t0, perm=lanes),
                       wide_bvh.occluded_wide(sc, o, d, t0))
    dup = lanes.clone()
    dup[1] = dup[0]
    for bad, match in ((dup, "not a permutation"), (lanes.long(), "int32"),
                       (lanes[:-1].contiguous(), "shape")):
        for fn in (wide_bvh.closest_hit_wide, wide_bvh.occluded_wide):
            with pytest.raises(ValueError, match=match):
                fn(sc, o, d, t0, perm=bad)
    # a lane order for a walk that takes rays in order is refused
    binary = compile_scene(CUBE_XML, device="cpu")[0]
    with pytest.raises(ValueError, match="lane order"):
        query.triangle_hit(binary, o, d, t0, perm=lanes)


def test_host_routes_pass_the_lane_order_at_depth_0(monkeypatch):
    sc = _scene("bunny_teapot", "")
    cam = cam_mod.make_camera(24, 16, **BENCH_CAMERA)
    lanes = cam_mod.lane_order(cam, "cpu")
    seen = {"closest": [], "any": []}

    def record(key, fn):
        def wrapped(scene, o, d, t0, mask=None, perm=None):
            seen[key].append(perm)
            return fn(scene, o, d, t0, mask, perm)
        return wrapped

    monkeypatch.setattr(query, "closest_hit_wide", record("closest", wide_bvh.closest_hit_wide))
    monkeypatch.setattr(query, "occluded_wide", record("any", wide_bvh.occluded_wide))
    img, st = pathtracer.render_pass(sc, cam, 1)
    assert torch.equal(seen["closest"][0], lanes) and len(seen["closest"]) > 1
    assert all(p is None for p in seen["closest"][1:])
    monkeypatch.setattr(query, "closest_hit_wide", wide_bvh.closest_hit_wide)
    monkeypatch.setattr(query, "occluded_wide", wide_bvh.occluded_wide)
    ref_img, ref_st = pathtracer.render_pass(compile_scene(BENCH_XML, device="cpu")[0], cam, 1)
    assert st["rays_traced"] == ref_st["rays_traced"]
    np.testing.assert_allclose(img.numpy(), ref_img.numpy(), atol=2e-5, rtol=1e-4)
    seen["closest"].clear()
    monkeypatch.setattr(query, "closest_hit_wide", record("closest", wide_bvh.closest_hit_wide))
    monkeypatch.setattr(query, "occluded_wide", record("any", wide_bvh.occluded_wide))
    out = whitted.render(sc, cam)
    assert torch.equal(seen["closest"][0], lanes) and torch.equal(seen["any"][0], lanes)
    assert all(p is None for p in seen["closest"][1:] + seen["any"][1:])
    assert out["rays"] > cam.width * cam.height


def test_wide_constants_follow_the_header():
    import re

    with open(os.path.join(kernel_lib.CSRC, "ptraverse.cuh")) as f:
        c = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", f.read())}
    assert 4 * c["WIDE_RECORD_INT4"] == wide.WIDE_WORDS
    assert c["W_ORDER"] == wide.W_ORDER and c["WIDE"] == wide.WIDE
    assert c["WIDE_STACK_CAP"] == wide.WIDE_STACK_CAP


@pytest.mark.parametrize("m", leaf_probe.WIDTHS)
def test_k7_packs_unpack_and_the_pair_order_gives_the_probe(m):
    rng = np.random.default_rng(m)
    c_tab = torch.from_numpy(rng.normal(size=(16 * m, 16)).astype(np.float32))
    phi = torch.from_numpy(rng.normal(size=(1, 16, leaf_probe.TILE)).astype(np.float32))
    c_frag, phi_rm = leaf_probe.pack(c_tab, phi, m)
    assert c_frag.shape == (leaf_probe.a_blocks(m) * 2048,) and phi_rm.shape == (4096, 16)
    assert torch.equal(leaf_probe.unpack_c(c_frag, m), c_tab)
    assert torch.equal(phi_rm.reshape(1, leaf_probe.TILE, 16).permute(0, 2, 1), phi)
    want = leaf_probe.mxu_leaf_plain(c_tab, phi, m)
    got = leaf_probe.mxu_leaf_pairs_plain((c_frag, phi_rm), m).reshape(want.shape)
    assert torch.equal(got, want)
    assert (want < 1e29).any()
