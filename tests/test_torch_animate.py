"""Animation of the PyTorch port against the JAX package
(`tests/test_animate.py`, `tests/test_instancing.py`, `tests/test_core.py`):

* `accel/bvh_builder.refit_bvh` gives the JAX package's node bounds after
  motion (both packages build the same tree), and its bounds contain the
  moved triangles;
* `AnimatedScene`: a transform and a light move show in the rebuilt
  scene, as the JAX package's; on a shared-instancing scene `update` is
  the O(1) transform update: it replaces the instance buffers only, and
  its Whitted frame equals a full rebuild's exactly on the CPU;
* a rebuilt scene keeps its buffers' names and shapes (the port's
  counterpart of test_rebuild_reuses_jit);
* `core/camera.handle_input` equals the JAX package's.
"""

import copy

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.accel import bvh_builder as jax_bvh
from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.scene.animate import AnimatedScene as JaxAnimatedScene
from cpu_ray_tracer_tpu_torch.accel import bvh_builder
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.io.scene_xml import load_scene_xml
from cpu_ray_tracer_tpu_torch.render import basics, whitted
from cpu_ray_tracer_tpu_torch.scene import query
from cpu_ray_tracer_tpu_torch.scene.animate import AnimatedScene
from torch_parity import CUBE_XML


def _dup(n_copies=3):
    spec = load_scene_xml(CUBE_XML)
    base = spec.objects[0]
    for c in range(1, n_copies):
        o = copy.deepcopy(base)
        o.position = base.position + np.asarray((1.5, 0.0, 0.0), np.float32) * c
        spec.objects.append(o)
    return spec


@pytest.mark.parametrize("leaf_target", [None, bvh_builder.LEAF_TARGET])
def test_refit_matches_jax(rng, leaf_target):
    base = rng.uniform(-4, 4, size=(200, 1, 3))
    tri_v = (base + rng.normal(0, 0.4, size=(200, 3, 3))).astype(np.float32)
    host, idx, _ = bvh_builder.build_bvh(tri_v, leaf_target=leaf_target)
    jhost, jidx, _ = jax_bvh.build_bvh(tri_v, leaf_target=leaf_target)
    np.testing.assert_array_equal(idx, jidx)
    # each triangle moves on its own, the topology stays
    moved = tri_v + rng.normal(0, 0.3, size=(200, 1, 3)).astype(np.float32)
    bvh_builder.refit_bvh(host, idx, moved)
    jax_bvh.refit_bvh(jhost, jidx, moved)
    np.testing.assert_array_equal(host.node_min, jhost.node_min[: jhost.nodes_used])
    np.testing.assert_array_equal(host.node_max, jhost.node_max[: jhost.nodes_used])
    tmin, tmax = moved.min(axis=1), moved.max(axis=1)
    for node in range(host.nodes_used):
        c = host.tri_count[node]
        if c:
            sl = idx[host.left_first[node] : host.left_first[node] + c]
            assert (host.node_min[node] == tmin[sl].min(axis=0)).all()
            assert (host.node_max[node] == tmax[sl].max(axis=0)).all()
        else:
            for child in (host.left[node], host.right[node]):
                assert (host.node_min[node] <= host.node_min[child]).all()
                assert (host.node_max[node] >= host.node_max[child]).all()


@pytest.mark.parametrize("instancing", ["baked", "shared"])
def test_transform_and_light_moves_match_jax(instancing):
    anim = AnimatedScene(CUBE_XML, instancing=instancing, device="cpu")
    janim = JaxAnimatedScene(CUBE_XML, layout="tlas", instancing=instancing)
    s0, _ = anim.build()
    for a in (anim, janim):
        a.set_transform(0, position=(5.0, 0.0, 2.5), rotation_deg=(0, 30, 0))
        a.set_light_position((3.0, 4.0, 5.0))
        a.set_time(0.5)
    s1, _ = anim.build()
    j1, _ = janim.build()
    assert anim.anim_time == janim.anim_time == 0.5
    np.testing.assert_array_equal(s1.light_t.numpy(), np.asarray(j1.light_t))
    np.testing.assert_allclose(s1.light_t.numpy()[:3, 3], [3, 4, 5])
    if instancing == "baked":
        lo0, lo1 = s0.pool[:, 0:3].min(dim=0).values, s1.pool[:, 0:3].min(dim=0).values
        assert float(lo1[0]) > float(lo0[0]) + 3.0  # the cube moved +x
        np.testing.assert_array_equal(s1.pool[:, 0:3].numpy(), np.asarray(j1.tris.v0))
    else:
        for k in ("inst_minv", "inst_nrm", "inst_aabb_min", "inst_aabb_max"):
            np.testing.assert_array_equal(getattr(s1.shared, k).numpy(),
                                          np.asarray(getattr(j1.shared, k)), err_msg=k)
        assert float(s1.shared.inst_aabb_min[0, 0]) > float(s0.shared.inst_aabb_min[0, 0]) + 3.0


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (kernel_params bit-casts ints: NaN patterns)."""
    return a.shape == b.shape and torch.equal(a.flatten().view(torch.uint8),
                                              b.flatten().view(torch.uint8))


def test_shared_update_is_o1_and_exact():
    """`update` after `set_transform`: only the instance transforms are
    new (every mesh table and id buffer is the old scene's own tensor), the
    old scene is unchanged, and the Whitted frame equals a full rebuild's
    exactly (the JAX package's test_transform_update_is_o1_and_exact)."""
    anim = AnimatedScene(spec=_dup(), instancing="shared", device="cpu")
    scene, _ = anim.build()
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    anim.set_transform(1, position=(3.0, 0.5, 2.0), rotation_deg=(0, 45, 0))
    fast = anim.update(scene)
    full, _ = anim.build()
    moved = {"shared.inst_minv", "shared.inst_nrm", "shared.inst_aabb_min",
             "shared.inst_aabb_max"}
    old, new = scene.state_dict(), fast.state_dict()
    assert old.keys() == new.keys() == full.state_dict().keys()
    for k in old:
        assert _bits_equal(old[k], before[k]), k  # the old scene is left as it was
        assert (new[k].data_ptr() == old[k].data_ptr()) == (k not in moved), k
        if k in moved:
            assert _bits_equal(new[k], full.state_dict()[k]), k
    cam = cam_mod.make_camera(32, 20)
    img_fast = whitted.render(fast, cam)["image"]
    img_full = whitted.render(full, cam)["image"]
    assert torch.equal(img_fast, img_full)
    img_orig = whitted.render(scene, cam)["image"]
    assert float((img_fast - img_orig).abs().max()) > 0.01
    o, d = cam_mod.full_frame_rays(cam, device="cpu")
    a, b = query.find_nearest(fast, o, d), query.find_nearest(full, o, d)
    for key in ("t", "obj_idx", "tri_idx", "slot"):
        assert torch.equal(a[key], b[key]), key


def test_baked_update_rebuilds():
    anim = AnimatedScene(CUBE_XML, device="cpu")
    scene, _ = anim.build()
    anim.set_transform(0, position=(0.3, 0.0, 2.5))
    new = anim.update(scene)
    assert new is not scene and not torch.equal(new.pool, scene.pool)


@pytest.mark.parametrize("instancing", ["baked", "shared"])
def test_rebuild_keeps_buffer_names_and_shapes(instancing):
    """The counterpart of the JAX package's test_rebuild_reuses_jit: the
    same object set rebuilds to the same buffers (names, shapes, dtypes),
    so what was made for one frame (a captured graph, preallocated
    outputs) fits the next; the depth AOV moves with the object."""
    anim = AnimatedScene(CUBE_XML, instancing=instancing, device="cpu")
    cam = cam_mod.make_camera(16, 8)
    s0, _ = anim.build()
    img0 = basics.render(s0, cam, aov="depth")
    anim.set_transform(0, position=(0.3, 0.0, 2.5))
    s1 = anim.update(s0)
    img1 = basics.render(s1, cam, aov="depth")
    a, b = s0.state_dict(), s1.state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
    assert img0.shape == img1.shape and not torch.allclose(img0, img1)


@pytest.mark.parametrize("move, turn", [
    ((0, 0, 1), (0, 0)), ((1, 0, 0), (0, 0)), ((0, -1, 0), (0, 0)),
    ((0, 0, 0), (1, 0)), ((0, 0, 0), (0, -1)), ((1, 1, -1), (-1, 1)),
])
def test_handle_input_matches_jax(move, turn):
    kw = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
    cam, jcam = cam_mod.make_camera(64, 32, **kw), jax_cam.make_camera(64, 32, **kw)
    for dt in (16.0, 1000.0):
        got = cam_mod.handle_input(cam, dt_ms=dt, move=move, turn=turn)
        want = jax_cam.handle_input(jcam, dt_ms=dt, move=move, turn=turn)
        for field in ("pos", "target", "top_left", "top_right", "bottom_left"):
            np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)),
                                          err_msg=field)
        assert (got.width, got.height) == (64, 32)
    # W moves along the view: the reference's 0.00025 * 1000 * 5 * 2 = 2.5
    fwd = cam_mod.handle_input(cam_mod.make_camera(64, 32), dt_ms=1000.0, move=(0, 0, 1))
    np.testing.assert_allclose(fwd.pos, [0, 0, 0.5], atol=1e-5)
