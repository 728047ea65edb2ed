"""The Whitted tracer of the PyTorch port against the JAX package.

* `occluded_plain` (the any-hit kernel's plain version) and
  `query.is_occluded` against the JAX package's any-hit packet walk and
  `query.is_occluded`, with the scene's shadow quirk on and off;
* `common.direct_illumination` against the JAX package's;
* `trace_level0_plain` (the Whitted level kernel's plain version) against
  the JAX package's `whitted_wf.trace_level0` in interpret mode, on primary
  rays and on a child level with `inside`;
* `whitted.render` through both level routes against the JAX package's
  eager `whitted.render` on its host route (`CRT_WHITTED_WF=0`; its own
  kernel route disagrees with it on the dielectric scene), and against the
  scalar oracle `tests/oracle.py`;
* the host route over the grid, the KD tree and the wide BVH against the
  JAX package's host route over the same accelerator.

The JAX package's Whitted level kernel always takes the shadow quirk; the
port's reads it from the scene, so the level is held to it with the quirk.
Flags, ids and texel indices exact; floats at the parity tolerance
(atol=2e-5, rtol=1e-4); images likewise except fp-borderline pixels
(`render/borderline.py`), and against the oracle at the JAX package's own
oracle tolerance (tests/test_render.py:44) except fp-borderline pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.ops.pallas import whitted_wf as jax_wwf
from cpu_ray_tracer_tpu.render import common as jax_common
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu.scene import query as jax_query
from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import whitted_wf
from cpu_ray_tracer_tpu_torch.ops.closest_hit import occluded, occluded_plain
from cpu_ray_tracer_tpu_torch.render import borderline, common, whitted
from cpu_ray_tracer_tpu_torch.scene import query
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from oracle import WhittedOracle
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_compile_wide, jax_reference_env,
    jax_scene_arrays,
)
from torch_rays import node_bounds, random_rays

DEPTH = 5
RENDERS = {
    # (xml, width, height, camera)
    "bunny_teapot": (BENCH_XML, 64, 40, BENCH_CAMERA),
    "cube_scene": (CUBE_XML, 32, 20, {}),
}
LEVEL_KEYS = ("t", "irr_scale", "r_dir", "t_dir", "fr")
LEVEL_EXACT = ("miss", "lit", "surf", "vis", "emit1", "emit2", "mat", "tex_idx")


@pytest.fixture(scope="module", params=[True, False], ids=["quirk", "no_quirk"])
def bench(request):
    """bunny_teapot in JAX and in the port, with the shadow quirk on or off."""
    jax_scene, _ = jax_compile(BENCH_XML, shadow_quirk=request.param)
    port = scene_from_arrays(*jax_scene_arrays(jax_scene))
    assert port.shadow_quirk == request.param
    return jax_scene, port


def _diffuse_hits(port):
    """Points and normals of the diffuse primary hits of the 64x40 bench
    view (numpy)."""
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(64, 40, **BENCH_CAMERA), device="cpu")
    res = query.find_nearest(port, o, d)
    point = o + res["t"][:, None] * d
    normal, _, mat = query.get_hit_info(port, res, point, d)
    mf = query.material_fields(port, mat)
    keep = (res["obj_idx"] >= 0) & ~mf["is_light"] & (mf["reflectivity"] + mf["refractivity"] < 1)
    return point[keep].numpy(), normal[keep].numpy()


def _shadow_rays(port):
    """The diffuse hits' shadow rays, as direct_illumination makes them,
    and random rays with random distances (numpy)."""
    p, _ = _diffuse_hits(port)
    lv = query.get_light_pos(port).numpy() - p
    dist = np.linalg.norm(lv, axis=1).astype(np.float32)
    ld = (lv / dist[:, None]).astype(np.float32)
    so = (p + ld * constants.SHADE_EPS).astype(np.float32)
    bmin, bmax = node_bounds(port.nodes.numpy())
    ro, rd, _, mask = random_rays(bmin, bmax, 1024, seed=4)
    rdist = np.random.default_rng(5).uniform(0.05, 3.0, size=1024).astype(np.float32)
    o = np.concatenate([so, ro])
    d = np.concatenate([ld, rd])
    return o, d, np.concatenate([dist - 2 * constants.SHADE_EPS, rdist]), np.concatenate(
        [np.ones(len(so), bool), mask])


def test_occluded_plain_matches_jax_any_hit(bench):
    jax_scene, port = bench
    o, d, dist, mask = _shadow_rays(port)
    t0 = np.full(len(o), constants.RAY_FAR, np.float32)
    for tmax in (t0, dist):
        want = jax_query._traverse_accel(
            jax_scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), any_hit=True,
            mask=jnp.asarray(mask),
        )
        want = np.asarray(want["tri_idx"]) >= 0
        args = [torch.from_numpy(x) for x in (o, d, tmax, mask)]
        got = occluded_plain(port, *args).numpy()
        np.testing.assert_array_equal(got, want)
        assert torch.equal(occluded(port, *args), torch.from_numpy(got))
        assert got.any() and not got.all() and not got[~mask].any()


def test_is_occluded_matches_jax(bench):
    jax_scene, port = bench
    o, d, dist, mask = _shadow_rays(port)
    want = jax_query.is_occluded(
        jax_scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist), mask=jnp.asarray(mask),
    )
    got = query.is_occluded(port, *(torch.from_numpy(x) for x in (o, d, dist, mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def test_direct_illumination_matches_jax(bench):
    jax_scene, port = bench
    p, n = _diffuse_hits(port)
    active = np.random.default_rng(6).uniform(size=len(p)) < 0.9
    want = jax_common.direct_illumination(
        jax_scene, jnp.asarray(p), jnp.asarray(n), active=jnp.asarray(active),
    )
    got = common.direct_illumination(
        port, torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(active),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    assert (got.numpy()[~active] == 0).all() and got.numpy().max() > 0


def _level_inputs(port):
    """Primary rays of the bench view, and the child level that the port's
    Whitted tracer makes from them (reflected and refracted rays, `inside`
    set on the refracted ones)."""
    o, d = cam_mod.full_frame_rays(cam_mod.make_camera(64, 40, **BENCH_CAMERA), device="cpu")
    lv = whitted._level_kernel(port, o, d, torch.zeros(o.shape[0], dtype=torch.bool))
    _, ch = whitted._shade(port, lv, d, torch.zeros(o.shape[0], dtype=torch.bool),
                           torch.ones((o.shape[0], 3)))
    i1 = torch.nonzero(ch["emit1"]).squeeze(1)
    i2 = torch.nonzero(ch["emit2"]).squeeze(1)
    co = torch.cat([ch["o1"][i1], ch["o2"][i2]])
    cd = torch.cat([ch["d1"][i1], ch["d2"][i2]])
    inside = torch.cat([torch.zeros(i1.numel(), dtype=torch.bool),
                        torch.ones(i2.numel(), dtype=torch.bool)])
    assert i2.numel() > 0
    return dict(primary=(o, d, torch.zeros(o.shape[0], dtype=torch.bool)),
                child=(co, cd, inside))


@pytest.mark.parametrize("bench", [True], indirect=True, ids=["quirk"])  # the TPU kernel's only
@pytest.mark.parametrize("level", ["primary", "child"])
def test_trace_level0_plain_matches_jax_kernel(bench, level):
    jax_scene, port = bench
    o, d, inside = _level_inputs(port)[level]
    want = jax_wwf.trace_level0(
        jax_scene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(inside.numpy()),
        interpret=True,
    )
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in whitted_wf.trace_level0(port, o, d, inside).items()}
    for key in LEVEL_EXACT:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in LEVEL_KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=2e-5, rtol=1e-4, err_msg=key)
    assert got["surf"].any() and got["vis"].any() and (got["traversed"] >= 0).all()


def test_trace_level0_dead_rays_do_nothing(bench):
    _, port = bench
    o, d, inside = _level_inputs(port)["primary"]
    alive = torch.from_numpy(np.random.default_rng(7).uniform(size=o.shape[0]) < 0.5)
    got = whitted_wf.trace_level0(port, o, d, inside, alive)
    full = whitted_wf.trace_level0(port, o, d, inside)
    dead = ~alive
    for key in ("miss", "lit", "surf", "vis", "emit1", "emit2"):
        assert not got[key][dead].any(), key
        assert torch.equal(got[key][alive], full[key][alive]), key
    assert (got["tex_idx"][dead] == -1).all() and (got["irr_scale"][dead] == 0).all()
    assert (got["traversed"][dead] == 0).all() and (got["tested"][dead] == 0).all()


@pytest.fixture(scope="module", params=list(RENDERS))
def jax_whitted_render(request):
    """The JAX package's eager Whitted frame on its host route."""
    xml, w, h, cam = RENDERS[request.param]
    jax_scene, _ = jax_compile(xml)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WHITTED_WF", "0")
        out = jax_whitted.render(jax_scene, jax_cam.make_camera(w, h, **cam), depth_limit=DEPTH)
        img = np.asarray(out["image"])
    return request.param, jax_scene, img


@pytest.mark.parametrize("level_kernel", [True, False], ids=["kernel_route", "host_route"])
def test_render_matches_jax_host_route(jax_whitted_render, level_kernel):
    name, jax_scene, ref = jax_whitted_render
    port = scene_from_arrays(*jax_scene_arrays(jax_scene))
    xml, w, h, cam = RENDERS[name]
    camera = cam_mod.make_camera(w, h, **cam)
    out = whitted.render(port, camera, DEPTH, level_kernel=level_kernel)
    img = out["image"]
    assert out["dropped"] == 0 and bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    assert int(out["traversed"].sum()) > 0 or port.root_is_leaf
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(port, o, d, DEPTH, level_kernel)[0],
        (*cam_mod.full_frame_rays(camera, device="cpu"), None), img, torch.from_numpy(ref.copy()),
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


def test_render_matches_scalar_oracle():
    """The cube at 32x20 against the recursive scalar oracle (brute-force
    triangles, float texels), at the JAX package's oracle tolerance."""
    xml, w, h, cam = RENDERS["cube_scene"]
    jax_scene, _ = jax_compile(xml)
    camera = cam_mod.make_camera(w, h, **cam)
    port = scene_from_arrays(*jax_scene_arrays(jax_scene))
    ref = torch.from_numpy(WhittedOracle(jax_scene).render(jax_cam.make_camera(w, h, **cam)))
    rays = (*cam_mod.full_frame_rays(camera, device="cpu"), None)
    for level_kernel in (True, False):
        img = whitted.render(port, camera, DEPTH, level_kernel=level_kernel)["image"]
        # this axis-aligned view puts floor hits exactly on texel boundaries
        # (tests/test_whitted_kernel.py:33-38): those pixels must be borderline
        cmp = borderline.unexplained_pixels(
            lambda o, d, _: whitted.radiance(port, o, d, DEPTH, level_kernel)[0],
            rays, img, ref, atol=2e-3, rtol=1e-3,
        )
        assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
        assert cmp["bad"].numel() < 0.02 * w * h


def test_render_adaptive_drops_nothing():
    xml, w, h, cam = RENDERS["bunny_teapot"]
    port = scene_from_arrays(*jax_scene_arrays(jax_compile(xml)[0]))
    grows = []
    out = whitted.render_adaptive(
        port, cam_mod.make_camera(24, 16), cap_factor=0.01, on_grow=lambda *a: grows.append(a),
    )
    assert out["dropped"] == 0 and out["cap_factor"] == 0.01 and not grows
    assert out["levels"] > 1  # the teapot's dielectric makes children
    # the differentiable frame renders once too, through the host route
    small = cam_mod.make_camera(8, 4)
    diff = whitted.render_adaptive(port, small, differentiable=True)
    assert diff["dropped"] == 0 and diff["cap_factor"] == 0.25
    torch.testing.assert_close(diff["image"], whitted.render(port, small, level_kernel=False)["image"],
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("accel", ["grid", "kdtree", "wide"])
def test_other_accelerators_match_jax_host_route(accel):
    """bunny_teapot 64x40, depth 5, on the host route (the only route these
    scenes take) over the link walk or the wide walk, against the JAX
    package's host route over the same accelerator."""
    xml, w, h, cam = RENDERS["bunny_teapot"]
    if accel == "wide":
        jax_scene, _ = jax_compile_wide(xml)
        port, _ = compile_scene(xml, wide=True, device="cpu")
    else:
        jax_scene, _ = jax_compile(xml, accel=accel)
        port, _ = compile_scene(xml, accel=accel, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WHITTED_WF", "0")
        ref = np.asarray(jax_whitted.render(jax_scene, jax_cam.make_camera(w, h, **cam),
                                            depth_limit=DEPTH)["image"])
    camera = cam_mod.make_camera(w, h, **cam)
    out = whitted.render(port, camera, DEPTH)
    img = out["image"]
    assert out["dropped"] == 0 and out["levels"] > 1 and float(img.sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(port, o, d, DEPTH)[0],
        (*cam_mod.full_frame_rays(camera, device="cpu"), None), img, torch.from_numpy(ref.copy()),
    )
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
