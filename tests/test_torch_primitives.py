"""The reference's analytic primitive scene in the PyTorch port against the
JAX package (`tests/test_primitives.py`):

* `core/noise.noise2d` bit-equal to the JAX package's: the lattice hash
  (int32 wraparound) and the interpolation's cosine (`noise._cosf`, the C
  library's float32 `cosf` that XLA on the CPU calls, in float64 as
  there), also on its own over the whole domain it serves;
* `ops/primitives`: sphere, cube and torus hits and normals against the
  JAX package's on seeded rays, hit flags equal and t at the parity
  tolerance (atol=2e-5, rtol=1e-4); the torus both in float32 (the JAX
  package's form) and as the scene solves it, in float64 (the reference's
  double), where a ray beyond the tolerance must be one where the float32
  and float64 solves of the quartic differ, JAX's agreeing with the
  float32 one (the count is printed);
* `compile_primitive_scene`: its tables equal the JAX package's (and the
  scene carried across with `prim_scene_from_arrays`), object ids by
  probe, the motion with `anim_time`;
* the albedo overrides, the clamped wall index included;
* Whitted (depth 3, 32x20) and the path tracer (depth 2, 16x10) against
  the JAX package's frames at the parity tolerance except fp-borderline
  pixels and pixels whose value the torus's float32 rounding decides
  (`primitive_scene.torus_sensitive`; the JAX Whitted frame with a child
  capacity that drops none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.core import noise as jax_noise
from cpu_ray_tracer_tpu.ops import primitives as jax_prim
from cpu_ray_tracer_tpu.render import basics as jax_basics
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu.scene import primitive_scene as jax_ps
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import noise
from cpu_ray_tracer_tpu_torch.ops import primitives as prim
from cpu_ray_tracer_tpu_torch.render import basics, borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import primitive_scene as ps
from cpu_ray_tracer_tpu_torch.scene import query
from cpu_ray_tracer_tpu_torch.scene.convert import prim_scene_from_arrays
from torch_parity import jax_prim_arrays, jax_reference_env

ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["t0", "t1"])
def scenes(request):
    return (jax_ps.compile_primitive_scene(request.param),
            ps.compile_primitive_scene(request.param, device="cpu"))


def test_noise2d_matches_jax(rng):
    x = rng.uniform(-200, 200, size=20000).astype(np.float32)
    y = rng.uniform(-200, 200, size=20000).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(10):  # every prime set of the lattice hash
        want = np.asarray(jax_noise._smoothed(jnp.floor(x), jnp.floor(y), i))
        got = noise._smoothed(torch.floor(tx), torch.floor(ty), i).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax_noise.noise2d(jnp.asarray(x), jnp.asarray(y)))
    got = noise.noise2d(tx, ty).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the cosine alone, on [0, pi) (noise2d's) and on (-120, 120)
    for lo, hi in ((0.0, np.pi), (-120.0, 120.0)):
        a = rng.uniform(lo, hi, size=200000).astype(np.float32)
        np.testing.assert_array_equal(noise._cosf(torch.from_numpy(a)).numpy().view(np.int32),
                                      np.asarray(jnp.cos(jnp.asarray(a))).view(np.int32))


def _rays(rng, centre, spread, n=4000):
    o = (centre + rng.normal(size=(n, 3)) * 2.5).astype(np.float32)
    d = (centre + rng.normal(size=(n, 3)) * spread) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e34, np.float32)


def _near(t, h, t_ref, h_ref):
    """Hit flags equal and t within the parity tolerance (numpy)."""
    return (h == h_ref) & np.isclose(t, t_ref, atol=ATOL, rtol=RTOL)


def test_primitives_match_jax(scenes, rng):
    js, port = scenes
    cases = {
        "sphere": (port.sphere_pos[0].numpy(), 0.5,
                   lambda m, s, o, d, t: m.sphere(o, d, s.sphere_pos[0], s.sphere_r2[0], t),
                   lambda m, s, p: m.sphere_normal(p, s.sphere_pos[0], s.sphere_inv_r[0])),
        "cube": (port.cube_m.numpy()[:3, 3], 0.5,
                 lambda m, s, o, d, t: m.cube(o, d, s.cube_inv_m, s.cube_bmin, s.cube_bmax, t),
                 lambda m, s, p: m.cube_normal(p, s.cube_m, s.cube_inv_m, s.cube_bmin,
                                               s.cube_bmax)),
        "torus": (port.torus_t.numpy()[:3, 3], 0.7,
                  lambda m, s, o, d, t: m.torus(o, d, s.torus_inv_t, s.torus_rc2, s.torus_rt2,
                                                s.torus_r2, t),
                  lambda m, s, p: m.torus_normal(p, s.torus_t, s.torus_inv_t, s.torus_rc2,
                                                 s.torus_rt2)),
    }
    # the scene's own torus solve, in float64
    cases["torus float64"] = (*cases["torus"][:2], lambda m, s, o, d, t: (
        m.torus(o, d, s.torus_inv_t, s.torus_rc2, s.torus_rt2, s.torus_r2, t) if m is jax_prim
        else ps._torus(s, o, d, t)), cases["torus"][3])
    for name, (centre, spread, hit_fn, normal_fn) in cases.items():
        o, d, t0 = _rays(rng, centre, spread)
        jt, jh = (np.asarray(x) for x in hit_fn(jax_prim, js, jnp.asarray(o), jnp.asarray(d),
                                                 jnp.asarray(t0)))
        tt, th = (x.numpy() for x in hit_fn(prim, port, torch.from_numpy(o), torch.from_numpy(d),
                                             torch.from_numpy(t0)))
        assert jh.sum() > 500, name
        beyond = ~_near(tt, th, jt, jh)
        if name.startswith("torus") and beyond.any():
            # explained by the quartic's precision: the port's float32 form
            # (the JAX package's) and its float64 solve on the same rays
            ob, db, tb = (torch.from_numpy(x[beyond]) for x in (o, d, t0))
            t32, h32 = (x.numpy() for x in prim.torus(ob, db, port.torus_inv_t, port.torus_rc2,
                                                        port.torus_rt2, port.torus_r2, tb))
            t64, h64 = (x.numpy() for x in ps._torus(port, ob, db, tb))
            if name == "torus":  # float32 against float32: one of them is off float64
                ok = ~_near(t32, h32, t64, h64) | ~_near(jt[beyond], jh[beyond], t64, h64)
            else:  # float64 against JAX's float32: JAX agrees with the float32 form
                ok = _near(jt[beyond], jh[beyond], t32, h32) & ~_near(t32, h32, t64, h64)
            assert ok.all(), (name, np.nonzero(beyond)[0][~ok][:10])
            print(f"{name}: {int(beyond.sum())} of {o.shape[0]} rays beyond tolerance, each "
                  "one where the float32 and float64 solves of the quartic differ")
        else:
            assert not beyond.any(), (name, np.nonzero(beyond)[0][:10])
        hit = jh & th
        p = (o + tt[:, None] * d)[hit]
        want = np.asarray(normal_fn(jax_prim, js, jnp.asarray(p)))
        got = normal_fn(prim, port, torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4, err_msg=name)


def test_known_hits():
    """The JAX package's TestSphere, TestCube and TestTorus cases."""
    one = lambda *v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    far = torch.tensor([1e34])
    t, hit = prim.sphere(one(0, 0, -3), one(0, 0, 1), torch.zeros(3), 1.0, far)
    assert bool(hit[0]) and abs(float(t[0]) - 2.0) < 1e-5
    t, hit = prim.sphere(one(0, 0, 0), one(0, 0, 1), torch.zeros(3), 1.0, far)  # inside
    assert bool(hit[0]) and abs(float(t[0]) - 1.0) < 1e-5
    assert not bool(prim.sphere(one(0, 5, -3), one(0, 0, 1), torch.zeros(3), 1.0, far)[1][0])
    half = torch.full((3,), 0.5)
    t, hit = prim.cube(one(0, 0, -3), one(0, 0, 1), torch.eye(4), -half, half, far)
    assert bool(hit[0]) and abs(float(t[0]) - 2.5) < 1e-5
    rc2, rt2, r2 = torch.tensor(0.64), torch.tensor(0.0625), torch.tensor(1.1025)
    t, hit = prim.torus(one(-3, 0, 0), one(1, 0, 0), torch.eye(4), rc2, rt2, r2, far)
    assert bool(hit[0]) and abs(float(t[0]) - 1.95) < 1e-3
    assert not bool(prim.torus(one(0, 0, -3), one(0, 0, 1), torch.eye(4), rc2, rt2, r2, far)[1][0])
    n = prim.torus_normal(one(1.05, 0, 0), torch.eye(4), torch.eye(4), rc2, rt2)
    np.testing.assert_allclose(n[0].numpy(), [1, 0, 0], atol=1e-4)


def test_scene_tables_match_jax(scenes):
    js, port = scenes
    carried = prim_scene_from_arrays(jax_prim_arrays(js))
    assert port.state_dict().keys() == carried.state_dict().keys()
    for k, v in port.state_dict().items():
        assert torch.equal(v, carried.state_dict()[k]), k
    m = js.materials
    for name, want in (("mat_albedo", m.albedo), ("mat_reflectivity", m.reflectivity),
                       ("mat_refractivity", m.refractivity), ("mat_absorption", m.absorption),
                       ("mat_tex_id", m.tex_id), ("mat_is_light", m.is_light)):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(want), err_msg=name)
    assert port.material_count == 12 and port.skydome_tex == -1 and not port.stack_kernels


def test_object_ids_and_motion():
    s0 = ps.compile_primitive_scene(0.0, device="cpu")
    res = ps.find_nearest(s0, torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[0.0, -1.0, 0.0]]))
    assert int(res["obj_idx"][0]) == 6 and abs(float(res["t"][0]) - 1.0) < 1e-5
    assert int(res["tested"][0]) == 11 and int(res["slot"][0]) == -1
    res = ps.find_nearest(s0, torch.tensor([[-1.8, -0.4, -3.0]]), torch.tensor([[0.0, 0.0, 1.0]]))
    assert int(res["obj_idx"][0]) == 1
    # the middle pixel of every object in a frame probes to that object
    cam = cam_mod.make_camera(64, 40)
    o, d = cam_mod.full_frame_rays(cam, device="cpu")
    ids = query.find_nearest(s0, o, d)["obj_idx"]
    seen = torch.unique(ids).tolist()
    assert len(seen) >= 9
    for obj in seen:
        where = torch.nonzero(ids == obj).squeeze(1)
        y, x = divmod(int(where[where.numel() // 2]), 64)
        assert basics.probe(s0, cam, x, y)["obj_idx"] == obj
    s1 = ps.compile_primitive_scene(1.0, device="cpu")
    assert not torch.allclose(s0.sphere_pos[0], s1.sphere_pos[0])
    assert not torch.allclose(s0.cube_m, s1.cube_m)
    assert not torch.allclose(s0.light_t, s1.light_t)
    assert torch.equal(s0.torus_t, s1.torus_t)


def test_albedo_overrides_match_jax(scenes):
    """The floor's checkerboard (its aliased tiles included) and the walls'
    textures at points on each plane; with the fallback textures the wall
    index passes the atlas's end and is clamped, as XLA clamps."""
    js, port = scenes
    rng = np.random.default_rng(5)
    n = 3000
    pts = rng.uniform(-3, 4, size=(n, 3)).astype(np.float32)
    obj = rng.integers(4, 7, size=n).astype(np.int32)
    pts[obj == 4, 0], pts[obj == 5, 0], pts[obj == 6, 1] = -3.0, 2.99, -1.0
    # the aliased floor tiles: ix, iz = 98, 98 and 94, 98
    pts[:40, 0] = rng.uniform(0.96, 1.45, 40)
    pts[40:80, 0] = rng.uniform(-1.04, -0.55, 40)
    pts[:80, 2] = rng.uniform(0.96, 1.45, 80)
    obj[:80] = 6
    want = np.asarray(jax_ps.get_albedo_override(js, jnp.asarray(obj), jnp.asarray(pts)))
    got = ps.get_albedo_override(port, torch.from_numpy(obj), torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[obj == 6, 0])) == 2
    last = port.atlas_texels.shape[0] - 1
    wall_idx = (((pts[:, 2] - 4.0) * (512 / 7.0)).astype(np.int32) & 511) \
        + (((2.0 - pts[:, 1]) * (512 / 3.0)).astype(np.int32) & 511) * 512
    assert (wall_idx[obj == 4] > last).any()  # the clamp is taken
    # through the albedo AOV as well
    cam = cam_mod.make_camera(24, 16)
    img = basics.render(port, cam, "albedo").numpy()
    np.testing.assert_array_equal(img, np.asarray(jax_basics.render(js, jax_cam.make_camera(24, 16),
                                                                      aov="albedo")))


@pytest.mark.parametrize("kind, w, h, depth", [("whitted", 32, 20, 3), ("pathtracer", 16, 10, 2)])
def test_render_matches_jax(scenes, kind, w, h, depth):
    js, port = scenes
    camera = cam_mod.make_camera(w, h)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WHITTED_WF", "0")
        if kind == "whitted":
            # the JAX frame at its default child capacity drops rays here
            out = jax_whitted.render(js, jax_cam.make_camera(w, h), depth_limit=depth,
                                     cap_factor=2.0)
            assert int(out["dropped"]) == 0
            ref = np.asarray(out["image"])
        else:
            ref, st = jax_pt.render_pass(js, jax_cam.make_camera(w, h), jnp.uint32(1),
                                         depth_limit=depth)
            ref, rays = np.asarray(ref), int(st["rays_traced"])
    if kind == "whitted":
        img = whitted.render(port, camera, depth)["image"]
        radiance = lambda o, d, _: whitted.radiance(port, o, d, depth)[0]  # noqa: E731
        ray_set = (*cam_mod.full_frame_rays(camera, device="cpu"), None)
    else:
        img, st = pathtracer.render_pass(port, camera, 1, depth)
        assert st["rays_traced"] == rays
        radiance = lambda o, d, s: pathtracer.sample_radiance(port, o, d, s, depth)[0]  # noqa: E731
        ray_set = pathtracer.camera_rays(camera, 1, "cpu")
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    cmp = borderline.unexplained_pixels(radiance, ray_set, img, torch.from_numpy(ref.copy()))
    left = cmp["unexplained"]
    if left.numel():
        o, d, s = ray_set
        left = left[~ps.torus_sensitive(radiance, o[left], d[left], None if s is None else s[left])]
    print(f"primitive scene {kind}: pixels beyond tolerance {cmp['bad'].numel()}, not "
          f"fp-borderline {cmp['unexplained'].numel()}, of which decided by the torus's float32 "
          f"rounding {cmp['unexplained'].numel() - left.numel()}")
    assert left.numel() == 0, left.tolist()


def test_shadow_query_and_differentiable_render():
    """The reference's shadow set (cube, sphere 1, quad, torus: not the
    planes or sphere 2), and a differentiable frame whose gradients reach
    the material table and the light colour."""
    port = ps.compile_primitive_scene(0.0, device="cpu")
    o = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 0.0, 0.0]])
    assert not query.is_occluded(port, o, d, torch.tensor([5.0, 5.0])).any()
    from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod

    params = grad_mod.extract_params(port, ("albedo", "light_color"))
    loss_fn = grad_mod.make_loss_fn(
        port, lambda sc: pathtracer.render_pass(sc, cam_mod.make_camera(8, 5), 1, 2,
                                                differentiable=True)[0],
        torch.zeros(5, 8, 3))
    value, grads = grad_mod.value_and_grad(loss_fn, params)
    assert float(value) > 0
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0, k
