"""Ray sets for the closest-hit tests, made with numpy from a seed, and the
numpy checks that hold two walks' hits to each other (no JAX here: the
card's tests import this too)."""

import os

import numpy as np

from cpu_ray_tracer_tpu_torch.scene.synthetic import write_scene_xml


def node_bounds(nodes: np.ndarray):
    """(bmin [M, 3], bmax [M, 3]) of the port's int32 node records."""
    f = np.ascontiguousarray(nodes).view(np.float32)
    return f[:, 0:3], f[:, 3:6]


def random_rays(bmin, bmax, n: int, seed: int):
    """Bounce-like rays: origins scattered over the world box (grown by a
    quarter), uniform directions, t0 = 1e34, about a fifth masked off."""
    rng = np.random.default_rng(seed)
    lo, hi = bmin.min(axis=0), bmax.max(axis=0)
    ext = hi - lo
    o = rng.uniform(lo - 0.25 * ext, hi + 0.25 * ext, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, 1e34, np.float32)
    mask = rng.uniform(size=n) > 0.2
    return o, d.astype(np.float32), t0, mask


def shadow_rays(bmin, bmax, n: int, seed: int):
    """`random_rays` whose t0 is a random distance in [0.05, 3), so that the
    bound cuts many hits, as a shadow ray's distance to the light does."""
    o, d, _, mask = random_rays(bmin, bmax, n, seed)
    t0 = np.random.default_rng(seed + 1).uniform(0.05, 3.0, size=n).astype(np.float32)
    return o, d, t0, mask


def mt64(pool, tri, o, d):
    """Moller-Trumbore in float64 of rays against pool triangles: (t, u, v)
    and a first-order bound of the float32 rounding error of u and v: a few
    roundings of each operand, amplified by 1/det (large for slivers and
    near-tangent rays)."""
    v0, e1, e2 = (pool[tri, 3 * k : 3 * k + 3].astype(np.float64) for k in range(3))
    o, d = o.astype(np.float64), d.astype(np.float64)
    h = np.cross(d, e2)
    f = 1.0 / np.einsum("ij,ij->i", e1, h)
    s = o - v0
    q = np.cross(s, e1)
    u, v = f * np.einsum("ij,ij->i", s, h), f * np.einsum("ij,ij->i", d, q)
    n = lambda x: np.linalg.norm(x, axis=-1)  # noqa: E731
    scale = (n(o) + n(v0)) * n(d) * (n(e1) + n(e2)) * (1.0 + np.abs(u) + np.abs(v))
    err = 8 * 2.0**-24 * np.abs(f) * scale
    return f * np.einsum("ij,ij->i", e2, q), u, v, err


def assert_hits_agree(got: dict, want: dict, pool, o, d, atol=2e-5, rtol=1e-4) -> np.ndarray:
    """Two closest-hit results (numpy dicts with `t` and `tri_idx`) of the
    same rays: t within (atol, rtol), and the triangle ids equal except at
    ties, where t agrees to 1e-6 relative and both triangles are hits of
    the ray at that t (a shared edge or vertex, or two triangles through
    one point).  Returns the mask of rays whose ids agree."""
    np.testing.assert_allclose(got["t"], want["t"], atol=atol, rtol=rtol)
    differ = got["tri_idx"] != want["tri_idx"]
    far_apart = np.abs(got["t"] - want["t"]) > 1e-6 * np.abs(want["t"])
    assert not (differ & far_apart).any(), np.nonzero(differ & far_apart)[0]
    tie = np.nonzero(differ)[0]
    if tie.size:
        for ids in (got["tri_idx"][tie], want["tri_idx"][tie]):
            assert (ids >= 0).all()
            t, u, v, _ = mt64(pool, ids, o[tie], d[tie])
            np.testing.assert_allclose(t, got["t"][tie], rtol=1e-5)
            assert ((u > -1e-5) & (v > -1e-5) & (u + v < 1 + 1e-5)).all()
    return ~differ


def axis_aligned_rays(bmin, bmax, n: int, seed: int):
    """Rays whose directions have components exactly 0 and whose origins
    lie exactly on slab planes of the BVH's nodes: the slab test meets
    (plane - origin) * inf = 0 * inf = NaN there."""
    rng = np.random.default_rng(seed)
    m = bmin.shape[0]
    lo, hi = bmin.min(axis=0), bmax.max(axis=0)
    dirs = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
         [0.6, 0, 0.8], [0, -0.8, 0.6], [-0.6, 0.8, 0], [-0.0, -0.0, -1.0]], np.float32,
    )
    o = np.empty((n, 3), np.float32)
    d = np.empty((n, 3), np.float32)
    for i in range(n):
        k = rng.integers(m)
        di = dirs[rng.integers(len(dirs))]
        # a point inside node k's box, then every coordinate along a zero
        # direction component snapped onto one of the box's slab planes
        p = rng.uniform(bmin[k], np.maximum(bmax[k], bmin[k])).astype(np.float32)
        for a in range(3):
            if di[a] == 0:
                p[a] = (bmin[k] if rng.integers(2) else bmax[k])[a]
        # back off along the ray to outside the world box
        back = float(np.max(hi - lo)) * 1.5
        o[i] = p - di * np.float32(back)  # zero axes keep p exactly
        d[i] = di
    t0 = np.full(n, 1e34, np.float32)
    return o, d, t0, np.ones(n, bool)


QUAD_HEIGHTS = (-0.5, 0.0, 0.25, 0.7)


def flat_quads_xml(directory, assets: str) -> str:
    """Write a scene of four axis-aligned unit quads at the heights
    QUAD_HEIGHTS (an OBJ and an XML into `directory`) and return the XML's
    path.  Each quad is its own instance, so its BVH is one leaf whose box
    has zero extent in y: a ray with d.y == 0 in that plane meets
    (y - y) * inf = NaN on both y slabs, where a NaN-dropping min/max would
    let it in."""
    obj = os.path.join(directory, "quad.obj")
    with open(obj, "w") as f:
        f.write("v -0.5 0 -0.5\nv 0.5 0 -0.5\nv 0.5 0 0.5\nv -0.5 0 0.5\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 1 0\n"
                "f 1/1/1 2/2/1 3/3/1 4/4/1\n")
    objects = [(obj, 0, (0.3 * i, y, 2.0 + 0.4 * i), (1, 1, 1))
               for i, y in enumerate(QUAD_HEIGHTS)]
    return write_scene_xml(directory, "flat_quads", assets, objects)


def in_plane_rays(n: int, seed: int):
    """Rays with d.y == 0 lying exactly in one quad's plane, starting
    outside the quads: under the NaN rule they enter no quad's leaf."""
    rng = np.random.default_rng(seed)
    y = np.asarray(QUAD_HEIGHTS, np.float32)[rng.integers(len(QUAD_HEIGHTS), size=n)]
    ang = rng.uniform(0, 2 * np.pi, size=n)
    d = np.stack([np.cos(ang), np.zeros(n), np.sin(ang)], axis=1).astype(np.float32)
    d[::3] = np.array([1, 0, 0], np.float32)  # some with two zero components
    o = np.stack([np.full(n, 0.45), y, np.full(n, 2.6)], axis=1).astype(np.float32) - 4 * d
    o[:, 1] = y
    return o, d, np.full(n, 1e34, np.float32), np.ones(n, bool)
