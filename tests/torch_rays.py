"""Ray sets for the closest-hit tests, made with numpy from a seed (no JAX
here: the card's tests import this too)."""

import os

import numpy as np


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
    xyz = lambda tag, x, y, z: f"<{tag}><x>{x}</x><y>{y}</y><z>{z}</z></{tag}>"  # noqa: E731
    objects = "".join(
        f"<object><model_location>{obj}</model_location><material_idx>0</material_idx>"
        + xyz("position", 0.3 * i, y, 2.0 + 0.4 * i) + xyz("rotation", 0, 0, 0)
        + xyz("scale", 1, 1, 1) + "</object>"
        for i, y in enumerate(QUAD_HEIGHTS)
    )
    xml = os.path.join(directory, "flat_quads.xml")
    with open(xml, "w") as f:
        f.write(
            "<scene><scene_name>flat quads</scene_name>" + xyz("light_position", 0, 2, 1)
            + f"<plane_texture_location>{assets}/textures/log_fence.png</plane_texture_location>"
            + f"<skydome_location>{assets}/industrial_sunset_puresky_4k.png</skydome_location>"
            + f"<objects>{objects}</objects><materials><material><reflectivity>0</reflectivity>"
            + "<refractivity>0</refractivity>" + xyz("absorption", 0, 0, 0)
            + "<texture_location></texture_location></material></materials></scene>"
        )
    return xml


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
