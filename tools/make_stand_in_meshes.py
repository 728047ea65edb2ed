"""Write procedural stand-ins for the three meshes the in-tree scene XMLs
name but the repo does not ship:

* assets/cube.obj   -- the reference's 12-triangle cube (per-face normals
  and UVs, one quad per face, fan-triangulated by the loader);
* assets/bunny.obj  -- stand-in for the Stanford bunny: a lumpy body with a
  head bump and two ears, 4,968 triangles;
* assets/teapot.obj -- stand-in for the Utah teapot: a lathed body with a
  lid knob, a torus handle and a lathed spout, 2,992 triangles.

bunny + 2 x teapot = 10,952 triangles, the count `bunny_teapot.xml` had
with the upstream meshes.  Every part is a closed surface with smooth
(area-weighted, seam-merged) vertex normals and a UV parameterisation.
The first line of each file says what it stands in for.

numpy only, deterministic (fixed seed).  Run from the repo root:

    python tools/make_stand_in_meshes.py
"""

import os

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
SEED = 20261016


def sphere_grid(fn, segs, bands):
    """A closed pole-to-pole surface from `fn(theta, phi) -> [..., 3]`
    (theta in [0, pi] from the top pole, phi in [0, 2pi]).

    Rows 0 and `bands` are the poles; column `segs` repeats column 0's
    position with u = 1 (the UV seam).  Returns (positions [V, 3],
    uvs [V, 2], faces [F, 3]) with F = 2 * segs * (bands - 1)."""
    theta = np.linspace(0.0, np.pi, bands + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, segs + 1)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    pos = fn(th, ph)
    pos[:, segs] = pos[:, 0]
    pos[0, :] = pos[0, 0]
    pos[bands, :] = pos[bands, 0]
    u, v = np.meshgrid(np.linspace(0, 1, segs + 1), np.linspace(1, 0, bands + 1), indexing="xy")
    uv = np.stack([u, v], axis=-1)
    vid = np.arange((bands + 1) * (segs + 1)).reshape(bands + 1, segs + 1)
    faces = []
    for i in range(bands):
        for j in range(segs):
            a, b = vid[i, j], vid[i, j + 1]
            c, d = vid[i + 1, j + 1], vid[i + 1, j]
            if i == 0:
                faces.append((a, c, d))
            elif i == bands - 1:
                faces.append((a, b, c))
            else:
                faces.append((a, b, c))
                faces.append((a, c, d))
    return pos.reshape(-1, 3), uv.reshape(-1, 2), np.asarray(faces, np.int64)


def torus_grid(center, axis_u, axis_v, major, minor, segs, rings):
    """Closed torus around `center` in the plane (axis_u, axis_v); 2 *
    segs * rings triangles."""
    a = np.linspace(0.0, 2.0 * np.pi, segs + 1)
    b = np.linspace(0.0, 2.0 * np.pi, rings + 1)
    aa, bb = np.meshgrid(a, b, indexing="ij")
    normal = np.cross(axis_u, axis_v)
    ring = np.cos(aa)[..., None] * axis_u + np.sin(aa)[..., None] * axis_v
    pos = center + (major + minor * np.cos(bb))[..., None] * ring + (minor * np.sin(bb))[..., None] * normal
    pos[segs, :] = pos[0, :]
    pos[:, rings] = pos[:, 0]
    u, v = np.meshgrid(np.linspace(0, 1, rings + 1), np.linspace(0, 1, segs + 1), indexing="xy")
    uv = np.stack([u, v], axis=-1)
    vid = np.arange((segs + 1) * (rings + 1)).reshape(segs + 1, rings + 1)
    faces = []
    for i in range(segs):
        for j in range(rings):
            p, q = vid[i, j], vid[i, j + 1]
            r, s = vid[i + 1, j + 1], vid[i + 1, j]
            faces.append((p, r, q))
            faces.append((p, s, r))
    return pos.reshape(-1, 3), uv.reshape(-1, 2), np.asarray(faces, np.int64)


def smooth_normals(pos, faces):
    """Area-weighted vertex normals, merged over vertices that share a
    position (UV seams and poles), so the shading is smooth everywhere."""
    key = np.round(pos, 6)
    _, group = np.unique(key, axis=0, return_inverse=True)
    group = group.reshape(-1)
    fn = np.cross(pos[faces[:, 1]] - pos[faces[:, 0]], pos[faces[:, 2]] - pos[faces[:, 0]])
    acc = np.zeros((group.max() + 1, 3))
    for k in range(3):
        np.add.at(acc, group[faces[:, k]], fn)
    n = acc[group]
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def merge(parts):
    pos, uv, faces, base = [], [], [], 0
    for p, t, f in parts:
        pos.append(p)
        uv.append(t)
        faces.append(f + base)
        base += p.shape[0]
    return np.concatenate(pos), np.concatenate(uv), np.concatenate(faces)


def write_obj(path, header, pos, uv, nrm, faces):
    with open(path, "w") as f:
        f.write(header + "\n")
        for p in pos:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in uv:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for n in nrm:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
    print("wrote", path, len(faces), "triangles")


def cube(path):
    corners = np.array(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64,
    )
    # (corner indices counter-clockwise seen from outside, face normal)
    quads = [
        ((0, 3, 2, 1), (0, 0, -1)), ((4, 5, 6, 7), (0, 0, 1)),
        ((0, 4, 7, 3), (-1, 0, 0)), ((1, 2, 6, 5), (1, 0, 0)),
        ((0, 1, 5, 4), (0, -1, 0)), ((3, 7, 6, 2), (0, 1, 0)),
    ]
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    with open(path, "w") as f:
        f.write("# stand-in for the reference's cube.obj: 12-triangle cube, per-face normals and UVs\n")
        for c in corners:
            f.write(f"v {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")
        for t in uvs:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for _, n in quads:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for fi, (q, _) in enumerate(quads):
            f.write("f " + " ".join(f"{c + 1}/{k + 1}/{fi + 1}" for k, c in enumerate(q)) + "\n")
    print("wrote", path, 12, "triangles")


def bunny(path, rng):
    # low-order seeded lumps on an ellipsoid body, a head bump up front
    lumps = [(rng.integers(1, 4), rng.integers(1, 4), rng.uniform(0, 2 * np.pi), rng.uniform(0.02, 0.05))
             for _ in range(6)]
    head = np.array([0.0, 0.55, 0.65])
    head /= np.linalg.norm(head)

    def body(th, ph):
        d = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], axis=-1)
        r = 1.0 + 0.35 * np.exp(-np.sum((d - head) ** 2, axis=-1) / 0.25)
        for m, n, phase, amp in lumps:
            r = r + amp * np.sin(m * th) * np.cos(n * ph + phase)
        return d * r[..., None] * np.array([0.5, 0.45, 0.55]) + np.array([0.0, 0.5, 0.0])

    parts = [sphere_grid(body, 54, 37)]
    for side in (-1.0, 1.0):
        tilt = np.radians(15.0) * side

        def ear(th, ph, side=side, tilt=tilt):
            x = 0.07 * np.sin(th) * np.cos(ph)
            y = 0.32 * np.cos(th)
            z = 0.035 * np.sin(th) * np.sin(ph)
            xr = x * np.cos(tilt) - y * np.sin(tilt)
            yr = x * np.sin(tilt) + y * np.cos(tilt)
            return np.stack([xr + 0.14 * side, yr + 1.12, z + 0.2], axis=-1)

        parts.append(sphere_grid(ear, 18, 16))
    pos, uv, faces = merge(parts)
    write_obj(path, "# stand-in for the Stanford bunny (bunny.obj): procedural, closed, smooth normals",
              pos, uv, smooth_normals(pos, faces), faces)


def teapot(path):
    def body(th, ph):
        s = th / np.pi  # 0 at the lid knob, 1 at the base centre
        side = 0.35 + 0.3 * np.sin(np.clip(s - 0.2, 0.0, 0.8) / 0.8 * np.pi) ** 0.8
        r = np.where(
            s < 0.12, 0.12 * np.sin(s / 0.12 * np.pi / 2),  # knob
            np.where(s < 0.2, 0.12 + 0.23 * (s - 0.12) / 0.08,  # lid
                     side * np.clip((1.0 - s) / 0.05, 0.0, 1.0)))  # body, base
        y = np.where(s < 0.12, 0.95 - 0.12 * s / 0.12,
                     np.where(s < 0.2, 0.83 - 0.02 * (s - 0.12) / 0.08,
                              0.81 - 0.81 * (s - 0.2) / 0.8))
        return np.stack([r * np.cos(ph), y, r * np.sin(ph)], axis=-1)

    def spout(th, ph):
        s = th / np.pi
        r = 0.09 - 0.04 * s + 0.02 * np.sin(s * np.pi)
        r = r * np.sin(np.clip(s, 0.0, 1.0) * np.pi) ** 0.3
        length = 0.55 * s
        # a tube along a rising direction, capped by the pole-to-pole lathe
        axis = np.array([0.8, 0.6, 0.0])
        side1 = np.array([-0.6, 0.8, 0.0])
        side2 = np.array([0.0, 0.0, 1.0])
        p = (length[..., None] * axis + (r * np.cos(ph))[..., None] * side1
             + (r * np.sin(ph))[..., None] * side2)
        return p + np.array([0.5, 0.3, 0.0])

    parts = [
        sphere_grid(body, 40, 26),
        torus_grid(np.array([-0.62, 0.42, 0.0]), np.array([1.0, 0.0, 0.0]),
                   np.array([0.0, 1.0, 0.0]), 0.2, 0.04, 16, 10),
        sphere_grid(spout, 16, 22),
    ]
    pos, uv, faces = merge(parts)
    write_obj(path, "# stand-in for the Utah teapot (teapot.obj): procedural, closed, smooth normals",
              pos, uv, smooth_normals(pos, faces), faces)


if __name__ == "__main__":
    rng = np.random.default_rng(SEED)
    cube(os.path.join(ASSETS, "cube.obj"))
    bunny(os.path.join(ASSETS, "bunny.obj"), rng)
    teapot(os.path.join(ASSETS, "teapot.obj"))
