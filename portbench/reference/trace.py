"""The reference's hits: every ray against every triangle, the light quad
and the floor plane, with no acceleration structure.

A triangle test is Moller-Trumbore's, with the reference renderer's
acceptance (infra/bvh.cpp): |det| >= 1e-4, u >= 0, v >= 0, u + v <= 1,
1e-4 < t < the nearest t so far.  Its four numbers are written as
products of per-ray and per-triangle vectors, so that a block of rays
takes them against all triangles in one matrix product:

    det   = e1 . (d x e2)            = -d . n                  (n = e1 x e2)
    u det = (o - v0) . (d x e2)      = (o x d) . e2 - d . (e2 x v0)
    v det = d . ((o - v0) x e1)      = -(o x d) . e1 - d . (v0 x e1)
    t det = e2 . ((o - v0) x e1)     = o . n - v0 . n

The light quad (object 0) is tested first, then the floor (object 1)
within the quad's t, then the triangles within the nearest of those, so
ties go as in the reference renderer.
"""

from __future__ import annotations

import torch

from portbench.reference.scene import FLOOR_Y, LIGHT_HALF, RefScene

TRI_EPS = 1e-4
RAY_FAR = 1e34
PAIRS_PER_BLOCK = 1 << 24  # ray-triangle pairs of one block


def triangle_matrix(scene: RefScene, v0=None, e1=None, e2=None) -> torch.Tensor:
    """[9, 4T]: the per-triangle columns of det, u det, v det and t det
    against the per-ray rows [d, o x d, o] (module docstring), with the
    constant of t det in a last row [1, 4T] returned apart."""
    v0 = scene.v0 if v0 is None else v0
    e1 = scene.e1 if e1 is None else e1
    e2 = scene.e2 if e2 is None else e2
    n = torch.cross(e1, e2, dim=-1)
    z = torch.zeros_like(n)
    det = torch.cat([-n, z, z], dim=1)
    u = torch.cat([-torch.cross(e2, v0, dim=-1), e2, z], dim=1)
    v = torch.cat([-torch.cross(v0, e1, dim=-1), -e1, z], dim=1)
    t = torch.cat([z, z, n], dim=1)
    const = torch.cat([torch.zeros_like(n[:, 0]).repeat(3), -(v0 * n).sum(-1)])
    return torch.cat([det, u, v, t], dim=0).T.contiguous(), const


def triangles(scene: RefScene, o, d, t_max, any_hit: bool = False, mat=None):
    """Nearest triangle hit of rays (o, d) [R, 3] within (TRI_EPS, t_max):
    (t, tri, u, v) with tri = -1 and t = t_max where none; with `any_hit`
    only whether one exists (bool [R])."""
    m, const = triangle_matrix(scene) if mat is None else mat
    n_tri = m.shape[1] // 4
    r = o.shape[0]
    block = max(1, PAIRS_PER_BLOCK // max(n_tri, 1))
    t_out = t_max.clone()
    tri_out = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    u_out, v_out = torch.zeros_like(t_max), torch.zeros_like(t_max)
    for s in range(0, r, block):
        ob, db, tb = o[s:s + block], d[s:s + block], t_max[s:s + block]
        rows = torch.cat([db, torch.cross(ob, db, dim=-1), ob], dim=1)
        prod = (rows @ m + const).view(-1, 4, n_tri)
        det, un, vn, tn = prod.unbind(1)
        inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
        u, v, t = un * inv, vn * inv, tn * inv
        ok = ((det.abs() >= TRI_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > TRI_EPS) & (t < tb[:, None]))
        if any_hit:
            tri_out[s:s + block] = ok.any(dim=1).long() - 1
            continue
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        best, idx = t.min(dim=1)
        found = ok.gather(1, idx[:, None])[:, 0]
        t_out[s:s + block] = torch.where(found, best, tb)
        tri_out[s:s + block] = torch.where(found, idx, -1)
        u_out[s:s + block] = torch.where(found, u.gather(1, idx[:, None])[:, 0], 0)
        v_out[s:s + block] = torch.where(found, v.gather(1, idx[:, None])[:, 0], 0)
    if any_hit:
        return tri_out >= 0
    return t_out, tri_out, u_out, v_out


def quad(scene: RefScene, o, d, t_max):
    """The light quad: (t, hit), hit iff 0 < t < t_max inside the square."""
    lo = o - scene.light_pos
    dy = torch.where(d[:, 1].abs() < 1e-20, torch.full_like(d[:, 1], 1e-20), d[:, 1])
    t = lo[:, 1] / -dy
    ix, iz = lo[:, 0] + t * d[:, 0], lo[:, 2] + t * d[:, 2]
    hit = ((t < t_max) & (t > 0) & (ix > -LIGHT_HALF) & (ix < LIGHT_HALF)
           & (iz > -LIGHT_HALF) & (iz < LIGHT_HALF))
    return t, hit


def nearest(scene: RefScene, o, d, mat=None) -> dict:
    """Nearest hit of rays (o, d) [R, 3]: t, obj (0 light, 1 floor, 2 a
    triangle, -1 none), tri (or -1), u, v."""
    far = torch.full_like(o[:, 0], RAY_FAR)
    obj = torch.full_like(o[:, 0], -1, dtype=torch.int64)
    tq, hq = quad(scene, o, d, far)
    t = torch.where(hq, tq, far)
    obj = torch.where(hq, 0, obj)
    dy = torch.where(d[:, 1].abs() < 1e-20, torch.full_like(d[:, 1], 1e-20), d[:, 1])
    tf = -(o[:, 1] - FLOOR_Y) / dy
    hf = (tf < t) & (tf > 0)
    t = torch.where(hf, tf, t)
    obj = torch.where(hf, 1, obj)
    t, tri, u, v = triangles(scene, o, d, t, mat=mat)
    obj = torch.where(tri >= 0, 2, obj)
    return dict(t=t, obj=obj, tri=tri, u=u, v=v)
