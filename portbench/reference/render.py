"""The reference integrators, written from the reference renderer's
semantics (willake/cpu-ray-tracer: 3. PathTracer/renderer.cpp,
2. WhittedStyle/renderer.cpp, template/tmplmath.cpp, template/camera.h)
in plain PyTorch, in the dtype of the scene they are given (float64 for
the check, a lower one for its control).

* Random numbers: a path's stream starts at WangHash((p + 1799 s + 1) 17)
  for pixel p and sample index s; each draw is an xorshift32 step, the
  uint32 rounded to float32 times 2.3283064365387e-10.  A camera ray draws
  its jitter (x, then y); every bounce draws the lobe, the Fresnel choice
  and two hemisphere numbers, in that order.
* Path tracer: the lobe is mirror below the reflectivity, dielectric
  below reflectivity + refractivity (reflect or refract by a Schlick
  Fresnel draw, IOR 1.2), diffuse otherwise (uniform hemisphere in a
  branchless Frisvad frame, weight albedo / pi * 2 pi * cos); a miss
  takes the sky and ends the path, a light hit takes the light's colour
  and ends it, the depth limit ends it after the sky check; Beer
  absorption inside; a new ray starts 1e-3 along its direction.
* Whitted: each level adds its rays' local radiance (the sky, the light,
  or diffuse: (1 - refl - refr) albedo / pi (irradiance + 0.3), the
  irradiance from the point light behind a shadow ray, which any
  triangle along the whole ray blocks, as the reference does) and
  spawns a mirror child, or a dielectric's reflected (Fresnel) and
  refracted (1 - Fresnel) children.

Nothing here imports the program or uses its tables: hits come from
`trace.nearest`, over the reference's own triangles.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import trace
from portbench.reference.scene import AMBIENT, RefScene

MASK = 0xFFFFFFFF
EPS = 1e-3
IOR = 1.2
SALT = 1799


# ---- random numbers -------------------------------------------------------

def _wang(s):
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & MASK
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & MASK
    return s ^ (s >> 15)


def seeds(pixel: torch.Tensor, spp: torch.Tensor) -> torch.Tensor:
    return _wang((((pixel + SALT * spp) & MASK) + 1) * 17 & MASK)


def draw(s: torch.Tensor, dtype):
    s = s ^ ((s << 13) & MASK)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & MASK)
    f = s.to(torch.float32) * np.float32(2.3283064365387e-10)
    return s, f.to(dtype)


# ---- camera ---------------------------------------------------------------

def camera_frame(pos, target, width: int, height: int) -> dict:
    """Corners of the screen plane (template/camera.h SetCameraState), in
    float64 numpy."""
    pos, target = np.asarray(pos, np.float64), np.asarray(target, np.float64)

    def unit(x):
        return x / np.linalg.norm(x)

    ahead = unit(target - pos)
    right = unit(np.cross([0.0, 1.0, 0.0], ahead))
    up = unit(np.cross(ahead, right))
    right = unit(np.cross(up, ahead))
    aspect = width / height
    centre = pos + 2 * ahead
    return dict(pos=pos, tl=centre - aspect * right + up, tr=centre + aspect * right + up,
                bl=centre - aspect * right - up, width=width, height=height)


def camera_rays(cam: dict, x, y, dtype):
    """Rays through continuous pixel coordinates (x, y) [N]."""
    dev = x.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev).to(dtype)

    tl = t(cam["tl"])
    p = (tl + (x / cam["width"])[:, None] * (t(cam["tr"]) - tl)
         + (y / cam["height"])[:, None] * (t(cam["bl"]) - tl))
    d = p - t(cam["pos"])
    d = d / d.norm(dim=-1, keepdim=True)
    return t(cam["pos"]).expand_as(d).contiguous(), d


# ---- shading ----------------------------------------------------------------

def _texel(tex: torch.Tensor, u, v):
    h, w = tex.shape[:2]
    x = (u.clamp(0, 1) * w).long().clamp(0, w - 1)
    y = ((1 - v.clamp(0, 1)) * h).long().clamp(0, h - 1)
    return tex[y, x]


def sky(scene: RefScene, d):
    phi = torch.atan2(-d[:, 2], d[:, 0]) + math.pi
    theta = torch.acos((-d[:, 1]).clamp(-1, 1))
    return _texel(scene.sky, phi / (2 * math.pi), theta / math.pi)


def hit_info(scene: RefScene, hit: dict, point, d):
    """Shading normal (facing the ray), uv and material slot of each hit."""
    obj, tri = hit["obj"], hit["tri"].clamp_min(0)
    u, v = hit["u"][:, None], hit["v"][:, None]
    w = 1 - u - v
    nt = scene.normals[tri]
    n_tri = w * nt[:, 0] + u * nt[:, 1] + v * nt[:, 2]
    n_tri = n_tri / n_tri.norm(dim=-1, keepdim=True).clamp_min(1e-10)
    ut = scene.uvs[tri]
    uv_tri = w * ut[:, 0] + u * ut[:, 1] + v * ut[:, 2]
    fx, fz = point[:, 0] * scene.floor_scale, point[:, 2] * scene.floor_scale
    uv_floor = torch.stack([fx - fx.floor(), fz - fz.floor()], dim=-1)
    up = torch.zeros_like(point)
    up[:, 1] = 1
    is_tri, is_floor = (obj == 2)[:, None], (obj == 1)[:, None]
    normal = torch.where(is_tri, n_tri, torch.where(is_floor, up, -up))
    uv = torch.where(is_tri, uv_tri, torch.where(is_floor, uv_floor, torch.zeros_like(uv_tri)))
    mat = torch.where(obj == 2, scene.tri_mat[tri], torch.where(obj == 1, 1, 0))
    mat = torch.where(obj < 0, scene.mat_albedo.shape[0] - 1, mat)
    flip = ((normal * d).sum(-1) > 0)[:, None]
    return torch.where(flip, -normal, normal), uv, mat


def albedo(scene: RefScene, mat, uv):
    out = scene.mat_albedo[mat]
    for slot, tex in enumerate(scene.mat_tex):
        if tex is not None:
            out = torch.where((mat == slot)[:, None], _texel(tex, uv[:, 0], uv[:, 1]), out)
    return out


def dielectric(d, n, inside):
    """Schlick Fresnel (1 under total internal reflection), whether a ray
    refracts, the refracted and the reflected directions."""
    ins = inside[:, None]
    n1 = torch.where(ins, IOR, 1.0).to(d.dtype)
    n2 = torch.where(ins, 1.0, IOR).to(d.dtype)
    eta = n1 / n2
    cosi = (-d * n).sum(-1, keepdim=True)
    cost2 = 1 - eta * eta * (1 - cosi * cosi)
    t_dir = eta * d + (eta * cosi - cost2.abs().sqrt()) * n
    can = cost2 > 0
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    fr = torch.where(can, r0 + (1 - r0) * (1 - cosi) ** 5, torch.ones_like(r0))
    r_dir = d - 2 * n * (n * d).sum(-1, keepdim=True)
    return fr[:, 0], can[:, 0], t_dir, r_dir


def hemisphere(n, r1, r2):
    """Uniform direction about n: z = r1, phi = 2 pi r2, in the branchless
    Frisvad frame of n."""
    nx, ny, nz = n.unbind(-1)
    s = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    r = (1 - r1 * r1).clamp_min(0).sqrt()
    phi = 2 * math.pi * r2
    return t * (r * phi.cos())[:, None] + bt * (r * phi.sin())[:, None] + n * r1[:, None]


def recompute(scene: RefScene, hit: dict, o, d) -> dict:
    """`hit` with t, u, v worked out again from the scene's current
    triangles (and the floor and quad planes), so that they carry
    gradients to the vertices and to the rays; which object was hit stays
    as found (visibility carries no gradient)."""
    tri = hit["tri"].clamp_min(0)
    v0, e1, e2 = scene.v0[tri], scene.e1[tri], scene.e2[tri]
    h = torch.cross(d, e2, dim=-1)
    a = (e1 * h).sum(-1)
    f = 1 / torch.where(a.abs() < 1e-20, torch.full_like(a, 1e-20), a)
    s = o - v0
    q = torch.cross(s, e1, dim=-1)
    u, v, t_tri = f * (s * h).sum(-1), f * (d * q).sum(-1), f * (e2 * q).sum(-1)
    dy = torch.where(d[:, 1].abs() < 1e-20, torch.full_like(d[:, 1], 1e-20), d[:, 1])
    t_floor = -(o[:, 1] + 1) / dy
    t_quad = (o[:, 1] - scene.light_pos[1]) / -dy
    obj = hit["obj"]
    is_tri = obj == 2
    t = torch.where(is_tri, t_tri, torch.where(obj == 1, t_floor,
                                               torch.where(obj == 0, t_quad, hit["t"])))
    return dict(hit, t=t, u=torch.where(is_tri, u, hit["u"]), v=torch.where(is_tri, v, hit["v"]))


# ---- the path tracer -------------------------------------------------------

def path_trace(scene: RefScene, cam: dict, pixels: torch.Tensor, spp: torch.Tensor,
               depth_limit: int = 5, hit_scene: RefScene | None = None):
    """Radiance [N, 3] of one path per (pixels[i], spp[i]), and the path
    segments traced.  With `hit_scene`, hits are found in its triangles and
    t, u, v worked out again in `scene`'s (`recompute`): the gradients'
    form, where `scene` carries parameters that require grad."""
    dt, dev = scene.dtype, scene.device
    seed = seeds(pixels, spp)
    seed, jx = draw(seed, dt)
    seed, jy = draw(seed, dt)
    w = cam["width"]
    o, d = camera_rays(cam, (pixels % w).to(dt) + jx, (pixels // w).to(dt) + jy, dt)
    n = pixels.shape[0]
    tp = torch.ones((n, 3), dtype=dt, device=dev)
    inside = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones_like(inside)
    missed, lit = torch.zeros_like(inside), torch.zeros_like(inside)
    mat_m = trace.triangle_matrix(hit_scene or scene)
    rays = 0
    for depth in range(depth_limit + 1):
        idx = torch.nonzero(alive).squeeze(1)
        rays += idx.numel()
        if idx.numel() == 0:
            break
        oi, di, ins, sd = o[idx], d[idx], inside[idx], seed[idx]
        with torch.no_grad():
            hit = trace.nearest(hit_scene or scene, oi.detach(), di.detach(), mat=mat_m)
        if hit_scene is not None:
            hit = recompute(scene, hit, oi, di)
        got = hit["obj"] >= 0
        missed[idx] = missed[idx] | ~got
        if depth >= depth_limit:
            got = torch.zeros_like(got)
        point = oi + hit["t"][:, None] * di
        normal, uv, mat = hit_info(scene, hit, point, di)
        alb = albedo(scene, mat, uv)
        is_light = scene.mat_light[mat] & got
        lit[idx] = lit[idx] | is_light
        surf = got & ~is_light
        medium = torch.where(ins[:, None], torch.exp(-scene.mat_absorb[mat] * hit["t"][:, None]),
                             torch.ones_like(alb))
        sd, r_lobe = draw(sd, dt)
        refl, refr = scene.mat_refl[mat], scene.mat_refr[mat]
        mirror = surf & (r_lobe < refl)
        diel = surf & ~mirror & (r_lobe < refl + refr)
        diff = surf & ~mirror & ~diel
        fr, can, t_dir, r_dir = dielectric(di, normal, ins)
        sd, r_fr = draw(sd, dt)
        refract = diel & can & (r_fr > fr)
        sd, r1 = draw(sd, dt)
        sd, r2 = draw(sd, dt)
        h_dir = hemisphere(normal, r1, r2)
        cos = (h_dir * normal).sum(-1).clamp_min(0)
        new_d = torch.where(diff[:, None], h_dir, torch.where(refract[:, None], t_dir, r_dir))
        weight = torch.where(diff[:, None], alb / math.pi * (2 * math.pi) * cos[:, None], alb)
        sf = surf[:, None]
        o = o.index_copy(0, idx, torch.where(sf, point + new_d * EPS, oi))
        d = d.index_copy(0, idx, torch.where(sf, new_d, di))
        tp = tp.index_copy(0, idx, torch.where(sf, tp[idx] * medium * weight, tp[idx]))
        seed[idx] = sd
        inside[idx] = refract & ~ins
        alive[idx] = surf
    rad = torch.where(lit[:, None], tp * scene.light_color, torch.zeros_like(tp))
    rad = rad + torch.where(missed[:, None], tp * sky(scene, d), torch.zeros_like(tp))
    return rad, rays


def pass_image(scene: RefScene, cam: dict, spp_index: int, depth_limit: int = 5,
               hit_scene: RefScene | None = None, rows: int = 1 << 18):
    """The radiance [H*W, 3] of one pass over every pixel, in blocks of
    `rows` pixels, and its path segments."""
    n = cam["width"] * cam["height"]
    out, rays = [], 0
    for s in range(0, n, rows):
        px = torch.arange(s, min(s + rows, n), device=scene.device)
        rad, r = path_trace(scene, cam, px, torch.full_like(px, spp_index), depth_limit,
                            hit_scene)
        out.append(rad)
        rays += r
    return torch.cat(out), rays


# ---- Whitted -----------------------------------------------------------------

def _irradiance(scene: RefScene, point, normal, mat_m):
    """The point light's irradiance at `point` through one shadow ray."""
    light = scene.light_pos - point.new_tensor((0.0, 0.01, 0.0))
    l = light - point
    dist = l.norm(dim=-1)
    l = l / dist.clamp_min(1e-20)[:, None]
    ndotl = (normal * l).sum(-1)
    so = point + l * EPS
    tq, hq = trace.quad(scene, so, l, (dist - 2 * EPS).clamp_min(1e-6))
    blocked = hq | trace.triangles(scene, so, l, torch.full_like(dist, trace.RAY_FAR),
                                   any_hit=True, mat=mat_m)
    vis = (ndotl >= EPS) & ~blocked
    irr = scene.light_color * (ndotl / (dist * dist).clamp_min(1e-20))[:, None]
    return torch.where(vis[:, None], irr, torch.zeros_like(irr))


def whitted(scene: RefScene, cam: dict, depth_limit: int = 5):
    """One unjittered Whitted frame: radiance [H*W, 3] and the rays of
    every level."""
    dt, dev = scene.dtype, scene.device
    n = cam["width"] * cam["height"]
    pix = torch.arange(n, device=dev)
    o, d = camera_rays(cam, (pix % cam["width"]).to(dt), (pix // cam["width"]).to(dt), dt)
    inside = torch.zeros(n, dtype=torch.bool, device=dev)
    weight = torch.ones((n, 3), dtype=dt, device=dev)
    film = torch.zeros((n, 3), dtype=dt, device=dev)
    ambient = torch.as_tensor(AMBIENT, device=dev).to(dt)
    mat_m = trace.triangle_matrix(scene)
    rays = 0
    for depth in range(depth_limit + 1):
        rays += o.shape[0]
        hit = trace.nearest(scene, o, d, mat=mat_m)
        got = hit["obj"] >= 0
        point = o + hit["t"][:, None] * d
        normal, uv, mat = hit_info(scene, hit, point, d)
        alb = albedo(scene, mat, uv)
        lit = scene.mat_light[mat] & got
        surf = got & ~lit
        refl, refr = scene.mat_refl[mat], scene.mat_refr[mat]
        diff = 1 - (refl + refr)
        diffuse = surf & (diff > 0)
        irr = torch.zeros_like(alb)
        k = torch.nonzero(diffuse).squeeze(1)
        irr[k] = _irradiance(scene, point[k], normal[k], mat_m)
        medium = torch.where(inside[:, None], torch.exp(-scene.mat_absorb[mat] * hit["t"][:, None]),
                             torch.ones_like(alb))
        c = torch.where((~got)[:, None], weight * sky(scene, d), torch.zeros_like(alb))
        c = torch.where(lit[:, None], weight * scene.light_color, c)
        local = diff[:, None] * (alb / math.pi) * (irr + ambient)
        c = torch.where(diffuse[:, None], c + weight * medium * local, c)
        film.index_add_(0, pix, c)
        if depth == depth_limit:
            break
        fr, can, t_dir, r_dir = dielectric(d, normal, inside)
        mirror = surf & (refl > 0)
        diel = surf & ~(refl > 0) & (refr > 0)
        i1 = torch.nonzero(mirror | diel).squeeze(1)
        i2 = torch.nonzero(diel & can).squeeze(1)
        if i1.numel() + i2.numel() == 0:
            break
        wm = weight * medium * alb
        w1 = torch.where(mirror[:, None], wm * refl[:, None], wm * fr[:, None])
        w2 = wm * (1 - fr)[:, None]
        o = torch.cat([(point + r_dir * EPS)[i1], (point + t_dir * EPS)[i2]])
        d = torch.cat([r_dir[i1], t_dir[i2]])
        weight = torch.cat([w1[i1], w2[i2]])
        inside = torch.cat([torch.zeros_like(inside[i1]), ~inside[i2]])
        pix = torch.cat([pix[i1], pix[i2]])
    return film, rays
