"""The reference's scene: what the program's set-up derives, worked out
again from the raw files (the scene XML, its OBJ meshes, its PNG textures)
in plain NumPy, then held as PyTorch tensors in the reference's dtype.

Semantics of the reference renderer (willake/cpu-ray-tracer), as the
scene format defines them:

* TLAS layout: each object's scale is baked into its vertices, then its
  rigid transform T = translate @ rot_x @ rot_y @ rot_z is applied;
  normals are rotated by T's rotation, not rescaled; a vertex normal of
  length under 1e-8 is replaced by the triangle's geometric normal;
* OBJ faces of more than three corners are fans (v0, v_i, v_i+1); a
  missing normal or uv index gives zeros;
* materials: slot 0 the light quad's, slot 1 the floor's (its texture),
  slots 2.. the XML's in file order, the last slot the error pink; an
  object's triangles take slot 2 + material_idx;
* the light is a quad of half-extent 0.5 in its local XZ plane, moved by
  translate(light_position), colour (24, 24, 22); the point light of the
  Whitted shadow rays sits 0.01 below the quad's centre;
* the floor is the plane y = -1, normal +y, textured with
  u = frac(x * s), v = frac(z * s), s = 100 / floor texture width;
* the sky is an equirectangular map; a `.hdr` named in the XML that the
  tree does not hold is read from the `.png` of the same name.

Nothing here imports the program.  The PNG decoder is a frozen copy of
the program's stdlib decoder (`cpu_ray_tracer_tpu_torch/io/image.py`,
`decode_png` and `_unfilter`), kept here so that no later change of the
program can move it.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import xml.etree.ElementTree as ET
import zlib

import numpy as np
import torch

LIGHT_HALF = 0.5
LIGHT_COLOR = (24.0, 24.0, 22.0)
AMBIENT = (0.3, 0.3, 0.3)
FLOOR_Y = -1.0
PINK = (1.0, 192 / 255.0, 203 / 255.0)


@dataclasses.dataclass
class RefScene:
    """World-space triangles and the tables the reference renders from, as
    tensors of one dtype on one device."""

    v0: torch.Tensor  # [T, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    normals: torch.Tensor  # [T, 3, 3] vertex normals, world space
    uvs: torch.Tensor  # [T, 3, 2]
    tri_mat: torch.Tensor  # int64 [T], material slot
    mat_albedo: torch.Tensor  # [M, 3]
    mat_refl: torch.Tensor  # [M]
    mat_refr: torch.Tensor  # [M]
    mat_absorb: torch.Tensor  # [M, 3]
    mat_tex: list  # per slot: None or a texture [H, W, 3] tensor (values u8 / 255)
    mat_light: torch.Tensor  # bool [M]
    light_pos: torch.Tensor  # [3], the quad's centre
    light_color: torch.Tensor  # [3]
    floor_scale: float
    sky: torch.Tensor  # [H, W, 3]

    @property
    def dtype(self):
        return self.v0.dtype

    @property
    def device(self):
        return self.v0.device

    def params(self) -> dict:
        """The differentiable quantities, by the names of the program's
        parameter keys: the XML's material table (all slots), the light
        colour, the triangles' v0, e1, e2."""
        return dict(albedo=self.mat_albedo, reflectivity=self.mat_refl,
                    refractivity=self.mat_refr, absorption=self.mat_absorb,
                    light_color=self.light_color, v0=self.v0, e1=self.e1, e2=self.e2)

    def with_params(self, params: dict) -> "RefScene":
        names = dict(albedo="mat_albedo", reflectivity="mat_refl", refractivity="mat_refr",
                     absorption="mat_absorb", light_color="light_color")
        fields = {names.get(k, k): v for k, v in params.items()}
        return dataclasses.replace(self, **fields)


def _xyz(node) -> np.ndarray:
    out = np.zeros(3)
    for child in node:
        out["xyz".index(child.tag[0])] = float(child.text)
    return out


def resolve(rel: str, xml_dir: str) -> str:
    """An XML path: `../X` lands beside the scene folder's parent (the
    reference's binaries run from a project folder next to `assets/`);
    a missing `.hdr` is read from the `.png` of the same name."""
    rel = rel.replace("\\", "/")
    base = os.path.dirname(os.path.dirname(xml_dir)) if rel.startswith("../") else xml_dir
    path = os.path.normpath(os.path.join(base, rel[3:] if rel.startswith("../") else rel))
    if not os.path.isfile(path) and path.lower().endswith(".hdr"):
        path = path[:-4] + ".png"
    if not os.path.isfile(path):
        raise FileNotFoundError(f"asset {rel!r} of the scene: {path} does not exist")
    return path


def load_obj(path: str):
    """Triangles of an OBJ file: positions [F, 3, 3], normals [F, 3, 3],
    uvs [F, 3, 2], float64, faces fanned."""
    v, vn, vt, corners = [], [], [], []
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                v.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                vn.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vt.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                face = []
                for tok in parts[1:]:
                    c = tok.split("/")

                    def index(i, n):
                        if len(c) <= i or not c[i]:
                            return -1
                        k = int(c[i])
                        return k - 1 if k > 0 else n + k

                    face.append((index(0, len(v)), index(1, len(vt)), index(2, len(vn))))
                for k in range(1, len(face) - 1):
                    corners += [face[0], face[k], face[k + 1]]
    idx = np.asarray(corners, np.int64).reshape(-1, 3, 3)
    pos = np.asarray(v, np.float64)[idx[..., 0]]
    nrm_tab = np.concatenate([np.asarray(vn, np.float64).reshape(-1, 3), np.zeros((1, 3))])
    uv_tab = np.concatenate([np.asarray(vt, np.float64).reshape(-1, 2), np.zeros((1, 2))])
    return pos, nrm_tab[idx[..., 2]], uv_tab[idx[..., 1]]


def decode_png(path: str) -> np.ndarray:
    """uint8 [H, W, C] of an 8-bit non-interlaced PNG (frozen copy, see the
    module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, colour, compression, filtering, interlace = header
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(colour)
    if depth != 8 or channels is None or compression or filtering or interlace:
        raise ValueError(f"{path}: unsupported PNG")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(height, 1 + width * channels)
    kinds, filt = rows[:, 0].astype(np.int32), rows[:, 1:].reshape(height, width, channels)
    h, w, c = filt.shape
    out = np.zeros((h + 1, w + 1, c), np.int32)
    filt = filt.astype(np.int32)
    for k in range(h + w - 1):  # one anti-diagonal at a time
        ys = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        xs = k - ys
        a, b, cc = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        kind = kinds[ys][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], default=0)
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def load_texture(path: str) -> np.ndarray:
    """float64 [H, W, 3] = u8 / 255 (grey expands to RGB, alpha dropped)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the reference reads PNG textures only")
    img = decode_png(path)
    if img.shape[-1] <= 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3].astype(np.float64) / 255.0


def _rot(axis: int, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m = np.eye(3)
    m[i, i], m[j, j] = c, c
    m[i, j], m[j, i] = (-s, s) if axis != 1 else (s, -s)
    return m


def load_scene(xml_path: str, dtype=torch.float64, device="cpu") -> RefScene:
    """The scene of `xml_path` in the TLAS layout (module docstring)."""
    xml_dir = os.path.dirname(os.path.abspath(xml_path))
    root = ET.parse(xml_path).getroot()
    materials = root.find("materials").findall("material")
    floor_tex = load_texture(resolve(root.find("plane_texture_location").text.strip(), xml_dir))
    sky = load_texture(resolve(root.find("skydome_location").text.strip(), xml_dir))

    albedo, refl, refr, absorb, texes, light = [], [], [], [], [], []

    def slot(a=(1.0, 1.0, 1.0), r=0.0, t=0.0, ab=(0.0, 0.0, 0.0), tex=None, is_light=False):
        albedo.append(a), refl.append(r), refr.append(t), absorb.append(ab)
        texes.append(tex), light.append(is_light)

    slot(is_light=True)
    slot(tex=floor_tex)
    for m in materials:
        loc = m.find("texture_location")
        loc = (loc.text or "").strip() if loc is not None else ""
        slot(r=float(m.find("reflectivity").text), t=float(m.find("refractivity").text),
             ab=tuple(_xyz(m.find("absorption"))),
             tex=load_texture(resolve(loc, xml_dir)) if loc else None)
    slot(a=PINK)

    tris, nrms, uvs, mats = [], [], [], []
    meshes = {}
    for obj in root.find("objects").findall("object"):
        path = resolve(obj.find("model_location").text.strip(), xml_dir)
        if path not in meshes:
            meshes[path] = load_obj(path)
        pos, nrm, uv = meshes[path]
        rot = _xyz(obj.find("rotation"))
        r = _rot(0, rot[0]) @ _rot(1, rot[1]) @ _rot(2, rot[2])
        world = (pos * _xyz(obj.find("scale"))) @ r.T + _xyz(obj.find("position"))
        n = nrm @ r.T
        gn = np.cross(world[:, 1] - world[:, 0], world[:, 2] - world[:, 0])
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        bad = np.linalg.norm(n, axis=-1) < 1e-8
        n = np.where(bad[..., None], gn[:, None, :], n)
        tris.append(world), nrms.append(n), uvs.append(uv)
        mats.append(np.full(world.shape[0], 2 + int(obj.find("material_idx").text)))
    v = np.concatenate(tris)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)

    return RefScene(
        v0=t(v[:, 0]), e1=t(v[:, 1] - v[:, 0]), e2=t(v[:, 2] - v[:, 0]),
        normals=t(np.concatenate(nrms)), uvs=t(np.concatenate(uvs)),
        tri_mat=torch.as_tensor(np.concatenate(mats), device=device),
        mat_albedo=t(albedo), mat_refl=t(refl), mat_refr=t(refr), mat_absorb=t(absorb),
        mat_tex=[None if x is None else t(x) for x in texes],
        mat_light=torch.as_tensor(light, device=device),
        light_pos=t(_xyz(root.find("light_position"))), light_color=t(LIGHT_COLOR),
        floor_scale=100.0 / floor_tex.shape[1], sky=t(sky),
    )
