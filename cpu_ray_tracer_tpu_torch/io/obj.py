"""Wavefront OBJ loader (host side, numpy).

Semantics mirror the reference's tinyobj path (infra/model.cpp:4-60):

* polygons with >3 vertices are fan-triangulated (v0, v_i, v_{i+1}) —
  tinyobj's default triangulation;
* vertices are deduplicated on the full (position, normal, uv) triple via a
  hash map, producing an indexed mesh;
* missing normal/uv indices yield zeros (the reference's `Vertex{}` value
  initialization).

Output is SoA numpy arrays ready for the scene compiler.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Indexed triangle mesh, host-side."""

    positions: np.ndarray  # [V, 3] float32
    normals: np.ndarray  # [V, 3] float32 (zeros when absent)
    uvs: np.ndarray  # [V, 2] float32 (zeros when absent)
    indices: np.ndarray  # [F, 3] int32

    @property
    def num_tris(self) -> int:
        return self.indices.shape[0]

    def triangles(self):
        """Per-triangle (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2) arrays."""
        idx = self.indices
        v = self.positions[idx]  # [F, 3, 3]
        n = self.normals[idx]
        uv = self.uvs[idx]
        return v, n, uv


def _parse_index(token: str, count: int) -> int:
    """OBJ 1-based index; negative = relative from end."""
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path: str) -> MeshData:
    v_list: list[tuple] = []
    vn_list: list[tuple] = []
    vt_list: list[tuple] = []
    corners: list[tuple[int, int, int]] = []  # (v, vt, vn) per triangle corner

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] not in "vf":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                v_list.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                vn_list.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                vt_list.append((float(parts[1]), float(parts[2])))
            elif tag == "f":
                face = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = _parse_index(comps[0], len(v_list))
                    ti = (
                        _parse_index(comps[1], len(vt_list))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        _parse_index(comps[2], len(vn_list))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    face.append((vi, ti, ni))
                # fan triangulation, tinyobj default
                for k in range(1, len(face) - 1):
                    corners.append(face[0])
                    corners.append(face[k])
                    corners.append(face[k + 1])

    positions = np.asarray(v_list, np.float32).reshape(-1, 3)
    normals = np.asarray(vn_list, np.float32).reshape(-1, 3)
    uvs = np.asarray(vt_list, np.float32).reshape(-1, 2)

    # Vertex dedup on the (pos, normal, uv) triple — model.cpp:16-54.
    unique: dict[tuple, int] = {}
    out_pos: list = []
    out_nrm: list = []
    out_uv: list = []
    indices = np.empty(len(corners), np.int32)
    for j, (vi, ti, ni) in enumerate(corners):
        key = (vi, ti, ni)
        slot = unique.get(key)
        if slot is None:
            slot = len(out_pos)
            unique[key] = slot
            out_pos.append(positions[vi])
            out_nrm.append(normals[ni] if ni >= 0 else np.zeros(3, np.float32))
            out_uv.append(uvs[ti] if ti >= 0 else np.zeros(2, np.float32))
        indices[j] = slot

    return MeshData(
        positions=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normals=np.asarray(out_nrm, np.float32).reshape(-1, 3),
        uvs=np.asarray(out_uv, np.float32).reshape(-1, 2),
        indices=indices.reshape(-1, 3),
    )
