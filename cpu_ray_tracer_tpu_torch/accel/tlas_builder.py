"""Agglomerative TLAS build over instance world bounds, as the JAX package's
`cpu_ray_tracer_tpu/accel/tlas_builder.py`.

Reference semantics (infra/tlas_bvh.cpp:17-70): greedy agglomerative
clustering — repeatedly pair the two nodes whose union has the smallest
surface area (FindBestMatch A/B handshake) until one root remains.

The TLAS's leaves ARE the per-instance BLAS root nodes (identified by
instance index); interior nodes get an ordering axis (the dominant
child-separation axis) so that the near/far child tables can order descent.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TLASHost:
    """Interior nodes only; children reference either interior nodes
    (value < n_interior) or instance leaves (value = n_interior + inst)."""

    node_min: np.ndarray  # [T, 3]
    node_max: np.ndarray  # [T, 3]
    left: np.ndarray  # [T] int32
    right: np.ndarray  # [T] int32
    axis: np.ndarray  # [T] int32
    root: int  # index of root interior node, or n_interior + inst if I == 1


def _area(bmin, bmax) -> float:
    e = np.maximum(bmax - bmin, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def build_tlas(inst_min: np.ndarray, inst_max: np.ndarray) -> TLASHost:
    n = inst_min.shape[0]
    if n == 0:
        raise ValueError("TLAS over zero instances")
    n_interior = n - 1
    node_min = np.zeros((n_interior, 3), np.float32)
    node_max = np.zeros((n_interior, 3), np.float32)
    left = np.zeros(n_interior, np.int32)
    right = np.zeros(n_interior, np.int32)
    axis = np.zeros(n_interior, np.int32)

    if n == 1:
        return TLASHost(node_min, node_max, left, right, axis, root=n_interior)

    # cluster list: (id, bmin, bmax); instance leaves use id = n_interior + i
    ids = [n_interior + i for i in range(n)]
    mins = [inst_min[i].astype(np.float32) for i in range(n)]
    maxs = [inst_max[i].astype(np.float32) for i in range(n)]

    def best_match(i: int) -> int:
        best_j, best_a = -1, np.inf
        for j in range(len(ids)):
            if j == i:
                continue
            a = _area(np.minimum(mins[i], mins[j]), np.maximum(maxs[i], maxs[j]))
            if a < best_a:
                best_a, best_j = a, j
        return best_j

    next_node = 0
    a = 0
    b = best_match(a)
    while len(ids) > 1:
        c = best_match(b)
        if a == c:
            bmin = np.minimum(mins[a], mins[b])
            bmax = np.maximum(maxs[a], maxs[b])
            node = next_node
            next_node += 1
            node_min[node] = bmin
            node_max[node] = bmax
            ca = (mins[a] + maxs[a]) * 0.5
            cb = (mins[b] + maxs[b]) * 0.5
            ax = int(np.argmax(np.abs(cb - ca)))
            axis[node] = ax
            # order children so `left` is the lower-coordinate one along ax
            if ca[ax] <= cb[ax]:
                left[node], right[node] = ids[a], ids[b]
            else:
                left[node], right[node] = ids[b], ids[a]
            # replace a with the merged cluster, remove b
            ids[a] = node
            mins[a] = bmin
            maxs[a] = bmax
            ids.pop(b)
            mins.pop(b)
            maxs.pop(b)
            if a > b:
                a -= 1
            if len(ids) > 1:
                b = best_match(a)
        else:
            a, b = b, c

    return TLASHost(node_min, node_max, left, right, axis, root=int(ids[0]))
