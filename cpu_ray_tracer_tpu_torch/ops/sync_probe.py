"""The node-step sync probe: 256 steps of a threaded-link walk with one
cursor per 4096-ray tile, in the TPU probe's variants: the CUDA kernel's
wrapper (`node_walk`) and its plain PyTorch version (`node_walk_plain`).

The port of `make_kernel(variant)` of the JAX package's probe
`benchmarks/sync_probe.py:55` (launched by `run` at `:277`); the kernel is
`csrc/sync_probe.cu`, whose header describes the variants.

    node_walk(aabb, links, comps, variant, records=None) -> out float32 [T, 32, 128]
        aabb float32 [6, M] (box min xyz, max xyz per node), links int32
        [2, M] (octant 0: hit, miss), comps the six ray components float32
        [T, 32, 128] (ox, oy, oz, dx, dy, dz), variant one of `VARIANTS`;
        out = acc + cur (A-E), acc + t + (cur + sp) (F).  `records` is
        `node_records(aabb, links)`, the kernel's table, made once per input
        by the caller; None builds it in the call.

The walk starts at node 0 in every variant, as the probe's.  The E and F
variants read nodes (node + k) & 1023, so tables of fewer than 1,024
nodes are refused.  The outputs are small integers in float32 (1e30 in
every lane for F: `t < 1e30 + step` is false in float32, so t never
moves), and the kernel equals the plain version exactly.  The F variants
are timing shapes of the TPU's wide kernel, not a function anyone needs.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; there is no other fallback.  The
kernel reads one 32-byte record per node (`node_records`); the plain
version reads the tables.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.ops import kernel_lib

VARIANTS = ("A", "B", "C", "D", "E1", "E2", "E8", "F0", "F1", "F2")
DEFAULT_VARIANTS = VARIANTS[:7]  # the probe's default list (sync_probe.py:319)
STEPS = 256
TILE = 4096
NODE_MASK = 1023
STACK = 128
_FAR = np.float32(1e30)
_U32 = 0xFFFFFFFF


def check_tables(what: str, aabb, links) -> int:
    """The node count M of tables aabb [6, M] / links [2, M]; raises for
    other shapes and for M < 1024 (the E and F variants read node ids up
    to 1023)."""
    if aabb.dim() != 2 or aabb.shape[0] != 6 or tuple(links.shape) != (2, aabb.shape[1]):
        raise ValueError(f"{what}: tables aabb [6, M] and links [2, M], got "
                         f"{tuple(aabb.shape)} and {tuple(links.shape)}")
    m = aabb.shape[1]
    if m <= NODE_MASK:
        raise ValueError(f"{what}: {m} nodes; the probe reads node ids up to {NODE_MASK}, "
                         f"so it needs at least {NODE_MASK + 1}")
    return m


def _variant(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    return VARIANTS.index(variant)


def _slab(aabb, node, o, rd):
    """sync_probe.py:62-81 for every ray of each tile against its tile's
    node [T]; torch.minimum / maximum propagate NaN as jnp's do."""
    b = aabb[:, node]  # [6, T]

    def ts(axis):
        return ((b[axis][:, None] - o[axis]) * rd[axis],
                (b[axis + 3][:, None] - o[axis]) * rd[axis])

    tx1, tx2 = ts(0)
    tmin, tmax = torch.minimum(tx1, tx2), torch.maximum(tx1, tx2)
    for axis in (1, 2):
        t1, t2 = ts(axis)
        tmin = torch.maximum(tmin, torch.minimum(t1, t2))
        tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    return (tmax >= tmin) & (tmax > 0.0) & (tmin < _FAR)


def node_walk_plain(aabb, links, comps, variant: str) -> torch.Tensor:
    """The probe's walk in plain PyTorch, all tiles at once, each with its
    own cursor."""
    _variant(variant)
    check_tables("node_walk_plain", aabb, links)
    shape = comps[0].shape
    n_tiles, dev = shape[0], comps[0].device
    o = [c.reshape(n_tiles, -1) for c in comps[:3]]
    rd = [1.0 / c.reshape(n_tiles, -1) for c in comps[3:]]
    hit_l, miss_l = links[0].long(), links[1].long()
    acc = torch.zeros_like(o[0])
    cur = torch.zeros(n_tiles, dtype=torch.long, device=dev)

    def follow(cur, node, take_hit):
        return torch.where(cur < 0, cur, torch.where(take_hit, hit_l[node], miss_l[node]))

    if variant in ("A", "B", "C"):
        for _ in range(STEPS):
            node = cur.clamp_min(0)
            take = (node & 1) == 0
            if variant != "A":
                lane = _slab(aabb, node, o, rd)
                acc = acc + lane.float()
                if variant == "C":
                    take = lane.any(dim=1)
            cur = follow(cur, node, take)
    elif variant == "D":
        for _ in range(STEPS // 4):
            packed = torch.zeros(acc.shape, dtype=torch.long, device=dev)
            for k in range(4):
                node = cur.clamp_min(0)
                lane = _slab(aabb, node, o, rd)
                acc = acc + lane.float()
                packed = packed | (lane.long() << k)
                cur = follow(cur, node, (node & 1) == 0)
            bits = packed.sum(dim=1)
            cur = torch.where((bits & 1) >= 0, cur, 0)  # always cur (sync_probe.py:264)
    elif variant.startswith("E"):
        for _ in range(STEPS):
            node = cur.clamp_min(0)
            hits = []
            for k in range(8):
                lane = _slab(aabb, (node + k) & NODE_MASK, o, rd)
                acc = acc + lane.float()
                hits.append(lane.long())
            if variant == "E8":
                bits = sum(hits[k].any(dim=1).long() << k for k in range(8))
            elif variant == "E2":
                # int32 sums that wrap, as XLA's: uint32 arithmetic
                p0 = (hits[0] + (hits[1] << 8) + (hits[2] << 16) + (hits[3] << 24)).sum(1)
                p1 = (hits[4] + (hits[5] << 8) + (hits[6] << 16) + (hits[7] << 24)).sum(1)
                bits = (p0 & _U32) | (p1 & _U32)
            else:
                p0 = hits[0]
                for k in range(1, 8):
                    p0 = p0 | (hits[k] << (k * 4))
                bits = p0.sum(dim=1) & _U32
            cur = follow(cur, node, (bits & 0xFF) != 0)
    else:
        t = torch.full_like(acc, float(_FAR))
        sp = torch.ones(n_tiles, dtype=torch.long, device=dev)
        stack = torch.zeros((n_tiles, STACK), dtype=torch.long, device=dev)  # zero-filled
        tiles = torch.arange(n_tiles, device=dev)
        for step in range(STEPS):
            node = cur.clamp_min(0)
            limit = _FAR + np.float32(step)  # float32: 1e30
            bits = torch.zeros_like(cur)
            for k in range(8):
                lane = _slab(aabb, (node + k) & NODE_MASK, o, rd) & (t < limit)
                bits = bits | (lane.any(dim=1).long() << k)
            if variant in ("F1", "F2"):
                # F1's `cond(hi > lo)` around the loop [lo, hi) and F2's loop
                # [min(lo, hi), hi) run the same rows
                near = (bits & 3) > 0
                lo = torch.where(near, node & 7, 9)
                hi = torch.where(near, (node & 7) + 2, 0)
                start = lo if variant == "F1" else torch.minimum(lo, hi)
                for i in range(int(hi.max()) if n_tiles else 0):
                    row = ((i >= start) & (i < hi))[:, None]
                    tt = acc * 1.0000001 + i
                    t = torch.where(row & (tt < t), tt, t)
                    acc = torch.where(row, acc + tt, acc)
            spm = sp.clone()
            for k in range(8):
                stack[tiles, spm] = hit_l[(node + k) & NODE_MASK]
                spm = spm + ((bits >> k) & 1)
            spm = (spm - 1).clamp_min(0)
            cur = torch.where(cur < 0, cur, stack[tiles, (spm - 1).clamp_min(0)] & NODE_MASK)
            sp = spm & 63
        return (acc + t + (cur + sp).float()[:, None]).reshape(shape)
    return (acc + cur.float()[:, None]).reshape(shape)


def node_records(aabb, links) -> torch.Tensor:
    """The kernel's node table, int32 [M, 8]: per node one 32-byte record,
    the box's min x, y, z and max x, y, z as float32 bits, then the hit
    and the miss link."""
    check_tables("node_records", aabb, links)
    box = aabb.contiguous().view(torch.int32)
    return torch.cat([box, links.to(torch.int32)], dim=0).t().contiguous()


def node_walk(aabb, links, comps, variant: str, records=None) -> torch.Tensor:
    """The probe's walk: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors, on `records` (`node_records(aabb, links)`; built here
    when None)."""
    index = _variant(variant)
    if kernel_lib.on_cpu("node_walk", comps[0]):
        return node_walk_plain(aabb, links, comps, variant)
    m = check_tables("node_walk", aabb, links)
    shape = tuple(comps[0].shape)
    if len(shape) != 3 or shape[1] * shape[2] != TILE or len(comps) != 6:
        raise ValueError(f"node_walk: six ray components [T, 32, 128], got {len(comps)} of {shape}")
    dev = comps[0].device
    if records is None:
        records = node_records(aabb, links)
    kernel_lib.require("node_walk", dev, records=(records, torch.int32, (m, 8)),
                       **{f"comps[{i}]": (c, torch.float32, shape) for i, c in enumerate(comps)})
    kernel_lib.require_aligned("node_walk", records=records)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    k = kernel_lib.load()
    code = k.lib.crt_sync_probe(records.data_ptr(), m, *(c.data_ptr() for c in comps), shape[0],
                                index, out.data_ptr(), kernel_lib.stream(dev))
    kernel_lib.check(k.lib, code, f"node_walk {variant}")
    node_walk.launches[variant] += 1
    return out


node_walk.launches = dict.fromkeys(VARIANTS, 0)  # per variant: one kernel each
