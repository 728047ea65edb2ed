"""The leaf-test probes: Moller-Trumbore closest hit of 4096-ray tiles
against 512 triangles, per thread on the CUDA cores (`vpu_leaf`, K6) and
as a matrix product on the tensor cores (`mxu_leaf`, K7), with their plain
PyTorch versions (`vpu_leaf_plain`, `mxu_leaf_plain`).

The ports of `make_vpu_kernel` and `make_mxu_kernel(m)` of the JAX
package's probe `benchmarks/mxu_probe.py:65`, `:110` (launched at `:174`,
`:193`); the kernels are `csrc/leaf_probe.cu`.

    vpu_leaf(tris, ox, oy, oz, dx, dy, dz, packed=None) -> out float32 [T, 32, 128]
        tris float32 [R, 128]: R rows of 8 records of 16 floats (v0, e1, e2
        in floats 0-8), tested in row order, slot = 8 * row + record; the
        ray components float32 [T, 32, 128]; out = t + u + v + slot of the
        closest hit (1e30 where nothing is hit).  `packed` is
        `pack_vpu(tris)`: each triangle as 16 floats (v0, n.x, e1, n.y, e2,
        n.z, v0 . n and padding, with n = e1 x e2), made once per input by
        the caller; None packs it in the call.
    mxu_leaf(c_tab, phi, m, packed=None) -> out float32 [T, 4096]
        c_tab float32 [16m, 16]: 4 groups of 4m rows (a, u*a, v*a, t*a of m
        triangles, quantity-major); phi float32 [T, 16, 4096]: the rays'
        features; flush i (of 512 / m) tests group i % 4; out = t + slot of
        every ray of the tile.  The JAX kernel stores only rays 0-127 of
        each tile (`[:, None, :128]`); the port's kernel writes all of them.
        `packed` is `pack(c_tab, phi, m)`: C in the kernel's fragment order
        (`pack_c`) and Phi ray-major (`pack_phi`), made once per input by
        the caller; None packs them in the call.

Each wrapper runs the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; there is no other fallback.  K6
computes each test from the packed normal without a division (a sign
fold and cross-multiplied compares, FMA contracted) and K7's product is three TF32 passes
and the plain version's is float64 rounded to float32, so the two agree to
about 1e-6 relative: for both, a ray's output can differ from the plain
version's only where the float64 evaluation shows a decision that close
(`benchmarks/leaf_tolerance.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.ops import kernel_lib

TILE = 4096
RECORD = 16  # floats per triangle record; v0, e1, e2 in the first 9
WIDTHS = (8, 32, 64, 128)  # triangles per flush that the kernel is built for
TESTS = 512  # triangle tests per ray: 64 rows of 8, or 512 / m flushes of m
_TINY = np.float32(1e-30)
EPS = np.float32(1e-4)
FAR = np.float32(1e30)


def n_flush(m: int) -> int:
    """Flushes of m triangles per tile: as many tests as the VPU probe."""
    return max(TESTS // m, 1)


def _accept(a, uu, vv, tt, t):
    return ((a.abs() >= EPS) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
            & (uu + vv <= 1.0) & (tt > EPS) & (tt < t))


def vpu_leaf_plain(tris, ox, oy, oz, dx, dy, dz) -> torch.Tensor:
    """K6 in plain PyTorch: the probe's arithmetic, in its order, over all
    rays at once, triangle by triangle."""
    rec = tris.reshape(-1, RECORD)
    t = torch.full_like(ox, float(FAR))
    u = torch.zeros_like(ox)
    v = torch.zeros_like(ox)
    slot = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    for k in range(rec.shape[0]):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rec[k, :9].unbind(0)
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        f = 1.0 / torch.where(a.abs() < _TINY, _TINY, a)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        uu = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        vv = f * (dx * qx + dy * qy + dz * qz)
        tt = f * (e2x * qx + e2y * qy + e2z * qz)
        ok = _accept(a, uu, vv, tt, t)
        t = torch.where(ok, tt, t)
        u = torch.where(ok, uu, u)
        v = torch.where(ok, vv, v)
        slot = torch.where(ok, k, slot)
    return t + u + v + slot.to(torch.float32)


VPU_FLOATS = 16  # floats per packed triangle: four float4 of the kernel


def pack_vpu(tris: torch.Tensor) -> torch.Tensor:
    """K6's triangles, float32 [8R, 16]: per slot (v0, n.x), (e1, n.y),
    (e2, n.z), (v0 . n, 0, 0, 0) as four float4, with the normal
    n = e1 x e2 and v0 . n computed once here in float32."""
    rec = tris.reshape(-1, RECORD)
    v0, e1, e2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    w = (v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2])[:, None]
    return torch.cat([v0, n[:, 0:1], e1, n[:, 1:2], e2, n[:, 2:3], w, torch.zeros_like(v0)],
                     dim=1).contiguous()


def vpu_leaf(tris, ox, oy, oz, dx, dy, dz, packed=None) -> torch.Tensor:
    """K6: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors, on `packed` (`pack_vpu(tris)`; packed here when None)."""
    if kernel_lib.on_cpu("vpu_leaf", ox):
        return vpu_leaf_plain(tris, ox, oy, oz, dx, dy, dz)
    shape = tuple(ox.shape)
    if len(shape) != 3 or shape[1:] != (32, 128) or tris.dim() != 2 or tris.shape[1] != 128:
        raise ValueError(f"vpu_leaf: tris [R, 128] and rays [T, 32, 128], got "
                         f"{tuple(tris.shape)} and {shape}")
    n_tris = tris.shape[0] * 8
    if n_tris * VPU_FLOATS * 4 > 48 * 1024:
        raise ValueError(f"vpu_leaf: {n_tris} triangles do not fit the kernel's shared memory")
    if packed is None:
        packed = pack_vpu(tris)
    comps = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz)
    kernel_lib.require("vpu_leaf", ox.device, packed=(packed, torch.float32, (n_tris, VPU_FLOATS)),
                       **{k: (x, torch.float32, shape) for k, x in comps.items()})
    kernel_lib.require_aligned("vpu_leaf", packed=packed)
    out = torch.empty(shape, dtype=torch.float32, device=ox.device)
    k = kernel_lib.load()
    code = k.lib.crt_vpu_leaf(packed.data_ptr(), n_tris, *(x.data_ptr() for x in comps.values()),
                              ox.numel(), out.data_ptr(), kernel_lib.stream(ox.device))
    kernel_lib.check(k.lib, code, "vpu_leaf")
    vpu_leaf.launches += 1
    return out


def mxu_leaf_plain(c_tab, phi, m: int) -> torch.Tensor:
    """K7 in plain PyTorch: per flush the product in float64, rounded once
    to float32, then the probe's float32 epilogue and the first-index min
    over the m candidates.  Returns t + slot [T, 4096]."""
    n_tiles, dev = phi.shape[0], phi.device
    t = torch.full((n_tiles, TILE), float(FAR), dtype=torch.float32, device=dev)
    slot = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    idx = torch.arange(m, dtype=torch.int32, device=dev).view(1, m, 1)
    phi64 = phi.double()
    for i in range(n_flush(m)):
        g = i % 4
        prod = torch.matmul(c_tab[g * 4 * m:(g + 1) * 4 * m].double(), phi64).float()
        a, ua, va, ta = prod.split(m, dim=1)
        f = 1.0 / torch.where(a.abs() < _TINY, _TINY, a)
        uu, vv, tt = ua * f, va * f, ta * f
        ok = _accept(a, uu, vv, tt, t.unsqueeze(1))
        cand = torch.where(ok, tt, FAR)
        tb = cand.amin(dim=1)
        win = torch.where(cand == tb.unsqueeze(1), idx, m).amin(dim=1)
        slot = torch.where(tb < t, i * m + win, slot)
        t = torch.minimum(t, tb)
    return t + slot.to(torch.float32)


PAIRS = 16  # 32-triangle pairs of accumulators per ray tile: 512 tests


def a_blocks(m: int) -> int:
    """Distinct 32-triangle blocks of C the kernel's pairs read: one at
    m = 8 (a pair holds flushes 4P .. 4P + 3, groups 0-3 in warp order),
    else one per (group, 32-triangle part of a flush)."""
    return 1 if m == 8 else 4 * m // 32


def _fragment_index(m: int):
    """Index tensors (group, quantity, triangle, feature) of C for each
    float of the kernel's fragment order [block, accumulator, k step,
    warp, lane, register]: register r of lane 4g + q of warp w holds row
    g + 8 (r & 1), column q + 4 (r >> 1) of the warp's 16 x 8 slice of A
    (the m16n8k8 layout, which `wgmma` takes from registers); accumulator
    h's rows g and g + 8 are quantities 2h and 2h + 1 (a, u*a; v*a, t*a)
    of the pair's triangle 8w + g."""
    shape = (a_blocks(m), 2, 2, 4, 8, 4, 4)
    b, h, ks, w, g, q, r = (torch.arange(n).view([-1 if i == j else 1 for j in range(7)])
                            for i, n in enumerate(shape))
    if m == 8:
        group, tri = w + 0 * b, g + 0 * b
    else:
        group = b // (m // 32)
        tri = 32 * (b % (m // 32)) + 8 * w + g
    quantity = 2 * h + (r & 1)
    feature = 8 * ks + q + 4 * (r >> 1)
    return [x.expand(shape) for x in (group, quantity, tri, feature)]


def pack_c(c_tab: torch.Tensor, m: int) -> torch.Tensor:
    """C [16m, 16] in the kernel's fragment order (`_fragment_index`):
    float32 [a_blocks(m) * 2048]; pair P of a tile reads block P %
    a_blocks(m), and its triangle of warp w, lane g is slot 32P + 8w + g."""
    group, quantity, tri, feature = _fragment_index(m)
    q = c_tab.reshape(4, 4, m, 16)
    return q[group.to(c_tab.device), quantity.to(c_tab.device), tri.to(c_tab.device),
             feature.to(c_tab.device)].reshape(-1)


def unpack_c(packed: torch.Tensor, m: int) -> torch.Tensor:
    """C [16m, 16] from `pack_c(C, m)`."""
    group, quantity, tri, feature = (x.reshape(-1).to(packed.device)
                                     for x in _fragment_index(m))
    out = torch.full((4, 4, m, 16), float("nan"), dtype=packed.dtype, device=packed.device)
    out[group, quantity, tri, feature] = packed
    return out.reshape(16 * m, 16)


def pack_phi(phi: torch.Tensor) -> torch.Tensor:
    """Phi [T, 16, 4096] ray-major, [T * 4096, 16]: a ray's 16 features in
    64 bytes, the K-major B operand of `wgmma`."""
    return phi.permute(0, 2, 1).reshape(-1, 16).contiguous()


def pack(c_tab: torch.Tensor, phi: torch.Tensor, m: int) -> tuple:
    """K7's inputs in its layouts, made once per input by the caller."""
    return pack_c(c_tab, m).contiguous(), pack_phi(phi)


def mxu_leaf_pairs_plain(packed: tuple, m: int) -> torch.Tensor:
    """K7 in the kernel's order, on its packed inputs, in plain PyTorch:
    pair by pair (32 triangles, slot 32P + 8w + g) the product in
    float64, rounded once to float32, the probe's float32 epilogue
    accepting without `tt < t`, and the smaller (t, slot) kept.  Equals
    `mxu_leaf_plain` (the probe's flush order) on the same inputs."""
    c_frag, phi_rm = packed
    n_rays, dev = phi_rm.shape[0], phi_rm.device
    group, quantity, tri, feature = (x.to(dev) for x in _fragment_index(m))
    frag = c_frag.reshape(group.shape)
    # each block's A: [block, accumulator, warp, row, feature]
    a_mat = torch.zeros((a_blocks(m), 2, 4, 16, 16), dtype=c_frag.dtype, device=dev)
    shape = group.shape
    b, h, ks, w, g, q, r = (torch.arange(n, device=dev).view(
        [-1 if i == j else 1 for j in range(7)]).expand(shape) for i, n in enumerate(shape))
    a_mat[b, h, w, g + 8 * (r & 1), 8 * ks + q + 4 * (r >> 1)] = frag
    phi64 = phi_rm.double().t()
    t = torch.full((n_rays,), float(FAR), dtype=torch.float32, device=dev)
    slot = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    sub = torch.arange(32, dtype=torch.int32, device=dev).view(32, 1)
    for pair in range(PAIRS):
        prod = torch.matmul(a_mat[pair % a_blocks(m)].double().reshape(128, 16), phi64).float()
        prod = prod.reshape(2, 4, 2, 8, n_rays)  # accumulator, warp, row half, g, ray
        a, ua = prod[0, :, 0].reshape(32, -1), prod[0, :, 1].reshape(32, -1)
        va, ta = prod[1, :, 0].reshape(32, -1), prod[1, :, 1].reshape(32, -1)
        f = 1.0 / torch.where(a.abs() < _TINY, _TINY, a)
        uu, vv, tt = ua * f, va * f, ta * f
        ok = _accept(a, uu, vv, tt, torch.full_like(tt, float("inf")))
        cand = torch.where(ok, tt, FAR)
        tb = cand.amin(dim=0)
        win = torch.where(cand == tb, sub, 32).amin(dim=0)
        better = tb < t  # equal t keeps the earlier pair's smaller slot
        slot = torch.where(better, 32 * pair + win, slot)
        t = torch.where(better, tb, t)
    return t + slot.to(torch.float32)


def mxu_leaf(c_tab, phi, m: int, packed=None) -> torch.Tensor:
    """K7: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors, on `packed` (`pack(c_tab, phi, m)`; packed here when None)."""
    if m not in WIDTHS:
        raise ValueError(f"mxu_leaf: m={m}, the kernel is built for {WIDTHS}")
    if kernel_lib.on_cpu("mxu_leaf", phi):
        return mxu_leaf_plain(c_tab, phi, m)
    if packed is None:
        packed = pack(c_tab, phi, m)
    c_frag, phi_rm = packed
    n_tiles = phi.shape[0]
    kernel_lib.require("mxu_leaf", phi.device,
                       c_frag=(c_frag, torch.float32, (a_blocks(m) * 2048,)),
                       phi_rm=(phi_rm, torch.float32, (n_tiles * TILE, 16)))
    kernel_lib.require_aligned("mxu_leaf", c_frag=c_frag, phi_rm=phi_rm)
    out = torch.empty((n_tiles, TILE), dtype=torch.float32, device=phi.device)
    k = kernel_lib.load()
    code = k.lib.crt_mxu_leaf(c_frag.data_ptr(), phi_rm.data_ptr(), n_tiles, m,
                              out.data_ptr(), kernel_lib.stream(phi.device))
    kernel_lib.check(k.lib, code, "mxu_leaf")
    mxu_leaf.launches[m] += 1
    return out


vpu_leaf.launches = 0  # kernel launches since the last reset
mxu_leaf.launches = dict.fromkeys(WIDTHS, 0)  # per m: one kernel each

