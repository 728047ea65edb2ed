// The per-thread walks shared by the port's kernels.  `walk`, the binary
// stack walk: closest hit and any hit (csrc/closest_hit.cu), the wavefront
// path tracer (csrc/wavefront_pt.cu) and the Whitted level
// (csrc/whitted_wf.cu).  `walk_links`, the link walk of the grid and KD
// cell forests (csrc/link_walk.cu), and `walk_wide`, the 8-wide walk
// (csrc/wide_bvh.cu): see their comments below.  All three share the slab
// test, the leaf tests and the hit decoding.
//
// Replaces the walk the TPU kernels share: `make_traverser` of
// cpu_ray_tracer_tpu/ops/pallas/ptraverse.py:35 (inside the wavefront and
// Whitted kernels) and the stack walk of `_kernel_stack` in
// cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py:442.  There a 4096-ray packet
// walks behind one scalar cursor with the tile's majority octant; here each
// thread walks its own ray:
//   * ordered two-child descent: a step takes one interior node, slab-tests
//     both children against the ray's current t, runs the Moller-Trumbore
//     tests of the near child's leaf and then of the far child's leaf,
//     descends into the near interior child and pushes the far one on a
//     per-thread stack (infra/bvh.cpp:224-258), near and far chosen by the
//     ray's OWN direction octant;
//   * `traversed` counts steps (interior nodes), `tested` triangle tests;
//   * any hit (`walk<true>`) returns at the first accepted triangle: the
//     ray is occluded iff a hit exists in (TRI_EPS, t0), which is the
//     boolean of packet_bvh.py:492-494 / :587-588 (ptraverse.py:109-115),
//     where an accepted lane stops descending;
//   * shading attributes (`attributes`) are read once from the winning
//     slot's 16-float record after the walk.  The TPU walk interpolates
//     them at every accepted triangle (ptraverse.py:118-134); the winner's
//     values are the same numbers.
// `closest_hit_plain` / `occluded_plain` in ops/closest_hit.py are this walk
// in plain PyTorch, lockstep over rays.  Built with -fmad=false, so that
// a*b+c rounds twice as it does there.

#pragma once

#include <cstdint>

namespace crt {

constexpr int NODE_WORDS = 24;  // accel/pack.py NODE_WORDS
constexpr int N_FIRST = 6;
constexpr int N_COUNT = 7;
constexpr int N_NEARFAR = 8;
constexpr int STACK_CAP = 64;  // accel/pack.py STACK_CAP (asserted at pack time)
constexpr int LINK_WORDS = 16;  // accel/pack.py links: (hit, miss) per octant
constexpr int WIDE = 8;  // accel/wide.py: children per wide node
constexpr int WIDE_WORDS = 64;
constexpr int W_CHILD = 48;
constexpr int W_ORDER = 56;
constexpr int LEAF_SHIFT = 22;
constexpr int WIDE_STACK_CAP = 32;  // accel/wide.py WIDE_STACK_CAP (asserted at pack time)
constexpr float TRI_EPS = 1e-4f;
constexpr float RAY_FAR = 1e34f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, rdx, rdy, rdz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        int i) {
  return make_ray(__ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2),
                  __ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2));
}

struct Hit {
  float t, u, v;
  int slot, traversed, tested;
};

__device__ __forceinline__ Hit no_hit(float t0) { return Hit{t0, 0.0f, 0.0f, -1, 0, 0}; }

// Ray-direction octant: bit a set where the direction is negative on axis a.
__device__ __forceinline__ int octant(const Ray& r) {
  return (r.dx < 0.0f ? 1 : 0) + (r.dy < 0.0f ? 2 : 0) + (r.dz < 0.0f ? 4 : 0);
}

// Slab test of a box against the ray, as packet_bvh.py:572-589.  There
// jnp.minimum / jnp.maximum propagate NaN (a ray origin on a slab plane
// with a zero direction component gives 0 * inf), and a NaN bound makes the
// test fail; fminf / fmaxf drop NaN, so the NaN case is tested explicitly.
__device__ __forceinline__ bool slab_box(float bminx, float bminy, float bminz, float bmaxx,
                                         float bmaxy, float bmaxz, const Ray& r, float t) {
  const float tx1 = (bminx - r.ox) * r.rdx, tx2 = (bmaxx - r.ox) * r.rdx;
  const float ty1 = (bminy - r.oy) * r.rdy, ty2 = (bmaxy - r.oy) * r.rdy;
  const float tz1 = (bminz - r.oz) * r.rdz, tz2 = (bmaxz - r.oz) * r.rdz;
  const bool nan = isnan(tx1) || isnan(tx2) || isnan(ty1) || isnan(ty2) ||
                   isnan(tz1) || isnan(tz2);
  const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return !nan && tmax >= tmin && tmin < t && tmax > 0.0f;
}

// The slab test of a node record (its first six words are the box).
__device__ __forceinline__ bool slab(const float* rec, const Ray& r, float t) {
  return slab_box(__ldg(rec + 0), __ldg(rec + 1), __ldg(rec + 2), __ldg(rec + 3),
                  __ldg(rec + 4), __ldg(rec + 5), r, t);
}

// A triangle as the leaf tests read it: v0, e1 = v1 - v0, e2 = v2 - v0.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ tri) {
  return Tri{__ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2), __ldg(tri + 3), __ldg(tri + 4),
             __ldg(tri + 5), __ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8)};
}

// One Moller-Trumbore test, exactly as packet_bvh.py:521-549: whether the
// triangle is hit in (TRI_EPS, t), with the hit's u, v and t.
__device__ __forceinline__ bool moller_trumbore(const Tri& p, const Ray& r, float t, float& uu,
                                                float& vv, float& tt) {
  const float hx = r.dy * p.e2z - r.dz * p.e2y;
  const float hy = r.dz * p.e2x - r.dx * p.e2z;
  const float hz = r.dx * p.e2y - r.dy * p.e2x;
  const float a = p.e1x * hx + p.e1y * hy + p.e1z * hz;
  const float f = 1.0f / (fabsf(a) < 1e-30f ? 1e-30f : a);
  const float sx = r.ox - p.v0x, sy = r.oy - p.v0y, sz = r.oz - p.v0z;
  uu = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * p.e1z - sz * p.e1y;
  const float qy = sz * p.e1x - sx * p.e1z;
  const float qz = sx * p.e1y - sy * p.e1x;
  vv = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  tt = f * (p.e2x * qx + p.e2y * qy + p.e2z * qz);
  return fabsf(a) >= TRI_EPS && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && uu + vv <= 1.0f &&
         tt > TRI_EPS && tt < t;
}

// Moller-Trumbore over the leaf's slots [first, first + count), in slot
// order, exactly as packet_bvh.py:521-549: the strict `tt < t` keeps the
// first-tested of equal hits.  With ANY_HIT it returns true at the first
// accepted triangle.
template <bool ANY_HIT>
__device__ __forceinline__ bool leaf_tests(const float* __restrict__ tris, int first, int count,
                                           const Ray& r, Hit& h) {
  for (int k = 0; k < count; ++k) {
    float uu, vv, tt;
    if (moller_trumbore(load_tri(tris + (size_t)(first + k) * 9), r, h.t, uu, vv, tt)) {
      h.t = tt;
      h.u = uu;
      h.v = vv;
      h.slot = first + k;
      if (ANY_HIT) {
        h.tested += k + 1;
        return true;
      }
    }
  }
  h.tested += count;
  return false;
}

// The walk from `root` over the node records (accel/pack.py), updating `h`
// (which starts as no_hit(t0)).
template <bool ANY_HIT>
__device__ __forceinline__ void walk(const int* __restrict__ nodes,
                                     const float* __restrict__ tris, int root, const Ray& r,
                                     Hit& h) {
  const float* fnodes = reinterpret_cast<const float*>(nodes);
  const int oct = octant(r);
  const int root_count = __ldg(nodes + root * NODE_WORDS + N_COUNT);
  if (root_count > 0) {
    // a one-leaf tree: no interior node to step on; its box, then its
    // triangles (the JAX package's link walk takes this case)
    if (slab(fnodes + root * NODE_WORDS, r, h.t)) {
      leaf_tests<ANY_HIT>(tris, __ldg(nodes + root * NODE_WORDS + N_FIRST), root_count, r, h);
    }
    return;
  }
  int stack[STACK_CAP];
  int sp = 0;
  int cur = root;
  while (cur >= 0) {
    ++h.traversed;
    const int* rec = nodes + cur * NODE_WORDS + N_NEARFAR + 2 * oct;
    const int near = __ldg(rec), far = __ldg(rec + 1);
    const int* nrec = nodes + near * NODE_WORDS;
    const int* frec = nodes + far * NODE_WORDS;
    const bool hit_n = slab(fnodes + near * NODE_WORDS, r, h.t);
    const bool hit_f = slab(fnodes + far * NODE_WORDS, r, h.t);
    const int count_n = __ldg(nrec + N_COUNT), count_f = __ldg(frec + N_COUNT);
    if (hit_n && count_n > 0 && leaf_tests<ANY_HIT>(tris, __ldg(nrec + N_FIRST), count_n, r, h))
      return;
    if (hit_f && count_f > 0 && leaf_tests<ANY_HIT>(tris, __ldg(frec + N_FIRST), count_f, r, h))
      return;
    const bool go_n = hit_n && count_n == 0;
    const bool go_f = hit_f && count_f == 0;
    if (go_n && go_f && sp < STACK_CAP) stack[sp++] = far;
    if (go_n) {
      cur = near;
    } else if (go_f) {
      cur = far;
    } else {
      cur = sp > 0 ? stack[--sp] : -1;
    }
  }
}

// The link walk over a tree threaded with per-octant hit and miss links
// (accel/cell_tree.py, accel/pack.py `links`), as the TPU's `_kernel`
// (cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py:133) walks it, per ray and
// with the ray's own octant: visit the node, slab-test it against the
// current t, test a hit leaf's triangles; then take the hit link where an
// interior node was hit and the miss link otherwise, until -1.  A forest's
// roots are chained through the miss links, so the walk starts at the
// first root and needs no stack.  `traversed` counts every node visited.
template <bool ANY_HIT>
__device__ __forceinline__ void walk_links(const int* __restrict__ nodes,
                                           const int* __restrict__ links,
                                           const float* __restrict__ tris, int root, const Ray& r,
                                           Hit& h) {
  const float* fnodes = reinterpret_cast<const float*>(nodes);
  const int* olinks = links + 2 * octant(r);
  int cur = root;
  while (cur >= 0) {
    ++h.traversed;
    const int* rec = nodes + cur * NODE_WORDS;
    const bool hit = slab(fnodes + cur * NODE_WORDS, r, h.t);
    const int count = __ldg(rec + N_COUNT);
    if (hit && count > 0 && leaf_tests<ANY_HIT>(tris, __ldg(rec + N_FIRST), count, r, h)) return;
    cur = __ldg(olinks + cur * LINK_WORDS + (hit && count == 0 ? 0 : 1));
  }
}

// The child slot of `bits` that comes first in order word `ow` (rank k at
// bits 3k .. 3k + 2), or -1 where `bits` is 0.
__device__ __forceinline__ int nearest_child(int bits, int ow) {
  for (int rank = 0; rank < WIDE; ++rank) {
    const int s = (ow >> (3 * rank)) & 7;
    if ((bits >> s) & 1) return s;
  }
  return -1;
}

// The 8-wide walk (accel/wide.py), as the TPU's `_kernel`
// (cpu_ray_tracer_tpu/ops/pallas/wide_bvh.py:54) walks it, per ray and with
// the ray's own octant.  A step takes one wide node: it slab-tests the 8
// child boxes against the current t (an empty slot's NaN box fails), then
// tests each hit leaf child's slots [first, first + count) of the binary
// pack in child order, then goes to the nearest hit interior child under
// the node's order word for the octant.  The other hit interior children
// stay behind in one stack word `node << 8 | pending mask` (the TPU
// kernel's word, wide_bvh.py:202-251); with no interior child hit, the top
// word gives up its nearest pending child (mask 0: a forest root to enter
// itself).  So the stack holds at most one word per level of the wide tree
// and one per extra root, which accel/wide.py checks against
// WIDE_STACK_CAP at pack time.  `traversed` counts wide-node steps.
template <bool ANY_HIT>
__device__ __forceinline__ void walk_wide(const int* __restrict__ wnodes,
                                          const int* __restrict__ roots, int n_roots,
                                          const float* __restrict__ tris, const Ray& r, Hit& h) {
  const float* fw = reinterpret_cast<const float*>(wnodes);
  const int oct = octant(r);
  int stack[WIDE_STACK_CAP];
  int sp = 0;
  for (int i = n_roots - 1; i >= 1; --i) stack[sp++] = __ldg(roots + i) << 8;
  int cur = __ldg(roots);
  while (cur >= 0) {
    ++h.traversed;
    const int* rec = wnodes + (size_t)cur * WIDE_WORDS;
    int hitbits = 0;
    for (int k = 0; k < WIDE; ++k) {
      if (slab(fw + (size_t)cur * WIDE_WORDS + 6 * k, r, h.t)) hitbits |= 1 << k;
    }
    int ibits = 0;
    for (int k = 0; k < WIDE; ++k) {
      if (!((hitbits >> k) & 1)) continue;
      const int c = __ldg(rec + W_CHILD + k);
      const int count = c >> LEAF_SHIFT;
      if (count > 0) {
        if (leaf_tests<ANY_HIT>(tris, c & ((1 << LEAF_SHIFT) - 1), count, r, h)) return;
      } else if (c > 0) {
        ibits |= 1 << k;
      }
    }
    const int sel = nearest_child(ibits, __ldg(rec + W_ORDER + oct));
    if (sel >= 0) {
      const int rest = ibits & ~(1 << sel);
      if (rest != 0) stack[sp++] = (cur << 8) | rest;
      cur = __ldg(rec + W_CHILD + sel);
    } else if (sp > 0) {
      const int p = stack[sp - 1] >> 8, pm = stack[sp - 1] & 0xFF;
      if (pm == 0) {
        cur = p;
        --sp;
      } else {
        const int* prec = wnodes + (size_t)p * WIDE_WORDS;
        const int s = nearest_child(pm, __ldg(prec + W_ORDER + oct));
        cur = __ldg(prec + W_CHILD + s);
        const int left = pm & ~(1 << s);
        if (left != 0) {
          stack[sp - 1] = (p << 8) | left;
        } else {
          --sp;
        }
      }
    } else {
      cur = -1;
    }
  }
}

// Hit ids from the meta word in lane 15 of the winning slot's shading
// record (packet_bvh.py:898-908): tri | obj << 20 | mat << 26.
struct Ids {
  int tri, obj, mat;
};

__device__ __forceinline__ Ids decode(const float* __restrict__ shade, int slot) {
  Ids ids{-1, -1, -1};
  if (slot >= 0) {
    const int meta = __float_as_int(__ldg(shade + (size_t)slot * 16 + 15));
    if (meta >= 0) {
      ids.tri = meta & 0xFFFFF;
      ids.obj = (meta >> 20) & 0x3F;
      ids.mat = (meta >> 26) & 0x3F;
    }
  }
  return ids;
}

// Interpolated (unnormalised) normal and uv of a triangle hit, from the
// winning slot's record: n0 n1 n2 uv0 uv1 uv2 weighted by (1 - u - v, u, v),
// as scene/query.get_hit_info computes them.
struct Attrs {
  float nx, ny, nz, tu, tv;
};

__device__ __forceinline__ Attrs attributes(const float* __restrict__ shade, const Hit& h) {
  const float* s = shade + (size_t)h.slot * 16;
  const float w = 1.0f - h.u - h.v;
  Attrs a;
  a.nx = w * __ldg(s + 0) + h.u * __ldg(s + 3) + h.v * __ldg(s + 6);
  a.ny = w * __ldg(s + 1) + h.u * __ldg(s + 4) + h.v * __ldg(s + 7);
  a.nz = w * __ldg(s + 2) + h.u * __ldg(s + 5) + h.v * __ldg(s + 8);
  a.tu = w * __ldg(s + 9) + h.u * __ldg(s + 11) + h.v * __ldg(s + 13);
  a.tv = w * __ldg(s + 10) + h.u * __ldg(s + 12) + h.v * __ldg(s + 14);
  return a;
}

}  // namespace crt
