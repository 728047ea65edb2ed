// The per-thread BVH walk shared by the port's kernels: closest hit and any
// hit (csrc/closest_hit.cu), the wavefront path tracer (csrc/wavefront_pt.cu)
// and the Whitted level (csrc/whitted_wf.cu).
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

// Slab test of one node against the ray, as packet_bvh.py:572-589.  There
// jnp.minimum / jnp.maximum propagate NaN (a ray origin on a slab plane
// with a zero direction component gives 0 * inf), and a NaN bound makes the
// test fail; fminf / fmaxf drop NaN, so the NaN case is tested explicitly.
__device__ __forceinline__ bool slab(const float* rec, const Ray& r, float t) {
  const float bminx = __ldg(rec + 0), bminy = __ldg(rec + 1), bminz = __ldg(rec + 2);
  const float bmaxx = __ldg(rec + 3), bmaxy = __ldg(rec + 4), bmaxz = __ldg(rec + 5);
  const float tx1 = (bminx - r.ox) * r.rdx, tx2 = (bmaxx - r.ox) * r.rdx;
  const float ty1 = (bminy - r.oy) * r.rdy, ty2 = (bmaxy - r.oy) * r.rdy;
  const float tz1 = (bminz - r.oz) * r.rdz, tz2 = (bmaxz - r.oz) * r.rdz;
  const bool nan = isnan(tx1) || isnan(tx2) || isnan(ty1) || isnan(ty2) ||
                   isnan(tz1) || isnan(tz2);
  const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return !nan && tmax >= tmin && tmin < t && tmax > 0.0f;
}

// Moller-Trumbore over the leaf's slots [first, first + count), in slot
// order, exactly as packet_bvh.py:521-549: the strict `tt < t` keeps the
// first-tested of equal hits.  With ANY_HIT it returns true at the first
// accepted triangle.
template <bool ANY_HIT>
__device__ __forceinline__ bool leaf_tests(const float* __restrict__ tris, int first, int count,
                                           const Ray& r, Hit& h) {
  for (int k = 0; k < count; ++k) {
    const float* tri = tris + (size_t)(first + k) * 9;
    const float v0x = __ldg(tri + 0), v0y = __ldg(tri + 1), v0z = __ldg(tri + 2);
    const float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
    const float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const float f = 1.0f / (fabsf(a) < 1e-30f ? 1e-30f : a);
    const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
    const float uu = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float vv = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
    if (fabsf(a) >= TRI_EPS && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && uu + vv <= 1.0f &&
        tt > TRI_EPS && tt < h.t) {
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
  const int oct = (r.dx < 0.0f ? 1 : 0) + (r.dy < 0.0f ? 2 : 0) + (r.dz < 0.0f ? 4 : 0);
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
