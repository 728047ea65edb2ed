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
//
// What bounds the walks on an H100 (read from timings of variants with
// tools/time_walks.py, not from hardware counters; PERF.md): not bytes and
// not float32 operations (the smoke's bound puts them at 2-10% of either).
// Skipping the walk leaves
// a tenth of K1's time, so the walk is the rest.  The tables below halved
// the dependent round trips of a binary step and cut the walks' time by
// only 3-8%; FMA contraction would cut 2-5%; 256-thread blocks change
// nothing; capping registers to raise occupancy spills and loses.  The
// same primary rays in random warps take 1.7x as long (K1) and 1.1x (K2):
// what is left is SIMT divergence, lanes of a warp walking different paths
// one after another, and the spread of block lengths.  The tables
// (accel/pack.py) give each step one dependent round trip to one record,
// read with 16-byte vector loads through the read-only path:
//   * `walk` reads `node_records`: one 64-byte record per interior node
//     holds both children's boxes, their refs (node id, or a leaf's ~code)
//     and the per-octant near/far swap mask, so a step is four independent
//     16-byte loads of the node in hand (the 96-byte `nodes` table took two
//     round trips: the node's near/far pair, then both children);
//   * `walk_links` reads `link_records`: per octant and node one 32-byte
//     record, one sector, holds the box, the hit link or ~code and the miss
//     link, so the next node comes out of the record just visited and a ray
//     stays in its octant's slice (184 KB on the main path's grid);
//   * `wide_step` reads `wide_records` (accel/wide.py): one 256-byte
//     record per wide node, its 8 boxes field-major in 12 16-byte loads,
//     its child words in 2, and the octant's order word, all independent
//     (six scalar loads per box took 1.3x as long; PERF.md);
//   * the leaf tests read `tris4`: a triangle is three 16-byte loads of
//     v0, e1, e2 padded to four floats.
// A leaf's code takes one of two forms, the same for every leaf of a
// scene (accel/pack.py `leaf_codes`), and every walk is compiled for both
// (the CODES template argument):
//   * CODES: count << LEAF_SHIFT | first, where every leaf fits 9 and 22
//     bits, as in all scenes up to millions of triangles: the count comes
//     with the record, and the leaf loop is a counted one that the compiler
//     pipelines;
//   * otherwise the first slot alone, in a full int32 word, and v0's fourth
//     word in `tris4` counts the slots from it to its leaf's end, so a leaf
//     of any size at any slot (the JAX package's `node_meta2` takes full
//     int32 words) costs no load of its own: each triangle's load says
//     whether another follows.  Reading the count there on every scene
//     cost the main scene's walks 2-26% (PERF.md), so the common form keeps
//     the count in the code.
// The walks' order, and so t/u/v, the slots and the counters, are the
// plain versions' bit for bit; only the loads changed.

#pragma once

#include <cstdint>

namespace crt {

// accel/pack.py STACK_CAP: the pack walks a deeper BVH by links, so a walk
// never pushes more than depth - 2 <= STACK_CAP - 2 far children
constexpr int STACK_CAP = 128;
constexpr int LEAF_SHIFT = 22;  // accel/pack.py LEAF_SHIFT: a leaf code's count field
constexpr int FIRST_MASK = (1 << LEAF_SHIFT) - 1;
constexpr int RECORD_INT4 = 4;  // accel/pack.py node_records: 16 words
constexpr int LINK_RECORD_INT4 = 2;  // accel/pack.py link_records: 8 words
constexpr int TRI_FLOAT4 = 3;  // accel/pack.py tris4: 12 floats
constexpr int WIDE = 8;  // accel/wide.py: children per wide node
constexpr int WIDE_RECORD_INT4 = 16;  // accel/wide.py wide_records: 64 words
constexpr int W_ORDER = 56;
constexpr int WIDE_STACK_CAP = 256;  // accel/wide.py WIDE_STACK_CAP (checked at pack time)
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

__device__ __forceinline__ float f32(int w) { return __int_as_float(w); }

// A triangle as the leaf tests read it: v0, e1 = v1 - v0, e2 = v2 - v0.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Slot `slot` of `tris4` (accel/pack.py): three 16-byte loads; `left` is
// word 3, the slots from this one to the end of its leaf.
__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris4, int slot, int& left) {
  const float4* p = tris4 + (size_t)slot * TRI_FLOAT4;
  const float4 v0 = __ldg(p), e1 = __ldg(p + 1), e2 = __ldg(p + 2);
  left = __float_as_int(v0.w);
  return Tri{v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z};
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
__device__ __forceinline__ bool leaf_tests(const float4* __restrict__ tris4, int first, int count,
                                           const Ray& r, Hit& h) {
  for (int k = 0; k < count; ++k) {
    int left;
    float uu, vv, tt;
    if (moller_trumbore(load_tri(tris4, first + k, left), r, h.t, uu, vv, tt)) {
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

// The same over a leaf known by its first slot alone: each slot's `left`
// word says whether another follows.
template <bool ANY_HIT>
__device__ __forceinline__ bool leaf_tests_open(const float4* __restrict__ tris4, int first,
                                                const Ray& r, Hit& h) {
  for (int slot = first;; ++slot) {
    int left;
    float uu, vv, tt;
    const Tri tri = load_tri(tris4, slot, left);
    ++h.tested;
    if (moller_trumbore(tri, r, h.t, uu, vv, tt)) {
      h.t = tt;
      h.u = uu;
      h.v = vv;
      h.slot = slot;
      if (ANY_HIT) return true;
    }
    if (left <= 1) return false;
  }
}

// The leaf tests of a leaf's code (module comment): count << LEAF_SHIFT |
// first with CODES, else the first slot alone.
template <bool ANY_HIT, bool CODES>
__device__ __forceinline__ bool leaf_code_tests(const float4* __restrict__ tris4, int code,
                                                const Ray& r, Hit& h) {
  if constexpr (CODES) {
    return leaf_tests<ANY_HIT>(tris4, code & FIRST_MASK, code >> LEAF_SHIFT, r, h);
  } else {
    return leaf_tests_open<ANY_HIT>(tris4, code, r, h);
  }
}

// The walk from `root` over `node_records` (accel/pack.py), updating `h`
// (which starts as no_hit(t0)).  `root` is the root's node id, or ~id for
// a one-leaf tree, whose row holds its box and leaf ref.
template <bool ANY_HIT, bool CODES>
__device__ __forceinline__ void walk(const int4* __restrict__ records,
                                     const float4* __restrict__ tris4, int root, const Ray& r,
                                     Hit& h) {
  if (root < 0) {
    // a one-leaf tree: no interior node to step on; its box, then its
    // triangles (the JAX package's link walk takes this case)
    const int4* rec = records + (size_t)(~root) * RECORD_INT4;
    const int4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q3 = __ldg(rec + 3);
    if (slab_box(f32(q0.x), f32(q0.y), f32(q0.z), f32(q0.w), f32(q1.x), f32(q1.y), r, h.t)) {
      leaf_code_tests<ANY_HIT, CODES>(tris4, ~q3.x, r, h);
    }
    return;
  }
  const int oct = octant(r);
  int stack[STACK_CAP];
  int sp = 0;
  int cur = root;
  while (cur >= 0) {
    ++h.traversed;
    // the one dependent round trip of the step: the whole record at once
    const int4* rec = records + (size_t)cur * RECORD_INT4;
    const int4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q2 = __ldg(rec + 2), q3 = __ldg(rec + 3);
    const bool hit_l =
        slab_box(f32(q0.x), f32(q0.y), f32(q0.z), f32(q0.w), f32(q1.x), f32(q1.y), r, h.t);
    const bool hit_r =
        slab_box(f32(q1.z), f32(q1.w), f32(q2.x), f32(q2.y), f32(q2.z), f32(q2.w), r, h.t);
    const bool swap = (q3.z >> oct) & 1;
    const int near = swap ? q3.y : q3.x, far = swap ? q3.x : q3.y;
    const bool hit_n = swap ? hit_r : hit_l, hit_f = swap ? hit_l : hit_r;
    // a negative ref is a leaf: ~code
    if (hit_n && near < 0 && leaf_code_tests<ANY_HIT, CODES>(tris4, ~near, r, h)) return;
    if (hit_f && far < 0 && leaf_code_tests<ANY_HIT, CODES>(tris4, ~far, r, h)) return;
    const bool go_n = hit_n && near >= 0;
    const bool go_f = hit_f && far >= 0;
    if (go_n && go_f) {
      // the pack guarantees room (STACK_CAP above); a debug build checks it
#if defined(CRT_DEBUG) || defined(__CUDACC_DEBUG__)
      if (sp >= STACK_CAP) __trap();
#endif
      stack[sp++] = far;
    }
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
// (accel/cell_tree.py, accel/pack.py `link_records`), as the TPU's
// `_kernel` (cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py:133) walks it, per
// ray and with the ray's own octant: visit the node, slab-test it against
// the current t, test a hit leaf's triangles; then take the hit link where
// an interior node was hit and the miss link otherwise, until -1.  A
// forest's roots are chained through the miss links, so the walk starts at
// the first root and needs no stack.  `traversed` counts every node
// visited.  `m` is the node count: octant o's records start at o * m.
template <bool ANY_HIT, bool CODES>
__device__ __forceinline__ void walk_links(const int4* __restrict__ link_records, int m,
                                           const float4* __restrict__ tris4, int root,
                                           const Ray& r, Hit& h) {
  const int4* orecs = link_records + (size_t)octant(r) * m * LINK_RECORD_INT4;
  int cur = root;
  while (cur >= 0) {
    ++h.traversed;
    const int4* rec = orecs + (size_t)cur * LINK_RECORD_INT4;
    const int4 a = __ldg(rec), b = __ldg(rec + 1);
    const bool hit = slab_box(f32(a.x), f32(a.y), f32(a.z), f32(a.w), f32(b.x), f32(b.y), r, h.t);
    // word 6: the hit link of an interior node (a node id), or a leaf's
    // ~code (negative)
    const bool leaf = b.z < 0;
    if (hit && leaf && leaf_code_tests<ANY_HIT, CODES>(tris4, ~b.z, r, h)) return;
    cur = hit && !leaf ? b.z : b.w;
  }
}

// Lane c of a 16-byte vector (c a compile-time constant after unrolling,
// else a select).
__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane4(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// A walk's start: the stack holds the forest's other roots, the first
// root is the node to step on.
__device__ __forceinline__ int wide_start(const int* __restrict__ roots, int n_roots,
                                          int (&stack)[WIDE_STACK_CAP], int& sp) {
  sp = 0;
  for (int i = n_roots - 1; i >= 1; --i) stack[sp++] = __ldg(roots + i);
  return __ldg(roots);
}

// One step of the 8-wide walk (accel/wide.py), as the TPU's `_kernel`
// (cpu_ray_tracer_tpu/ops/pallas/wide_bvh.py:54) takes it, per ray and
// with the ray's own octant `oct`: at wide node `cur` it slab-tests the 8
// child boxes against the current t (an empty slot's NaN box fails), then
// tests each hit leaf child's slots in child order, then goes to the
// nearest hit interior child under the node's order word for the octant;
// with no interior child hit it pops the nearest pending one.  Returns
// the next node, or -1 where the walk has ended (the stack is empty, or
// with ANY_HIT a triangle was accepted).  `traversed` counts steps.
//
// The step reads one record of `wide_records` (accel/wide.py): 12 float4
// loads of the boxes (word 8f + k: field f of child k), 2 int4 loads of
// the child words and the octant's order word, all independent, through
// the read-only path.  The slab arithmetic per child is `slab_box`'s.
// The other hit interior children go on the stack as node ids, far to
// near, so that later pops return them nearest first: the pop order of
// the TPU kernel's stack word `node << 8 | pending mask`
// (wide_bvh.py:202-251), whose pop went back to the parent's record for
// its order and child words, two dependent loads (PERF.md: 0.93-0.95 of
// that pop's time).
template <bool ANY_HIT, bool CODES>
__device__ __forceinline__ int wide_step(const int4* __restrict__ records,
                                         const float4* __restrict__ tris4, int cur, int oct,
                                         const Ray& r, Hit& h, int (&stack)[WIDE_STACK_CAP],
                                         int& sp) {
  ++h.traversed;
  const int4* rec = records + (size_t)cur * WIDE_RECORD_INT4;
  const float4* box = reinterpret_cast<const float4*>(rec);
  float4 b[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) b[j] = __ldg(box + j);
  const int4 ca = __ldg(rec + 12), cb = __ldg(rec + 13);
  const int ow = __ldg(reinterpret_cast<const int*>(rec) + W_ORDER + oct);
  // a child word: 0 empty, > 0 an interior child, ~code a leaf
  int hitbits = 0, leafbits = 0, intbits = 0;
#pragma unroll
  for (int k = 0; k < WIDE; ++k) {
    const int g = k >> 2, c = k & 3;
    if (slab_box(lane4(b[g], c), lane4(b[2 + g], c), lane4(b[4 + g], c), lane4(b[6 + g], c),
                 lane4(b[8 + g], c), lane4(b[10 + g], c), r, h.t)) {
      hitbits |= 1 << k;
    }
    const int cw = lane4(g == 0 ? ca : cb, c);
    leafbits |= (cw < 0 ? 1 : 0) << k;
    intbits |= (cw > 0 ? 1 : 0) << k;
  }
  for (int lbits = hitbits & leafbits; lbits != 0; lbits &= lbits - 1) {
    const int k = __ffs(lbits) - 1;
    if (leaf_code_tests<ANY_HIT, CODES>(tris4, ~lane4(k < 4 ? ca : cb, k & 3), r, h)) return -1;
  }
  int bits = hitbits & intbits;
  const int n_int = __popc(bits);
  if (n_int == 0) return sp > 0 ? stack[--sp] : -1;
  // the hit interior children in near-to-far order: the nearest is the
  // next node, the j-th goes to entry top - j; the pack guarantees room
  // (accel/wide.py stack_need), a debug build checks it
  const int top = sp + n_int - 1;
#if defined(CRT_DEBUG) || defined(__CUDACC_DEBUG__)
  if (top > WIDE_STACK_CAP) __trap();
#endif
  int next = -1, j = 0;
#pragma unroll
  for (int rank = 0; rank < WIDE; ++rank) {
    const int s = (ow >> (3 * rank)) & 7;
    if ((bits >> s) & 1) {
      bits &= ~(1 << s);
      const int c = lane4(s < 4 ? ca : cb, s & 3);
      if (j == 0) {
        next = c;
      } else {
        stack[top - j] = c;
      }
      ++j;
    }
  }
  sp = top;
  return next;
}

// The whole 8-wide walk of one ray from the forest's roots, updating `h`
// (which starts as no_hit(t0)).
template <bool ANY_HIT, bool CODES>
__device__ __forceinline__ void walk_wide(const int4* __restrict__ records,
                                          const int* __restrict__ roots, int n_roots,
                                          const float4* __restrict__ tris4, const Ray& r,
                                          Hit& h) {
  int stack[WIDE_STACK_CAP];
  int sp;
  const int oct = octant(r);
  for (int cur = wide_start(roots, n_roots, stack, sp); cur >= 0;) {
    cur = wide_step<ANY_HIT, CODES>(records, tris4, cur, oct, r, h, stack, sp);
  }
}

// Hit ids from the meta word in lane 15 of the winning slot's shading
// record (packet_bvh.py:898-908): tri | obj << 20 | mat << 26; or, where a
// scene's ids do not fit it, from the slot's row (tri, obj, mat, 0) of
// `slot_ids` (accel/pack.py; packet_bvh.py:914-922), which is null
// otherwise: one 16-byte load either way.
struct Ids {
  int tri, obj, mat;
};

__device__ __forceinline__ Ids decode(const float* __restrict__ shade,
                                      const int4* __restrict__ slot_ids, int slot) {
  Ids ids{-1, -1, -1};
  if (slot >= 0 && slot_ids != nullptr) {
    const int4 q = __ldg(slot_ids + slot);
    ids.tri = q.x;
    ids.obj = q.y;
    ids.mat = q.z;
  } else if (slot >= 0) {
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
