// Closest-hit query over the scene's SAH BVH, one thread per ray.
//
// Replaces the TPU kernel `_kernel_stack` of
// cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py (walk at :442-678, launched
// through `_run` / `traverse` at :691-926).  Same contract: for every ray
// with mask != 0, the closest triangle hit in (TRI_EPS, t0), its
// barycentrics, and the hit ids decoded from the meta word in lane 15 of
// the winning slot's shading record (packet_bvh.py:898-908).
//
// The TPU kernel walks a 4096-ray packet behind one scalar cursor, with the
// node tables in SMEM, the tile's majority octant and lane-uniform
// counters: that shape is the TPU's.  Here each thread walks its own ray:
//   * ordered two-child descent: a step takes one interior node, slab-tests
//     both children against the ray's current t, runs the Moller-Trumbore
//     tests of the near child's leaf and then of the far child's leaf,
//     descends into the near interior child and pushes the far one on a
//     per-thread stack (infra/bvh.cpp:224-258), near and far chosen by the
//     ray's OWN direction octant;
//   * the counters are per ray: `traversed` counts steps (interior nodes),
//     `tested` counts triangle tests.
// `closest_hit_plain` in ops/closest_hit.py is the same walk in plain
// PyTorch, lockstep over rays; the two agree bit for bit, counters
// included.  Build with -fmad=false: the plain version's elementwise ops
// are not contracted into fused multiply-adds either.
//
// What bounds it on an H100: not bytes.  The tables of the main path's
// scene (about 2k nodes at 96 bytes, 11k triangle slots at 36 + 64 bytes)
// sit in the 50 MB L2 after the first touch.  The walk is a chain of
// dependent loads (node record -> child records -> triangles) per thread,
// and bounce rays diverge inside a warp.  So it is latency- and
// divergence-bound.  What this design does about it: the host orders
// bounce rays by (octant, previous-hit triangle) before the launch, so
// neighbouring threads leave the same triangle in similar directions and
// walk similar paths; a child's bounds, first slot and count are the first
// 32 bytes of its 96-byte record, one sector; loads go through the
// read-only path.  Making it fast (wider nodes, packets per warp,
// persistent threads) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NODE_WORDS = 24;  // accel/pack.py NODE_WORDS
constexpr int N_FIRST = 6;
constexpr int N_COUNT = 7;
constexpr int N_NEARFAR = 8;
constexpr int STACK_CAP = 64;  // accel/pack.py STACK_CAP (asserted at pack time)
constexpr int THREADS = 128;
constexpr float TRI_EPS = 1e-4f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, rdx, rdy, rdz;
};

struct Best {
  float t, u, v;
  int slot, tested;
};

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
// first-tested of equal hits.
__device__ __forceinline__ void leaf_tests(const float* __restrict__ tris, int first, int count,
                                           const Ray& r, Best& b) {
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
        tt > TRI_EPS && tt < b.t) {
      b.t = tt;
      b.u = uu;
      b.v = vv;
      b.slot = first + k;
    }
  }
  b.tested += count;
}

__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                   const int* __restrict__ nodes, const float* __restrict__ tris,
                   const float* __restrict__ shade, int root,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ slot_out,
                   int* __restrict__ tri_out, int* __restrict__ obj_out,
                   int* __restrict__ mat_out, int* __restrict__ trav_out,
                   int* __restrict__ test_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Best b{__ldg(t0 + i), 0.0f, 0.0f, -1, 0};
  int traversed = 0;
  if (mask[i]) {
    Ray r;
    r.ox = __ldg(o + 3 * i);
    r.oy = __ldg(o + 3 * i + 1);
    r.oz = __ldg(o + 3 * i + 2);
    r.dx = __ldg(d + 3 * i);
    r.dy = __ldg(d + 3 * i + 1);
    r.dz = __ldg(d + 3 * i + 2);
    r.rdx = 1.0f / r.dx;
    r.rdy = 1.0f / r.dy;
    r.rdz = 1.0f / r.dz;
    const int oct = (r.dx < 0.0f ? 1 : 0) + (r.dy < 0.0f ? 2 : 0) + (r.dz < 0.0f ? 4 : 0);
    const float* fnodes = reinterpret_cast<const float*>(nodes);
    const int root_count = __ldg(nodes + root * NODE_WORDS + N_COUNT);
    if (root_count > 0) {
      // a one-leaf tree: no interior node to step on; its box, then its
      // triangles (the JAX package's link walk takes this case)
      if (slab(fnodes + root * NODE_WORDS, r, b.t)) {
        leaf_tests(tris, __ldg(nodes + root * NODE_WORDS + N_FIRST), root_count, r, b);
      }
    } else {
      int stack[STACK_CAP];
      int sp = 0;
      int cur = root;
      while (cur >= 0) {
        const int* rec = nodes + cur * NODE_WORDS + N_NEARFAR + 2 * oct;
        const int near = __ldg(rec), far = __ldg(rec + 1);
        const int* nrec = nodes + near * NODE_WORDS;
        const int* frec = nodes + far * NODE_WORDS;
        const bool hit_n = slab(fnodes + near * NODE_WORDS, r, b.t);
        const bool hit_f = slab(fnodes + far * NODE_WORDS, r, b.t);
        const int count_n = __ldg(nrec + N_COUNT), count_f = __ldg(frec + N_COUNT);
        if (hit_n && count_n > 0) leaf_tests(tris, __ldg(nrec + N_FIRST), count_n, r, b);
        if (hit_f && count_f > 0) leaf_tests(tris, __ldg(frec + N_FIRST), count_f, r, b);
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
        ++traversed;
      }
    }
  }
  int tri = -1, obj = -1, mat = -1;
  if (b.slot >= 0) {
    const int meta = __float_as_int(__ldg(shade + (size_t)b.slot * 16 + 15));
    if (meta >= 0) {
      tri = meta & 0xFFFFF;
      obj = (meta >> 20) & 0x3F;
      mat = (meta >> 26) & 0x3F;
    }
  }
  t_out[i] = b.t;
  u_out[i] = b.u;
  v_out[i] = b.v;
  slot_out[i] = b.slot;
  tri_out[i] = tri;
  obj_out[i] = obj;
  mat_out[i] = mat;
  trav_out[i] = traversed;
  test_out[i] = b.tested;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).  All pointers are device pointers; the caller allocates every
// output.
int crt_closest_hit(const float* o, const float* d, const float* t0, const uint8_t* mask, int n,
                    const int* nodes, const float* tris, const float* shade, int root,
                    float* t_out, float* u_out, float* v_out, int* slot_out, int* tri_out,
                    int* obj_out, int* mat_out, int* trav_out, int* test_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    closest_hit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, nodes, tris, shade, root, t_out, u_out, v_out, slot_out, tri_out,
        obj_out, mat_out, trav_out, test_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* crt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
