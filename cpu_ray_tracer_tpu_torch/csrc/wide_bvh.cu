// Closest-hit and any-hit queries over the 8-wide BVH, one thread per ray,
// on the wide walk `walk_wide` of csrc/ptraverse.cuh.
//
// Replaces the TPU kernel `_kernel` of
// cpu_ray_tracer_tpu/ops/pallas/wide_bvh.py:54 (launched at :292-335), in
// its closest-hit and any-hit modes, with the outputs of
// csrc/closest_hit.cu; the leaf slots are the binary pack's.
// `closest_hit_wide_plain` and `occluded_wide_plain` in ops/wide_bvh.py are
// the same walk in plain PyTorch, lockstep over rays.
//
// What bounds it on an H100: not bytes.  The main path's wide tree (221
// records of 256 bytes) and the binary triangle slots (`tris4`, three
// 16-byte loads per triangle) sit in the 50 MB L2.  A ray takes about a
// third of the binary walk's dependent steps; what remains is the latency
// of those steps, the leaf tests, and divergence inside a warp (the same
// primary rays in random warps take 1.89x as long).  So a step is one
// round of 15 independent loads of one record (`wide_records`), a pop is
// one stack read (node ids pushed far to near), and the lanes take the
// rays in the caller's order `perm` where one is given (the camera's lane
// order: a warp per 8x4 pixel tile), outputs staying in ray order.  Warps
// that stay resident and refill idle lanes from a global counter (Aila and
// Laine's dynamic fetch) lost on primary and Whitted any-hit rays and are
// not kept (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int THREADS = 128;
// blocks per SM the register budget must allow: 80 registers, the most
// at which six blocks fit; the main scene's instance took 90 uncapped,
// five blocks, and was 10% slower on bounce rays
constexpr int MIN_BLOCKS = 6;

struct Rays {
  const float *o, *d, *t0;
  const uint8_t* mask;
  int n;
  const int* perm;
};

struct Wide {
  const int4* records;
  const int* roots;
  int n_roots;
  const float4* tris4;
};

// Lane j walks ray perm[j] (ray j without `perm`); its outputs go to that
// ray's index.
template <bool ANY_HIT, bool CODES>
__device__ __forceinline__ bool wide_ray(const Rays& rays, const Wide& w, int& i, crt::Hit& h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rays.n) return false;
  i = rays.perm != nullptr ? __ldg(rays.perm + j) : j;
  h = crt::no_hit(__ldg(rays.t0 + i));
  if (rays.mask[i]) {
    crt::walk_wide<ANY_HIT, CODES>(w.records, w.roots, w.n_roots, w.tris4,
                                   crt::load_ray(rays.o, rays.d, i), h);
  }
  return true;
}

template <bool CODES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
closest_hit_wide_kernel(const Rays rays, const Wide w, const float* __restrict__ shade,
                        const int4* __restrict__ slot_ids, float* __restrict__ t_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ slot_out, int* __restrict__ tri_out,
                        int* __restrict__ obj_out, int* __restrict__ mat_out,
                        int* __restrict__ trav_out, int* __restrict__ test_out) {
  int i;
  crt::Hit h;
  if (!wide_ray<false, CODES>(rays, w, i, h)) return;
  const crt::Ids ids = crt::decode(shade, slot_ids, h.slot);
  t_out[i] = h.t;
  u_out[i] = h.u;
  v_out[i] = h.v;
  slot_out[i] = h.slot;
  tri_out[i] = ids.tri;
  obj_out[i] = ids.obj;
  mat_out[i] = ids.mat;
  trav_out[i] = h.traversed;
  test_out[i] = h.tested;
}

template <bool CODES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
occluded_wide_kernel(const Rays rays, const Wide w, uint8_t* __restrict__ occ_out) {
  int i;
  crt::Hit h;
  if (!wide_ray<true, CODES>(rays, w, i, h)) return;
  occ_out[i] = h.slot >= 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// As the entry points of csrc/closest_hit.cu, with the wide tables: the
// wide walk records and the `n_roots` wide roots; `codes` the leaf code
// form; `perm` the lane order (null: lane j takes ray j).
int crt_closest_hit_wide(const float* o, const float* d, const float* t0, const uint8_t* mask,
                         int n, const int4* records, const int* roots, int n_roots,
                         const float4* tris4, const float* shade, const int4* slot_ids,
                         int codes, const int* perm, float* t_out, float* u_out, float* v_out,
                         int* slot_out, int* tri_out, int* obj_out, int* mat_out, int* trav_out,
                         int* test_out, void* stream) {
  if (n > 0) {
    const Rays rays{o, d, t0, mask, n, perm};
    const Wide w{records, roots, n_roots, tris4};
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? closest_hit_wide_kernel<true> : closest_hit_wide_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, w, shade, slot_ids, t_out, u_out, v_out, slot_out, tri_out, obj_out, mat_out,
        trav_out, test_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int crt_occluded_wide(const float* o, const float* d, const float* t0, const uint8_t* mask,
                      int n, const int4* records, const int* roots, int n_roots,
                      const float4* tris4, int codes, const int* perm, uint8_t* occ_out,
                      void* stream) {
  if (n > 0) {
    const Rays rays{o, d, t0, mask, n, perm};
    const Wide w{records, roots, n_roots, tris4};
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? occluded_wide_kernel<true> : occluded_wide_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(rays, w, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
