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
// nodes of 256 bytes) and the binary triangle slots (`tris4`, three
// 16-byte loads per triangle) sit in the 50 MB L2.
// A step reads one 256-byte record (8 boxes, 8 child words, the order
// word) and runs 8 independent slab tests, so a ray takes about a third
// of the binary walk's dependent steps; what remains is latency of those
// steps, the leaf tests, and divergence of bounce rays inside a warp.  The
// TPU kernel's per-node regrouped triangle rows are left out: a thread
// tests only the leaves its own ray hits.  The stack is one word per
// level (node << 8 | pending children), 32 words of local memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int THREADS = 128;

template <bool CODES>
__global__ void __launch_bounds__(THREADS)
closest_hit_wide_kernel(const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                        const int* __restrict__ wnodes, const int* __restrict__ roots,
                        int n_roots, const float4* __restrict__ tris4,
                        const float* __restrict__ shade,
                        const int4* __restrict__ slot_ids, float* __restrict__ t_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ slot_out, int* __restrict__ tri_out,
                        int* __restrict__ obj_out, int* __restrict__ mat_out,
                        int* __restrict__ trav_out, int* __restrict__ test_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) {
    crt::walk_wide<false, CODES>(wnodes, roots, n_roots, tris4, crt::load_ray(o, d, i), h);
  }
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
__global__ void __launch_bounds__(THREADS)
occluded_wide_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                     const int* __restrict__ wnodes, const int* __restrict__ roots, int n_roots,
                     const float4* __restrict__ tris4, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) {
    crt::walk_wide<true, CODES>(wnodes, roots, n_roots, tris4, crt::load_ray(o, d, i), h);
  }
  occ_out[i] = h.slot >= 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// As the entry points of csrc/closest_hit.cu, with the wide tables: the
// wide node records and the `n_roots` wide roots; `codes` the leaf code form.
int crt_closest_hit_wide(const float* o, const float* d, const float* t0, const uint8_t* mask,
                         int n, const int* wnodes, const int* roots, int n_roots,
                         const float4* tris4, const float* shade, const int4* slot_ids,
                         int codes, float* t_out, float* u_out, float* v_out, int* slot_out,
                         int* tri_out, int* obj_out, int* mat_out, int* trav_out, int* test_out,
                         void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? closest_hit_wide_kernel<true> : closest_hit_wide_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, wnodes, roots, n_roots, tris4, shade, slot_ids, t_out, u_out, v_out,
        slot_out, tri_out, obj_out, mat_out, trav_out, test_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int crt_occluded_wide(const float* o, const float* d, const float* t0, const uint8_t* mask,
                      int n, const int* wnodes, const int* roots, int n_roots, const float4* tris4,
                      int codes, uint8_t* occ_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? occluded_wide_kernel<true> : occluded_wide_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, wnodes, roots, n_roots, tris4, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
