// Closest-hit and any-hit queries over the scene's SAH BVH, one thread per
// ray, on the shared walk of csrc/ptraverse.cuh.
//
// Replaces the TPU kernel `_kernel_stack` of
// cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py (walk at :442-678, launched
// through `_run` / `traverse` at :691-926), in both its modes:
//   * closest hit: for every ray with mask != 0, the closest triangle hit in
//     (TRI_EPS, t0), its barycentrics, and the hit ids decoded from the meta
//     word in lane 15 of the winning slot's shading record
//     (packet_bvh.py:898-908), with per-ray step and test counters;
//   * any hit (`any_hit=True` there, packet_bvh.py:492-494, :587-588): one
//     byte per ray, whether a hit exists in (TRI_EPS, t0) — the shadow query
//     of scene/query.is_occluded.  The walk returns at the first accepted
//     triangle.
// `closest_hit_plain` and `occluded_plain` in ops/closest_hit.py are the same
// walk in plain PyTorch, lockstep over rays; the closest-hit outputs agree
// bit for bit, counters included, and so do the any-hit booleans.
//
// What bounds it on an H100: not bytes.  The tables of the main path's
// scene (about 1.3k nodes at 96 bytes, 11k triangle slots at 36 + 64 bytes)
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

#include "ptraverse.cuh"

namespace {

constexpr int THREADS = 128;

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
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) crt::walk<false>(nodes, tris, root, crt::load_ray(o, d, i), h);
  const crt::Ids ids = crt::decode(shade, h.slot);
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

__global__ void __launch_bounds__(THREADS)
occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                const int* __restrict__ nodes, const float* __restrict__ tris, int root,
                uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) crt::walk<true>(nodes, tris, root, crt::load_ray(o, d, i), h);
  occ_out[i] = h.slot >= 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success).  All pointers are device pointers; the caller
// allocates every output.
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

int crt_occluded(const float* o, const float* d, const float* t0, const uint8_t* mask, int n,
                 const int* nodes, const float* tris, int root, uint8_t* occ_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    occluded_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, nodes, tris, root, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* crt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
