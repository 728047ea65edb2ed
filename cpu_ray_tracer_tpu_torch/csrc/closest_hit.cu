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
// What bounds it on an H100: not bytes and not float32 operations (the
// primary launch sits at a few per cent of either bound).  The tables of
// the main path's scene (1,333 binary nodes, 11k triangle slots) sit in
// the 50 MB L2, and the walk is a chain of dependent loads per thread.
// This design walks `node_records`, where a step is one round trip, four
// independent 16-byte loads of the node's one 64-byte record (both
// children's boxes and refs, the near/far swap bit of every octant)
// instead of two (the 96-byte `nodes` record's near/far pair, then 16
// scalar loads of both children's), and `tris4`, three 16-byte loads per
// triangle (csrc/ptraverse.cuh); the record table (85 KB on the main
// scene) fits in L1.  That cut the kernel's time by 4-7% only: what bounds
// it now is divergence inside a warp (the same primary rays in random
// warps take 1.7x as long), which the host's ordering of bounce rays by
// (octant, previous-hit triangle) already works against.  128-thread
// blocks at 48-52 registers, no spills; the 64-entry stack stays in local
// memory (L1-cached); a register cap for more resident warps spills and
// is slower (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int THREADS = 128;

template <bool CODES>
__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                   const int4* __restrict__ records, const float4* __restrict__ tris4,
                   const float* __restrict__ shade, const int4* __restrict__ slot_ids, int root,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ slot_out,
                   int* __restrict__ tri_out, int* __restrict__ obj_out,
                   int* __restrict__ mat_out, int* __restrict__ trav_out,
                   int* __restrict__ test_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) crt::walk<false, CODES>(records, tris4, root, crt::load_ray(o, d, i), h);
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
occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                const int4* __restrict__ records, const float4* __restrict__ tris4, int root,
                uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) crt::walk<true, CODES>(records, tris4, root, crt::load_ray(o, d, i), h);
  occ_out[i] = h.slot >= 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success).  All pointers are device pointers, the tables
// 16-byte aligned; the caller allocates every output.  `root` is the
// scene's `record_root`; `slot_ids` is null unless the scene's ids do not
// fit the meta word; `codes` is the scene's leaf code form (accel/pack.py).
int crt_closest_hit(const float* o, const float* d, const float* t0, const uint8_t* mask, int n,
                    const int4* records, const float4* tris4, const float* shade,
                    const int4* slot_ids, int root, int codes, float* t_out, float* u_out,
                    float* v_out, int* slot_out, int* tri_out, int* obj_out, int* mat_out,
                    int* trav_out, int* test_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? closest_hit_kernel<true> : closest_hit_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, records, tris4, shade, slot_ids, root, t_out, u_out, v_out, slot_out,
        tri_out, obj_out, mat_out, trav_out, test_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int crt_occluded(const float* o, const float* d, const float* t0, const uint8_t* mask, int n,
                 const int4* records, const float4* tris4, int root, int codes,
                 uint8_t* occ_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? occluded_kernel<true> : occluded_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, records, tris4, root, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* crt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
