// Closest-hit and any-hit queries over the grid and KD cell forests, one
// thread per ray, on the link walk `walk_links` of csrc/ptraverse.cuh.
//
// Replaces the TPU kernel `_kernel` of
// cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py:133 (the threaded hit/miss
// link walk, launched at :749-760), in its closest-hit and any-hit modes,
// with the outputs of csrc/closest_hit.cu.  `closest_hit_links_plain` and
// `occluded_links_plain` in ops/link_walk.py are the same walk in plain
// PyTorch, lockstep over rays.
//
// What bounds it on an H100: not bytes and not float32 operations.  The
// main path's forests (4-6k nodes, 35-43k triangle slots) sit in the 50 MB
// L2.  A cell partition has no gaps between siblings, so a ray visits many
// nodes whose box it enters, each visit a dependent load.  The 96-byte
// `nodes` record and the 64-byte `links` record made a visit touch two
// sectors in two cache lines with ten scalar loads.  This design walks
// `link_records`, one 32-byte record per octant and node, read as two
// 16-byte loads from one sector; the record holds the box, the hit link
// (or the leaf's slots) and the miss link, so the next node comes out of
// the record just visited and a ray's walk stays in its octant's slice
// (184 KB on the main path's grid).  No stack: the links carry the order.
// Triangles come from `tris4`, three 16-byte loads each
// (csrc/ptraverse.cuh).  That cut the kernel's time by 3-8%: the visit was
// already one round trip (node and link both depend on `cur` alone), and
// the walk is less sensitive to divergence than K1 (random warps of the
// same primary rays: 1.1x), so its length, ~7 visits per primary ray on
// the grid against ~2.3 binary steps, is what sets it apart.  128-thread
// blocks at 45-48 registers, no spills, no stack (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int THREADS = 128;

template <bool CODES>
__global__ void __launch_bounds__(THREADS)
closest_hit_links_kernel(const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                         const int4* __restrict__ link_records, int m,
                         const float4* __restrict__ tris4, const float* __restrict__ shade,
                         const int4* __restrict__ slot_ids, int root,
                         float* __restrict__ t_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ slot_out,
                         int* __restrict__ tri_out, int* __restrict__ obj_out,
                         int* __restrict__ mat_out, int* __restrict__ trav_out,
                         int* __restrict__ test_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) {
    crt::walk_links<false, CODES>(link_records, m, tris4, root, crt::load_ray(o, d, i), h);
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
occluded_links_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                      const int4* __restrict__ link_records, int m,
                      const float4* __restrict__ tris4, int root, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) {
    crt::walk_links<true, CODES>(link_records, m, tris4, root, crt::load_ray(o, d, i), h);
  }
  occ_out[i] = h.slot >= 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// As the entry points of csrc/closest_hit.cu, with the `m` nodes' link
// records (16-byte aligned), the forest's first root and the leaf code form.
int crt_closest_hit_links(const float* o, const float* d, const float* t0, const uint8_t* mask,
                          int n, const int4* link_records, int m, const float4* tris4,
                          const float* shade, const int4* slot_ids, int root, int codes,
                          float* t_out, float* u_out, float* v_out, int* slot_out, int* tri_out,
                          int* obj_out, int* mat_out, int* trav_out, int* test_out,
                          void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? closest_hit_links_kernel<true> : closest_hit_links_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, link_records, m, tris4, shade, slot_ids, root, t_out, u_out, v_out,
        slot_out, tri_out, obj_out, mat_out, trav_out, test_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int crt_occluded_links(const float* o, const float* d, const float* t0, const uint8_t* mask,
                       int n, const int4* link_records, int m, const float4* tris4, int root,
                       int codes, uint8_t* occ_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    (codes ? occluded_links_kernel<true> : occluded_links_kernel<false>)<<<
        blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, link_records, m, tris4, root, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
