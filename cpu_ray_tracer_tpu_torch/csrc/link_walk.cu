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
// What bounds it on an H100: not bytes.  The main path's forests (4-6k
// nodes of 96 + 64 bytes, 14-20k triangle slots) sit in the 50 MB L2.  A
// cell partition has no gaps between siblings, so a ray visits many nodes
// whose box it enters, one dependent load chain per node (node record,
// then its link), and bounce rays diverge inside a warp: latency- and
// divergence-bound.  What the design does about it: no stack (the links
// carry the order), one 32-byte sector for the bounds, first slot and
// count, one word for the next link; loads through the read-only path.

#include <cstdint>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
closest_hit_links_kernel(const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                         const int* __restrict__ nodes, const int* __restrict__ links,
                         const float* __restrict__ tris, const float* __restrict__ shade,
                         int root, float* __restrict__ t_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ slot_out,
                         int* __restrict__ tri_out, int* __restrict__ obj_out,
                         int* __restrict__ mat_out, int* __restrict__ trav_out,
                         int* __restrict__ test_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) crt::walk_links<false>(nodes, links, tris, root, crt::load_ray(o, d, i), h);
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
occluded_links_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t0, const uint8_t* __restrict__ mask, int n,
                      const int* __restrict__ nodes, const int* __restrict__ links,
                      const float* __restrict__ tris, int root, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  crt::Hit h = crt::no_hit(__ldg(t0 + i));
  if (mask[i]) crt::walk_links<true>(nodes, links, tris, root, crt::load_ray(o, d, i), h);
  occ_out[i] = h.slot >= 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// As the entry points of csrc/closest_hit.cu, with the link table `links`.
int crt_closest_hit_links(const float* o, const float* d, const float* t0, const uint8_t* mask,
                          int n, const int* nodes, const int* links, const float* tris,
                          const float* shade, int root, float* t_out, float* u_out, float* v_out,
                          int* slot_out, int* tri_out, int* obj_out, int* mat_out, int* trav_out,
                          int* test_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    closest_hit_links_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, nodes, links, tris, shade, root, t_out, u_out, v_out, slot_out,
        tri_out, obj_out, mat_out, trav_out, test_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int crt_occluded_links(const float* o, const float* d, const float* t0, const uint8_t* mask,
                       int n, const int* nodes, const int* links, const float* tris, int root,
                       uint8_t* occ_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    occluded_links_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t0, mask, n, nodes, links, tris, root, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
