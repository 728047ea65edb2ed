// The node-step sync probe: 256 steps of a threaded-link walk with ONE
// cursor per 4096-ray tile, in the variants of the TPU probe, which differ
// in how the tile decides where its cursor goes.
//
// Replaces the TPU kernel `make_kernel(variant)` of
// benchmarks/sync_probe.py:55 (launched by `run` at :277-288).  Per step
// the tile reads the cursor's node from the tables (box [6, M], octant-0
// hit/miss links [2, M]) and, by variant:
//   A   takes the hit link on an even node id, the miss link on an odd one
//       (a decision from the tables alone); no slab test;
//   B   as A, and every ray slab-tests the node (acc counts its hits);
//   C   every ray slab-tests the node; one block-wide OR decides (the TPU
//       packet kernel's shape: any ray hit -> hit link);
//   D   as B for 4 steps, then one block-wide int32 sum of the 4 steps'
//       packed bits; its result decides nothing (`(bits & 1) >= 0` is
//       always true at :264);
//   E1/E2/E8  eight slab tests of nodes (node + k) & 1023 per step, decided
//       by one packed sum (E1), two packed sums (E2) or eight ORs (E8);
//   F0/F1/F2  E8's tests masked by `t < 1e30 + step`, plus eight stack
//       stores and a pop (F0), a conditional (F1) or unconditional (F2)
//       leaf loop (:176-241).
// out = acc + cur (A-E) or acc + t + (cur + sp) (F).
//
// One block is one tile: the tile's shared cursor is the function's
// contract, since every ray's acc depends on the tile-wide decision.  1024
// threads hold 4 rays each; every thread follows the same cursor, from
// the tables staged in shared memory (the TPU's SMEM): 8 * M words, 43 KB
// for the main path's 1,333 nodes, plus the 128-word stack (zero-filled:
// the F variants read slot 0 before any write, :227-230) and the
// reduction partials.  A block-wide OR is `__syncthreads_or`; a block-wide
// sum is a warp `__reduce_add_sync`, one partial per warp in shared memory
// and one barrier, summed in uint32, where addition wraps as XLA's int32
// sum does (E1 and E2 overflow their packed fields, :154-163).  D keeps its
// sum on the path with `bits < 0`, which a sum of at most 4096 * 15 never
// is, so the compiler cannot drop the reduction the TPU probe times.  The
// E and F variants read nodes (node + k) & 1023: the wrapper refuses
// tables of fewer than 1,024 nodes.  The slab test is csrc/ptraverse.cuh's
// `slab_box` with its explicit NaN rule (jnp.minimum / maximum propagate
// NaN), against t = 1e30.  `node_walk_plain` (ops/sync_probe.py) is the
// same walk in plain PyTorch, all tiles at once; the outputs (small
// integers in float32, or 1e30 for F) are equal.
//
// Bound on an H100: float32 operations of the slab tests (B-D: 256 per
// ray, E/F: 2048) against the bytes of the rays (26 MB); A does no vector
// work and is bound by bytes, though its real limit is a chain of 256
// dependent shared-memory reads.

#include <cstdint>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int TILE = 4096;
constexpr int THREADS = 1024;
constexpr int RAYS = TILE / THREADS;  // per thread
constexpr int STEPS = 256;
constexpr int NODE_MASK = 1023;
constexpr int STACK = 128;
constexpr int WARPS = THREADS / 32;

enum Variant { A, B, C, D, E1, E2, E8, F0, F1, F2 };

// The slab test of csrc/ptraverse.cuh (its explicit NaN rule) on node
// `node` of the [6, m] table, against t = 1e30 (sync_probe.py:62-81).
__device__ __forceinline__ bool slab(const float* __restrict__ box, int m, int node,
                                     const crt::Ray& r) {
  return crt::slab_box(box[node], box[m + node], box[2 * m + node], box[3 * m + node],
                       box[4 * m + node], box[5 * m + node], r, 1e30f);
}

// Block-wide uint32 sum; the partials alternate between two buffers, so
// one barrier per sum suffices: a buffer is written again only after the
// next sum's barrier, which every thread reaches after reading it.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* partials, int& parity) {
  v = __reduce_add_sync(0xffffffffu, v);
  uint32_t* buf = partials + WARPS * parity;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += buf[w];
  return s;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
sync_probe_kernel(const float* __restrict__ aabb, const int* __restrict__ links, int m,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* box = smem;                                          // [6, m]
  int* hit_link = reinterpret_cast<int*>(smem + 6 * m);       // [m]
  int* miss_link = hit_link + m;                              // [m]
  int* stack = miss_link + m;                                 // [STACK]
  uint32_t* partials = reinterpret_cast<uint32_t*>(stack + STACK);  // [2, WARPS]
  for (int i = threadIdx.x; i < 6 * m; i += THREADS) box[i] = __ldg(aabb + i);
  for (int i = threadIdx.x; i < 2 * m; i += THREADS) hit_link[i] = __ldg(links + i);
  for (int i = threadIdx.x; i < STACK; i += THREADS) stack[i] = 0;
  __syncthreads();

  const size_t base = static_cast<size_t>(blockIdx.x) * TILE + threadIdx.x;
  crt::Ray r[RAYS];
  float acc[RAYS], t[RAYS];
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    const size_t i = base + k * THREADS;
    r[k] = crt::make_ray(__ldg(ox + i), __ldg(oy + i), __ldg(oz + i), __ldg(dx + i),
                         __ldg(dy + i), __ldg(dz + i));
    acc[k] = 0.0f;
    t[k] = 1e30f;
  }
  int cur = 0, sp = 1, parity = 0;

  if (V == A || V == B || V == C) {
    for (int step = 0; step < STEPS; ++step) {
      const int node = max(cur, 0);
      const int h = hit_link[node], ms = miss_link[node];
      bool take_hit;
      if (V == A) {
        take_hit = (node & 1) == 0;
      } else {
        int any = 0;
#pragma unroll
        for (int k = 0; k < RAYS; ++k) {
          const bool hk = slab(box, m, node, r[k]);
          acc[k] += hk ? 1.0f : 0.0f;
          any |= hk;
        }
        take_hit = V == B ? (node & 1) == 0 : __syncthreads_or(any) != 0;
      }
      cur = cur < 0 ? cur : (take_hit ? h : ms);
    }
  } else if (V == D) {
    for (int step = 0; step < STEPS; step += 4) {
      uint32_t packed = 0;  // this thread's rays' packed bits, summed
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int node = max(cur, 0);
        const int h = hit_link[node], ms = miss_link[node];
#pragma unroll
        for (int k = 0; k < RAYS; ++k) {
          const bool hk = slab(box, m, node, r[k]);
          acc[k] += hk ? 1.0f : 0.0f;
          packed += static_cast<uint32_t>(hk) << s;
        }
        cur = cur < 0 ? cur : ((node & 1) == 0 ? h : ms);
      }
      const int bits = static_cast<int>(block_sum(packed, partials, parity));
      cur = bits < 0 ? 0 : cur;
    }
  } else if (V == E1 || V == E2 || V == E8) {
    for (int step = 0; step < STEPS; ++step) {
      const int node = max(cur, 0);
      // the thread's share of the packed sums (E1: 4-bit fields, E2: two
      // words of 8-bit fields; a ray's fields are distinct, so its OR is
      // its sum) or its any-hit bit per node (E8).  Node by node, so that
      // one box is live at a time: a thread has 64 registers at 1,024
      // threads, and eight boxes held across the rays spill.
      uint32_t p0 = 0, p1 = 0, any = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int k = 0; k < RAYS; ++k) {
          const uint32_t hj = slab(box, m, (node + j) & NODE_MASK, r[k]) ? 1u : 0u;
          acc[k] += static_cast<float>(hj);
          if (V == E8) any |= hj << j;
          if (V == E1) p0 += hj << (4 * j);
          if (V == E2 && j < 4) p0 += hj << (8 * j);
          if (V == E2 && j >= 4) p1 += hj << (8 * (j - 4));
        }
      }
      int bits;
      if (V == E8) {
        bits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) bits |= (__syncthreads_or((any >> j) & 1u) != 0 ? 1 : 0) << j;
      } else if (V == E2) {
        const uint32_t s0 = block_sum(p0, partials, parity);
        bits = static_cast<int>(s0 | block_sum(p1, partials, parity));
      } else {
        bits = static_cast<int>(block_sum(p0, partials, parity));
      }
      const int h = hit_link[node], ms = miss_link[node];
      cur = cur < 0 ? cur : ((bits & 0xFF) != 0 ? h : ms);
    }
  } else {  // F0, F1, F2
    for (int step = 0; step < STEPS; ++step) {
      const int node = max(cur, 0);
      const float limit = 1e30f + static_cast<float>(step);
      int bits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int any = 0;
#pragma unroll
        for (int k = 0; k < RAYS; ++k)
          any |= slab(box, m, (node + j) & NODE_MASK, r[k]) && t[k] < limit;
        bits |= (__syncthreads_or(any) != 0 ? 1 : 0) << j;
      }
      if (V == F1 || V == F2) {
        const bool near = (bits & 3) > 0;
        const int lo = near ? (node & 7) : 9, hi = near ? (node & 7) + 2 : 0;
        if (V == F2 || hi > lo) {
          for (int i = V == F2 ? min(lo, hi) : lo; i < hi; ++i) {
#pragma unroll
            for (int k = 0; k < RAYS; ++k) {
              const float tt = acc[k] * 1.0000001f + static_cast<float>(i);
              t[k] = tt < t[k] ? tt : t[k];
              acc[k] = acc[k] + tt;
            }
          }
        }
      }
      // eight stack stores and a pop; every thread stores the same word
      // (the cursor is the block's), and reads back its own or an equal one
      int spm = sp;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        stack[spm] = hit_link[(node + j) & NODE_MASK];
        spm += (bits >> j) & 1;
      }
      spm = max(spm - 1, 0);
      cur = cur < 0 ? cur : (stack[max(spm - 1, 0)] & NODE_MASK);
      sp = spm & 63;
    }
  }

#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    out[base + k * THREADS] = V >= F0 ? acc[k] + t[k] + static_cast<float>(cur + sp)
                                      : acc[k] + static_cast<float>(cur);
  }
}

template <int V>
int launch(const float* aabb, const int* links, int m, const float* const* comps, int n_tiles,
           float* out, cudaStream_t stream) {
  const size_t smem = (8 * static_cast<size_t>(m) + STACK + 2 * WARPS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sync_probe_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sync_probe_kernel<V><<<n_tiles, THREADS, smem, stream>>>(
      aabb, links, m, comps[0], comps[1], comps[2], comps[3], comps[4], comps[5], out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// aabb [6, m], links [2, m] (octant 0: hit, miss), the six ray components
// [n_tiles * 4096] each, out [n_tiles * 4096]; variant 0-9 = A, B, C, D,
// E1, E2, E8, F0, F1, F2.
int crt_sync_probe(const float* aabb, const int* links, int m, const float* ox,
                   const float* oy, const float* oz, const float* dx, const float* dy,
                   const float* dz, int n_tiles, int variant, float* out, void* stream) {
  const float* comps[6] = {ox, oy, oz, dx, dy, dz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (variant) {
    case A: return launch<A>(aabb, links, m, comps, n_tiles, out, s);
    case B: return launch<B>(aabb, links, m, comps, n_tiles, out, s);
    case C: return launch<C>(aabb, links, m, comps, n_tiles, out, s);
    case D: return launch<D>(aabb, links, m, comps, n_tiles, out, s);
    case E1: return launch<E1>(aabb, links, m, comps, n_tiles, out, s);
    case E2: return launch<E2>(aabb, links, m, comps, n_tiles, out, s);
    case E8: return launch<E8>(aabb, links, m, comps, n_tiles, out, s);
    case F0: return launch<F0>(aabb, links, m, comps, n_tiles, out, s);
    case F1: return launch<F1>(aabb, links, m, comps, n_tiles, out, s);
    case F2: return launch<F2>(aabb, links, m, comps, n_tiles, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
