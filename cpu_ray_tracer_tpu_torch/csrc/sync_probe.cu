// The node-step sync probe: 256 steps of a threaded-link walk with ONE
// cursor per 4096-ray tile, in the variants of the TPU probe, which differ
// in how the tile decides where its cursor goes.
//
// Replaces the TPU kernel `make_kernel(variant)` of
// benchmarks/sync_probe.py:55 (launched by `run` at :277-288).  Per step
// the tile reads the cursor's node (box and octant-0 hit/miss links) and,
// by variant:
//   A   takes the hit link on an even node id, the miss link on an odd one
//       (a decision from the tables alone); no slab test;
//   B   as A, and every ray slab-tests the node (acc counts its hits);
//   C   every ray slab-tests the node; one tile-wide OR decides (the TPU
//       packet kernel's shape: any ray hit -> hit link);
//   D   as B for 4 steps, then one tile-wide int32 sum of the 4 steps'
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
// threads hold 4 rays each; every thread follows the same cursor, from the
// node records staged in shared memory (the TPU's SMEM), plus the 128-word
// stack (zero-filled: the F variants read slot 0 before any write,
// :227-230) and the reduction partials.  A block-wide OR is
// `__syncthreads_or`; a block-wide sum is a warp `__reduce_add_sync`, one
// partial per warp in shared memory and one barrier, summed in uint32,
// where addition wraps as XLA's int32 sum does (E1 and E2 overflow their
// packed fields, :154-163).  D keeps its sum on the path with `bits < 0`,
// which a sum of at most 4096 * 15 never is, so the compiler cannot drop
// the reduction the TPU probe times.
//
// What bounds it on an H100: the slab tests' float32 operations (B-D: 256
// per ray, E/F: 2048) against 67 TFLOP/s, but the kernel issues more
// instructions than it counts operations, on a grid of 225 tiles that
// gives 93 SMs two tiles and 39 one, so it is bound by instruction issue
// on the busiest SMs.  This design issues fewer instructions per step:
//  * one 32-byte record per node (box min, box max, hit link, miss link:
//    ops/sync_probe.py node_records), so a node is two 16-byte broadcast
//    loads from shared memory (the parent: eight scalar loads from [6, M]
//    and [2, M]);
//  * the slab test propagates NaN with PTX `min.NaN` / `max.NaN` (`slab`
//    below): a NaN from (b - o) * inf (an origin on a slab plane, a zero
//    direction component) reaches tmin or tmax exactly as jnp.minimum /
//    maximum carry it (:62-81), and the comparisons fail on it, so the
//    explicit NaN tests of csrc/ptraverse.cuh's `slab_box` (fminf / fmaxf
//    drop NaN) are not needed: the same boolean on every input, with six
//    compares and their ORs fewer (on the same records, `slab_box` took
//    1.18-1.56x as long, PERF.md);
//  * A decides from the tables alone, so one warp walks its cursor (one
//    dependent 8-byte load of the node's (hit, miss) pair and a select per
//    step, from a table of the pairs alone) and the block reads the result;
//    the parent ran the chain in all 32 warps and was bound by their
//    issue.
// Measured and not kept (PERF.md): a tile as a cluster of 4 blocks of 256
// threads, whose votes meet through distributed shared memory and a
// cluster barrier, to spread 900 quarter-tiles over the SMs: even on B
// (no vote), 0.89-0.98 of one block on the sums of E1 and E2, but 1.04 on
// D's and 1.5-1.8x on every OR vote (C, E8, F0-F2).
// The E and F variants read nodes (node + k) & 1023: the wrapper refuses
// tables of fewer than 1,024 nodes.  `node_walk_plain`
// (ops/sync_probe.py) is the same walk in plain PyTorch, all tiles at
// once; the outputs (small integers in float32, or 1e30 for F) are equal.

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

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The probe's slab test (sync_probe.py:62-81) of the node record (lo: min
// x, y, z, max x; hi: max y, z, hit, miss) against t = 1e30, NaN carried
// through min / max as jnp carries it.
__device__ __forceinline__ bool slab(const float4& lo, const float4& hi, const crt::Ray& r) {
  const float tx1 = (lo.x - r.ox) * r.rdx, tx2 = (lo.w - r.ox) * r.rdx;
  const float ty1 = (lo.y - r.oy) * r.rdy, ty2 = (hi.x - r.oy) * r.rdy;
  const float tz1 = (lo.z - r.oz) * r.rdz, tz2 = (hi.y - r.oz) * r.rdz;
  const float tmin = max_nan(max_nan(min_nan(tx1, tx2), min_nan(ty1, ty2)), min_nan(tz1, tz2));
  const float tmax = min_nan(min_nan(max_nan(tx1, tx2), max_nan(ty1, ty2)), max_nan(tz1, tz2));
  return tmax >= tmin && tmax > 0.0f && tmin < 1e30f;
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
  const uint4* b4 = reinterpret_cast<const uint4*>(buf);
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < WARPS / 4; ++w) {
    const uint4 q = b4[w];
    s += q.x + q.y + q.z + q.w;
  }
  return s;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
sync_probe_kernel(const int4* __restrict__ records, int m, const float* __restrict__ ox,
                  const float* __restrict__ oy, const float* __restrict__ oz,
                  const float* __restrict__ dx, const float* __restrict__ dy,
                  const float* __restrict__ dz, float* __restrict__ out) {
  extern __shared__ int4 smem[];
  // A: the (hit, miss) pairs [m]; the others: the records [m][2]
  const int table = V == A ? (m + 1) / 2 : 2 * m;  // int4 words
  int* stack = reinterpret_cast<int*>(smem + table);                 // [STACK]
  uint32_t* partials = reinterpret_cast<uint32_t*>(stack + STACK);   // [2, WARPS]
  if (V == A) {
    int2* pairs = reinterpret_cast<int2*>(smem);
    const int2* src = reinterpret_cast<const int2*>(records);
    for (int i = threadIdx.x; i < m; i += THREADS) pairs[i] = __ldg(src + 4 * i + 3);
  } else {
    for (int i = threadIdx.x; i < 2 * m; i += THREADS) smem[i] = __ldg(records + i);
  }
  for (int i = threadIdx.x; i < STACK; i += THREADS) stack[i] = 0;
  __syncthreads();
  const float4* rec = reinterpret_cast<const float4*>(smem);
  const int2* pairs = reinterpret_cast<const int2*>(smem);

  const size_t base = static_cast<size_t>(blockIdx.x) * TILE + threadIdx.x;
  crt::Ray r[RAYS];
  float acc[RAYS], t[RAYS];
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    const size_t i = base + k * THREADS;
    if (V != A) {
      r[k] = crt::make_ray(__ldg(ox + i), __ldg(oy + i), __ldg(oz + i), __ldg(dx + i),
                           __ldg(dy + i), __ldg(dz + i));
    }
    acc[k] = 0.0f;
    t[k] = 1e30f;
  }
  int cur = 0, sp = 1, parity = 0;

  if (V == A) {
    // the cursor depends on the tables alone: one warp walks it, as the
    // TPU's scalar core does, and the block reads it once
    int* walked = reinterpret_cast<int*>(partials);
    if (threadIdx.x < 32) {
#pragma unroll 1
      for (int step = 0; step < STEPS; ++step) {
        const int node = max(cur, 0);
        const int2 l = pairs[node];
        cur = cur < 0 ? cur : ((node & 1) == 0 ? l.x : l.y);
      }
      if (threadIdx.x == 0) *walked = cur;
    }
    __syncthreads();
    cur = *walked;
  } else if (V == B || V == C) {
#pragma unroll 1
    for (int step = 0; step < STEPS; ++step) {
      const int node = max(cur, 0);
      const float4 lo = rec[2 * node], hi = rec[2 * node + 1];
      int any = 0;
#pragma unroll
      for (int k = 0; k < RAYS; ++k) {
        const bool hk = slab(lo, hi, r[k]);
        if (hk) acc[k] += 1.0f;
        any |= hk;
      }
      const bool take_hit = V == B ? (node & 1) == 0 : __syncthreads_or(any) != 0;
      cur = cur < 0 ? cur : __float_as_int(take_hit ? hi.z : hi.w);
    }
  } else if (V == D) {
#pragma unroll 1
    for (int step = 0; step < STEPS; step += 4) {
      uint32_t packed = 0;  // this thread's rays' packed bits, summed
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int node = max(cur, 0);
        const float4 lo = rec[2 * node], hi = rec[2 * node + 1];
#pragma unroll
        for (int k = 0; k < RAYS; ++k) {
          const bool hk = slab(lo, hi, r[k]);
          if (hk) acc[k] += 1.0f;
          packed += static_cast<uint32_t>(hk) << s;
        }
        cur = cur < 0 ? cur : __float_as_int((node & 1) == 0 ? hi.z : hi.w);
      }
      const int bits = static_cast<int>(block_sum(packed, partials, parity));
      cur = bits < 0 ? 0 : cur;
    }
  } else if (V == E1 || V == E2 || V == E8) {
#pragma unroll 1
    for (int step = 0; step < STEPS; ++step) {
      const int node = max(cur, 0);
      // the thread's share of the packed sums (E1: 4-bit fields, E2: two
      // words of 8-bit fields; a ray's fields are distinct, so its OR is
      // its sum) or its any-hit bit per node (E8).  Node by node, so that
      // one box is live at a time: a thread has 64 registers at 1,024
      // threads a tile, and eight boxes held across the rays spill.
      uint32_t p0 = 0, p1 = 0, any = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nj = (node + j) & NODE_MASK;
        const float4 lo = rec[2 * nj], hi = rec[2 * nj + 1];
#pragma unroll
        for (int k = 0; k < RAYS; ++k) {
          const uint32_t hj = slab(lo, hi, r[k]) ? 1u : 0u;
          if (hj) acc[k] += 1.0f;
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
        for (int j = 0; j < 8; ++j) {
          bits |= (__syncthreads_or((any >> j) & 1u) != 0 ? 1 : 0) << j;
        }
      } else if (V == E2) {
        const uint32_t s0 = block_sum(p0, partials, parity);
        bits = static_cast<int>(s0 | block_sum(p1, partials, parity));
      } else {
        bits = static_cast<int>(block_sum(p0, partials, parity));
      }
      const int2 l = reinterpret_cast<const int2*>(rec + 2 * node + 1)[1];
      cur = cur < 0 ? cur : ((bits & 0xFF) != 0 ? l.x : l.y);
    }
  } else {  // F0, F1, F2
#pragma unroll 1
    for (int step = 0; step < STEPS; ++step) {
      const int node = max(cur, 0);
      const float limit = 1e30f + static_cast<float>(step);
      int bits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nj = (node + j) & NODE_MASK;
        const float4 lo = rec[2 * nj], hi = rec[2 * nj + 1];
        int any = 0;
#pragma unroll
        for (int k = 0; k < RAYS; ++k) any |= slab(lo, hi, r[k]) && t[k] < limit;
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
      // (the cursor is the tile's), and reads back its own or an equal one
      int spm = sp;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        stack[spm] = __float_as_int(rec[2 * ((node + j) & NODE_MASK) + 1].z);
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
int launch(const int4* records, int m, const float* const* comps, int n_tiles, float* out,
           cudaStream_t stream) {
  const int table = V == A ? (m + 1) / 2 : 2 * m;
  const size_t smem = table * sizeof(int4) + (STACK + 2 * WARPS) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sync_probe_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sync_probe_kernel<V><<<n_tiles, THREADS, smem, stream>>>(
      records, m, comps[0], comps[1], comps[2], comps[3], comps[4], comps[5], out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// records int32 [m, 8] (ops/sync_probe.py node_records: per node the box's
// min and max as float bits, then the octant-0 hit and miss links), the six
// ray components [n_tiles * 4096] each, out [n_tiles * 4096]; variant 0-9
// = A, B, C, D, E1, E2, E8, F0, F1, F2.
int crt_sync_probe(const int* records, int m, const float* ox, const float* oy,
                   const float* oz, const float* dx, const float* dy, const float* dz,
                   int n_tiles, int variant, float* out, void* stream) {
  const float* comps[6] = {ox, oy, oz, dx, dy, dz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* rec = reinterpret_cast<const int4*>(records);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (variant) {
    case A: return launch<A>(rec, m, comps, n_tiles, out, s);
    case B: return launch<B>(rec, m, comps, n_tiles, out, s);
    case C: return launch<C>(rec, m, comps, n_tiles, out, s);
    case D: return launch<D>(rec, m, comps, n_tiles, out, s);
    case E1: return launch<E1>(rec, m, comps, n_tiles, out, s);
    case E2: return launch<E2>(rec, m, comps, n_tiles, out, s);
    case E8: return launch<E8>(rec, m, comps, n_tiles, out, s);
    case F0: return launch<F0>(rec, m, comps, n_tiles, out, s);
    case F1: return launch<F1>(rec, m, comps, n_tiles, out, s);
    case F2: return launch<F2>(rec, m, comps, n_tiles, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
