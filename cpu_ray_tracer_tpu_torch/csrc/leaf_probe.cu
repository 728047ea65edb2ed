// The leaf-test probes: Moller-Trumbore (MT) closest hit of every ray of a
// 4096-ray tile against 512 triangles, once per thread on the CUDA cores
// (K6) and once as a matrix product on the tensor cores (K7).
//
// K6 replaces the TPU kernel `make_vpu_kernel` of benchmarks/mxu_probe.py:65
// (launched at :174): 64 rows of 8 triangle records (v0, e1, e2 in floats
// 0-8 of each 16-float record), tested in row order against every ray; the
// strict `tt < t` keeps the first of equal hits; out = t + u + v + slot
// (1e30 where nothing is hit).  One thread per ray.  The 512 records' nine
// used floats (18 KB) are staged once per block in shared memory, and all
// threads read the same record at the same time: a broadcast.  The test is
// the walks' `moller_trumbore` (csrc/ptraverse.cuh), whose arithmetic and
// order are the probe's (mxu_probe.py:78-97); built with -fmad=false, the
// result equals `vpu_leaf_plain` (ops/leaf_probe.py) bit for bit.  Bound
// on an H100: float32 operations (58 per test, as the walks' test, 134M
// tests), not bytes (7 MB).
//
// K7 replaces `make_mxu_kernel(m)` of benchmarks/mxu_probe.py:110
// (launched at :193): per flush i the product C[4m, 16] @ Phi[16, 4096]
// (rows a, u*a, v*a, t*a of m triangles, group i % 4 of C) and then the
// float32 epilogue: f = 1 / a, u/v/t, the accept chain, and the
// first-index min over the m candidates merged into the running t with a
// strict `tb < t`; 512 / m flushes.  The product runs here, in the
// kernel's body, on the tensor cores: `mma.sync.m16n8k8` in TF32, three
// passes (big*big + big*small + small*big, each operand split into a TF32
// head and a TF32 tail) accumulated in float32, which agrees with a
// float32 product to about 1e-6 relative; a single TF32 pass would move
// a, u*a, v*a and t*a by about 1e-3 and flip accept decisions.  The
// wrapper packs C so that each 16-row fragment holds [a; u*a] or
// [v*a; t*a] of 8 triangles; a thread then holds all four quantities of
// one triangle for its two ray columns, and the epilogue needs no shared
// memory.  The min over the m candidates is a per-thread min over the
// groups of 8, then a three-step shuffle over the 8 lanes that share the
// ray columns.  Every ray's t + slot is written, not only the first 128
// of a tile that the probe returns, so no ray's epilogue is dead code.
// Bound on an H100: the larger of the three TF32 passes (51.5 GFLOP, a
// multiply-add counted as 2, at 495 TFLOP/s: 0.104 ms for 134M tests) and
// the epilogue on the CUDA cores (19 operations per test at 67 TFLOP/s:
// 0.038 ms); the two pipes run at the same time for different warps.
// `mxu_leaf_plain` computes the product in float64, rounded once to
// float32.

#include <cstdint>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int TILE = 4096;  // rays per tile
constexpr int RECORD = 16;  // floats per triangle record
constexpr int USED = 9;     // v0, e1, e2
constexpr int VPU_THREADS = 256;
constexpr int MXU_WARPS = 4;
constexpr int N_TILES = 4;  // 8-ray column tiles per warp: 32 rays

// ---- K6 ---------------------------------------------------------------

__global__ void __launch_bounds__(VPU_THREADS)
vpu_leaf_kernel(const float* __restrict__ tris, int n_tris, const float* __restrict__ ox,
                const float* __restrict__ oy, const float* __restrict__ oz,
                const float* __restrict__ dx, const float* __restrict__ dy,
                const float* __restrict__ dz, int n, float* __restrict__ out) {
  extern __shared__ float s_tri[];  // [n_tris][9]
  for (int i = threadIdx.x; i < n_tris * USED; i += blockDim.x) {
    s_tri[i] = __ldg(tris + (i / USED) * RECORD + i % USED);
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const crt::Ray ray = crt::make_ray(__ldg(ox + r), __ldg(oy + r), __ldg(oz + r), __ldg(dx + r),
                                     __ldg(dy + r), __ldg(dz + r));
  const crt::Tri* tri = reinterpret_cast<const crt::Tri*>(s_tri);
  float t = 1e30f, u = 0.0f, v = 0.0f;
  int slot = -1;
  for (int k = 0; k < n_tris; ++k) {
    float uu, vv, tt;
    if (crt::moller_trumbore(tri[k], ray, t, uu, vv, tt)) {
      t = tt;
      u = uu;
      v = vv;
      slot = k;
    }
  }
  out[r] = t + u + v + static_cast<float>(slot);
}

// ---- K7 ---------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = head + tail, both TF32: the head rounds x, the tail rounds the rest.
__device__ __forceinline__ void split(float x, uint32_t& head, uint32_t& tail) {
  head = to_tf32(x);
  tail = to_tf32(x - __uint_as_float(head));
}

// d += a @ b, one m16n8k8 TF32 product with a float32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts of m16n8k8 (PTX ISA), lane = 4 * g + q:
//   A (16x8, row-major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8x8, K x N):      b0 (q, g), b1 (q + 4, g)
//   D (16x8):            d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1)
// C packed by the wrapper: per group of 4m rows, per 8 triangles, 32 rows
// [a; u*a; v*a; t*a] of those 8, so that fragment h (rows 16h..16h+15)
// gives lane g the quantities 2h and 2h + 1 of triangle g in d0-d1 and
// d2-d3, for rays 2q and 2q + 1 of the column tile.
template <int M>
__global__ void __launch_bounds__(MXU_WARPS * 32)
mxu_leaf_kernel(const float* __restrict__ c_pack, const float* __restrict__ phi, int n_flush,
                float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tile = blockIdx.y;
  const int base = (blockIdx.x * MXU_WARPS + warp) * (8 * N_TILES);
  const float* ph = phi + static_cast<size_t>(tile) * 16 * TILE;

  // the rays' features (B), split once: [column tile][k step][register]
  uint32_t bh[N_TILES][2][2], bl[N_TILES][2][2];
#pragma unroll
  for (int j = 0; j < N_TILES; ++j)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split(__ldg(ph + (8 * ks + q + 4 * r) * TILE + base + 8 * j + g), bh[j][ks][r],
              bl[j][ks][r]);

  float t[N_TILES][2];
  int slot[N_TILES][2];
#pragma unroll
  for (int j = 0; j < N_TILES; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      t[j][e] = 1e30f;
      slot[j][e] = -1;
    }

  for (int i = 0; i < n_flush; ++i) {
    const float* cg = c_pack + static_cast<size_t>(i & 3) * 4 * M * 16;
    float bt[N_TILES][2];
    int bk[N_TILES][2];
#pragma unroll
    for (int j = 0; j < N_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bt[j][e] = 1e30f;
        bk[j][e] = 0;
      }
#pragma unroll 1
    for (int gi = 0; gi < M / 8; ++gi) {
      const float* c8 = cg + gi * 32 * 16;
      uint32_t ah[2][2][4], al[2][2][4];  // [fragment][k step][register]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int r0 = (16 * h + g) * 16, r1 = r0 + 8 * 16, c0 = 8 * ks + q;
          split(__ldg(c8 + r0 + c0), ah[h][ks][0], al[h][ks][0]);
          split(__ldg(c8 + r1 + c0), ah[h][ks][1], al[h][ks][1]);
          split(__ldg(c8 + r0 + c0 + 4), ah[h][ks][2], al[h][ks][2]);
          split(__ldg(c8 + r1 + c0 + 4), ah[h][ks][3], al[h][ks][3]);
        }
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) {
        float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {  // the small terms first
            mma(d[h], al[h][ks], bh[j][ks]);
            mma(d[h], ah[h][ks], bl[j][ks]);
            mma(d[h], ah[h][ks], bh[j][ks]);
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = d[0][e], ua = d[0][2 + e], va = d[1][e], ta = d[1][2 + e];
          const float f = 1.0f / (fabsf(a) < 1e-30f ? 1e-30f : a);
          const float uu = ua * f, vv = va * f, tt = ta * f;
          const bool ok = fabsf(a) >= 1e-4f && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f &&
                          uu + vv <= 1.0f && tt > 1e-4f && tt < t[j][e];
          const float cand = ok ? tt : 1e30f;
          if (cand < bt[j][e]) {  // strict: the first of equal candidates
            bt[j][e] = cand;
            bk[j][e] = gi * 8 + g;
          }
        }
      }
    }
    // the 8 lanes of a ray column (g = 0..7): the min, and the first index
    // among equal minima
#pragma unroll
    for (int j = 0; j < N_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = bt[j][e];
        int k = bk[j][e];
#pragma unroll
        for (int s = 4; s < 32; s <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, s);
          const int ok = __shfl_xor_sync(0xffffffffu, k, s);
          if (ov < v || (ov == v && ok < k)) {
            v = ov;
            k = ok;
          }
        }
        if (v < t[j][e]) {
          slot[j][e] = i * M + k;
          t[j][e] = v;
        }
      }
  }
  if (g == 0) {
    float* o = out + static_cast<size_t>(tile) * TILE + base + 2 * q;
#pragma unroll
    for (int j = 0; j < N_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) o[8 * j + e] = t[j][e] + static_cast<float>(slot[j][e]);
  }
}

template <int M>
int launch_mxu(const float* c_pack, const float* phi, int n_tiles, int n_flush, float* out,
               cudaStream_t stream) {
  const dim3 grid(TILE / (MXU_WARPS * 8 * N_TILES), n_tiles);  // 32 blocks of 128 rays a tile
  mxu_leaf_kernel<M><<<grid, MXU_WARPS * 32, 0, stream>>>(c_pack, phi, n_flush, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6: tris [n_tris / 8, 128] (8 records of 16 floats per row), the six ray
// components [n] each, out [n].  n_tris * 36 bytes of shared memory.
int crt_vpu_leaf(const float* tris, int n_tris, const float* ox, const float* oy,
                 const float* oz, const float* dx, const float* dy, const float* dz, int n,
                 float* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + VPU_THREADS - 1) / VPU_THREADS;
    const size_t smem = static_cast<size_t>(n_tris) * USED * sizeof(float);
    vpu_leaf_kernel<<<blocks, VPU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        tris, n_tris, ox, oy, oz, dx, dy, dz, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: c_pack [16m, 16] (the wrapper's packing of C), phi [n_tiles, 16,
// 4096], out [n_tiles, 4096] = t + slot of every ray; m in 8, 32, 64, 128.
int crt_mxu_leaf(const float* c_pack, const float* phi, int n_tiles, int m, int n_flush,
                 float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (m) {
    case 8: return launch_mxu<8>(c_pack, phi, n_tiles, n_flush, out, s);
    case 32: return launch_mxu<32>(c_pack, phi, n_tiles, n_flush, out, s);
    case 64: return launch_mxu<64>(c_pack, phi, n_tiles, n_flush, out, s);
    case 128: return launch_mxu<128>(c_pack, phi, n_tiles, n_flush, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
