// The leaf-test probes: Moller-Trumbore (MT) closest hit of every ray of a
// 4096-ray tile against 512 triangles, once per thread on the CUDA cores
// (K6) and once as a matrix product on the tensor cores (K7).
//
// K6 replaces the TPU kernel `make_vpu_kernel` of benchmarks/mxu_probe.py:65
// (launched at :174): 64 rows of 8 triangle records, tested in row order
// against every ray; the strict `tt < t` keeps the first of equal hits;
// out = t + u + v + slot (1e30 where nothing is hit).  Bound on an H100:
// float32 operations (58 per test as the probe writes it, 134M tests),
// not bytes (7 MB); but a test written that way issues about 75
// instructions unfused (no FMA, an IEEE reciprocal), and the first port
// ran within about a quarter of the issue floor that sets.  This kernel
// issues fewer instructions per test (PERF.md has the SASS counts and
// times):
//  * the wrapper packs each triangle once as four float4 (v0, n.x),
//    (e1, n.y), (e2, n.z), (v0 . n) with n = e1 x e2 (ops/leaf_probe.py
//    pack_vpu), and each ray keeps m = o x d; then c = s x d = m - v0 x d
//    (s = o - v0), and the test's four quantities are a = -(d . n),
//    u*a = e2 . c, v*a = -(e1 . c), t*a = o . n - v0 . n: 18 FMAs and
//    multiplies (written with __fmaf_rn: the file keeps -fmad=false for
//    K7's epilogue; forming s first took 8% longer);
//  * no division per test: a's sign is folded into u*a, v*a and t*a by an
//    XOR, and the test accepts when |a| >= 1e-4, U, V >= 0, U + V <= |a|
//    (which implies U <= |a| in float32 as well: U <= fl(U + V)) and
//    1e-4 |a| < T < t_best |a|; only an accept, which is rare, divides
//    (t_best = T / |a|), and u, v are divided out once per ray at the end;
//  * two rays a thread and two triangles a round: each broadcast of a
//    triangle's 16-byte shared loads feeds two tests, four tests are in
//    flight, and one branch serves the four (a branch each took 16%
//    longer; four rays a thread and one triangle a round, 7%).
// The contract: the kernel is NOT bit-equal to `vpu_leaf_plain` (which
// keeps the probe's arithmetic).  Like K7, it is held to it by the float64
// rule `benchmarks/leaf_tolerance.disagreements` (rtol 1e-5, tol 1e-5):
// every ray beyond rtol must be one whose decision the float64 evaluation
// shows too close to call, or whose output is the float64 winner's
// within the rule's moves.
//
// K7 replaces `make_mxu_kernel(m)` of benchmarks/mxu_probe.py:110
// (launched at :193): per flush i the product C[4m, 16] @ Phi[16, 4096]
// (rows a, u*a, v*a, t*a of m triangles, group i % 4 of C) and then the
// float32 epilogue: f = 1 / a, u/v/t, the accept chain, and the
// first-index min over the m candidates merged into the running t with a
// strict `tb < t`; 512 / m flushes.  The product runs here, in the
// kernel's body, on the tensor cores: `wgmma.mma_async` m64n64k8 in TF32
// (`mxu_leaf_kernel` below), three passes (big*big + big*small +
// small*big, each operand split into a TF32 head and a TF32 tail, small
// terms first) accumulated in float32, which agrees with a float32
// product to about 1e-6 relative; a single TF32 pass would move a, u*a,
// v*a and t*a by about 1e-3 and flip accept decisions.  TF32 operands of
// `wgmma` must be K-major, so the wrapper packs Phi ray-major (16 features
// of a ray in 64 bytes) and C in the fragment order of A in registers;
// the rays arrive by TMA.  Every ray's t + slot is written, not only the
// first 128 of a tile that the probe returns.  Bound on an H100: the
// larger of the three TF32 passes (51.5 GFLOP, a multiply-add counted as
// 2, at 495 TFLOP/s: 0.104 ms for 134M tests) and the epilogue on the
// CUDA cores (19 operations per test at 67 TFLOP/s: 0.038 ms); the two
// pipes run at the same time for different warpgroups.
// `mxu_leaf_plain` computes the product in float64, rounded once to
// float32.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "ptraverse.cuh"

namespace {

constexpr int TILE = 4096;  // rays per tile
constexpr int VPU_THREADS = 256;
constexpr int VPU_RAYS = 2;  // rays per thread

// ---- K6 ---------------------------------------------------------------

// One ray's state in K6: its origin, direction and m = o x d, and the best
// hit so far as t, the sign-folded u*a and v*a with their |a|, and the
// slot.
struct LeafRay {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, t, ua, va, a;
  int slot;
};

// One test's quantities with a's sign folded in (|a|, u*a, v*a, t*a), and
// whether it passes every check but the one against the ray's best t.
struct LeafTest {
  float aa, u, v, t;
  bool pre;
};

__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

// Triangle (v0 n.x | e1 n.y | e2 n.z | v0 . n) against ray r: with
// c = s x d = m - v0 x d, a = -(d . n), u*a = e2 . c, v*a = -(e1 . c) and
// t*a = o . n - v0 . n.
__device__ __forceinline__ LeafTest leaf_test(const float4& p0, const float4& p1,
                                              const float4& p2, float w, const LeafRay& r) {
  const float cx = __fmaf_rn(-p0.y, r.dz, __fmaf_rn(p0.z, r.dy, r.mx));
  const float cy = __fmaf_rn(-p0.z, r.dx, __fmaf_rn(p0.x, r.dz, r.my));
  const float cz = __fmaf_rn(-p0.x, r.dy, __fmaf_rn(p0.y, r.dx, r.mz));
  const float a = __fmaf_rn(-r.dz, p2.w, __fmaf_rn(-r.dy, p1.w, -r.dx * p0.w));
  const float ua = __fmaf_rn(p2.z, cz, __fmaf_rn(p2.y, cy, p2.x * cx));
  const float va = __fmaf_rn(-p1.z, cz, __fmaf_rn(-p1.y, cy, -p1.x * cx));
  const float ta = __fmaf_rn(r.oz, p2.w, __fmaf_rn(r.oy, p1.w, __fmaf_rn(r.ox, p0.w, -w)));
  const unsigned sign = __float_as_uint(a) & 0x80000000u;
  LeafTest q;
  q.aa = fabsf(a);
  q.u = flip(ua, sign);
  q.v = flip(va, sign);
  q.t = flip(ta, sign);
  q.pre = q.aa >= crt::TRI_EPS && q.u >= 0.0f && q.v >= 0.0f && q.u + q.v <= q.aa &&
          q.t > crt::TRI_EPS * q.aa;  // the walks' epsilon, the probe's 1e-4
  return q;
}

__device__ __forceinline__ bool nearer(const LeafTest& q, const LeafRay& r) {
  return q.pre && q.t < r.t * q.aa;
}

__device__ __forceinline__ void keep(const LeafTest& q, int k, LeafRay& r) {
  r.t = __fdiv_rn(q.t, q.aa);
  r.ua = q.u;
  r.va = q.v;
  r.a = q.aa;
  r.slot = k;
}

// 64 registers, so that four blocks fit an SM and the 512 blocks of the
// probe's 262,144 rays run in one wave (76 registers and three blocks a
// SM took 5% longer)
__global__ void __launch_bounds__(VPU_THREADS, 4)
vpu_leaf_kernel(const float4* __restrict__ tris, int n_tris, const float* __restrict__ ox,
                const float* __restrict__ oy, const float* __restrict__ oz,
                const float* __restrict__ dx, const float* __restrict__ dy,
                const float* __restrict__ dz, int n, float* __restrict__ out) {
  extern __shared__ float4 s_tri[];  // [n_tris][4]
  for (int i = threadIdx.x; i < 4 * n_tris; i += VPU_THREADS) s_tri[i] = __ldg(tris + i);
  __syncthreads();
  const int first = blockIdx.x * VPU_RAYS * VPU_THREADS + threadIdx.x;
  LeafRay ray[VPU_RAYS];
#pragma unroll
  for (int j = 0; j < VPU_RAYS; ++j) {
    const int i = min(first + j * VPU_THREADS, n - 1);
    const float x = __ldg(ox + i), y = __ldg(oy + i), z = __ldg(oz + i);
    const float u = __ldg(dx + i), v = __ldg(dy + i), w = __ldg(dz + i);
    ray[j] = LeafRay{x, y, z, u, v, w, __fmaf_rn(y, w, -(z * v)), __fmaf_rn(z, u, -(x * w)),
                     __fmaf_rn(x, v, -(y * u)), 1e30f, 0.0f, 0.0f, 1.0f, -1};
  }
  // two triangles a round (n_tris is even); each ray takes k, then k + 1
#pragma unroll 1
  for (int k = 0; k < n_tris; k += 2) {
    const float4* p = s_tri + 4 * k;
    const float pw = reinterpret_cast<const float*>(p + 3)[0];
    const float qw = reinterpret_cast<const float*>(p + 7)[0];
    const LeafTest a0 = leaf_test(p[0], p[1], p[2], pw, ray[0]);
    const LeafTest a1 = leaf_test(p[0], p[1], p[2], pw, ray[1]);
    const LeafTest b0 = leaf_test(p[4], p[5], p[6], qw, ray[0]);
    const LeafTest b1 = leaf_test(p[4], p[5], p[6], qw, ray[1]);
    // one branch for the four tests (a branch each measured 8% slower):
    // accepts are rare, and only a test that passes against the best t
    // before the round can pass against a t the round lowered
    if (nearer(a0, ray[0]) || nearer(b0, ray[0]) || nearer(a1, ray[1]) || nearer(b1, ray[1])) {
      if (nearer(a0, ray[0])) keep(a0, k, ray[0]);
      if (nearer(b0, ray[0])) keep(b0, k + 1, ray[0]);
      if (nearer(a1, ray[1])) keep(a1, k, ray[1]);
      if (nearer(b1, ray[1])) keep(b1, k + 1, ray[1]);
    }
  }
#pragma unroll
  for (int j = 0; j < VPU_RAYS; ++j) {
    const LeafRay& r = ray[j];
    const bool hit = r.slot >= 0;
    const float u = hit ? __fdiv_rn(r.ua, r.a) : 0.0f, v = hit ? __fdiv_rn(r.va, r.a) : 0.0f;
    if (first + j * VPU_THREADS < n) {
      out[first + j * VPU_THREADS] = r.t + u + v + static_cast<float>(r.slot);
    }
  }
}

// ---- K7 ---------------------------------------------------------------

constexpr int RAYS = 64;           // rays per tile: the N of m64n64k8
constexpr int PAIRS = 16;          // 512 tests per ray, 32 triangles per pair
// warpgroups of a block (measured: two took 0.45-0.52 ms, a producer
// warp beside three capped them at 128 registers and spilled)
constexpr int CONSUMERS = 3;
constexpr int TILE_BYTES = RAYS * 16 * 4;          // 4 KB: 64 rays x 16 features
constexpr int BLOCK_FLOATS = 2 * 2 * 128 * 4;      // one pair block of A: 8 KB
constexpr float FAR = 1e30f;

// The pair blocks of C: 1 for m = 8 (every pair's four flushes are groups
// 0-3 in warp order), else one per (group, 32-triangle part) of a flush.
__host__ __device__ constexpr int a_blocks(int m) { return m == 8 ? 1 : 4 * m / 32; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: rays [row, row + 64) of the ray-major feature table into `dst`,
// 64-byte swizzled, completing on `bar`.
__device__ __forceinline__ void tma_rays(void* dst, const CUtensorMap* map, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// The shared-memory descriptor of a K-major B tile (64 rays of 64 bytes,
// 64-byte swizzle) at `addr`, k step `ks` (32 bytes further): start
// address, leading offset 1 (unused when swizzled), stride 512 bytes
// between 8-ray groups, layout type 2 (64-byte swizzle).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int ks) {
  const uint64_t start = ((addr + 32u * ks) >> 4) & 0x3FFFu;
  return start | (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// d (+)= A @ B, one m64n64k8 TF32 product on the tensor cores: A from
// registers (each warp 16 rows, the m16n8k8 fragment), B from shared
// memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %36, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The accumulators are read only after the wait: an empty asm on each
// keeps the compiler from moving a read above it.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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

// (t, s) = the smaller of (t, s) and (ot, os), t first, then the slot:
// the strict `tb < t` of the flushes in order, and the first index among
// equal minima inside one
__device__ __forceinline__ void lexmin(float& t, int& s, float ot, int os) {
  if (ot < t || (ot == t && os < s)) {
    t = ot;
    s = os;
  }
}

// c ? a : b as one select instruction: a select between two array
// elements written in C++ may become a load at a selected index, which
// sends the array to local memory
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n selp.f32 %0, %2, %3, p;\n}\n"
      : "=f"(r)
      : "r"(static_cast<unsigned>(c)), "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ int pick(bool c, int a, int b) {
  int r;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n selp.b32 %0, %2, %3, p;\n}\n"
      : "=r"(r)
      : "r"(static_cast<unsigned>(c)), "r"(a), "r"(b));
  return r;
}

// One butterfly round over the lanes `MASK` apart: each keeps HALF of its
// first 2 * HALF columns (the upper lane the second half) and takes the
// smaller (t, slot) of its own and its partner's; template arguments, so
// that every index into the registers is a constant
template <int HALF, int MASK>
__device__ __forceinline__ void halve(float (&ct)[16], int (&cs)[16], int lane) {
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int x = 0; x < HALF; ++x) {
    const float send_t = pick(upper, ct[x], ct[x + HALF]);
    const int send_s = pick(upper, cs[x], cs[x + HALF]);
    float keep_t = pick(upper, ct[x + HALF], ct[x]);
    int keep_s = pick(upper, cs[x + HALF], cs[x]);
    const float ot = __shfl_xor_sync(0xffffffffu, send_t, MASK);
    const int os = __shfl_xor_sync(0xffffffffu, send_s, MASK);
    lexmin(keep_t, keep_s, ot, os);
    ct[x] = keep_t;
    cs[x] = keep_s;
  }
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// K7 on Hopper.  A block is CONSUMERS warpgroups, resident on an SM for
// the whole call; it takes 64-ray tiles blockIdx.x, + gridDim.x, ... in
// turn, warpgroup (tile order) % CONSUMERS.
//  * The first thread of each warpgroup keeps its two-stage ring of raw
//    ray tiles (ray-major, 64 rays x 16 floats, 4 KB) in flight by TMA on
//    mbarriers: the next tile's load overlaps the current tile's pairs.
//    (A separate producer warp counts as a fourth warpgroup in the
//    register budget: three consumers then get 128 registers and spill.)
//  * A warpgroup splits its tile into TF32 heads and tails in its own two
//    4 KB tiles (the same swizzled places) and runs the 16 pairs of the
//    tile: a pair is 32 triangles, two m64 accumulators [a; u*a] and
//    [v*a; t*a] (each warp 16 rows: rows g and g + 8 of lane g, 8
//    triangles), 3 passes x 2 k steps of m64n64k8 each, small terms
//    first, the two accumulators' chains alternating, A from registers
//    (split on the fly from the block's copy of C in fragment order; at
//    m = 8 every pair reads the same block, split once a tile), B from
//    the tile.  A pair's products and then its epilogue run in turn in
//    a warpgroup; the three warpgroups' phases overlap on the SM.  (Two
//    pairs in flight per warpgroup need the accumulators and A's
//    registers twice: 255 registers, spills, slower; PERF.md.)
//  * The epilogue is the probe's float32 chain per (triangle, ray); pair
//    P's triangle of warp w, lane g has slot 32P + 8w + g for every m (a
//    flush of m >= 32 is m / 32 pairs; at m = 8 a pair holds four
//    flushes, warp w flush 4P + w).  After each flush (each pair at
//    m = 8) the candidates go through a three-round butterfly over the 8
//    lanes of a column (16 columns a lane -> 2), then one shared-memory
//    step across the four warps, into the running (t, slot) of each ray,
//    which every warp keeps.  Accepting without `tt < t` and keeping the
//    smaller (t, slot) is the probe's strict `tb < t` over flushes in
//    order and first index among equal minima within one, so the result
//    is the probe's.
template <int M>
__global__ void __launch_bounds__(128 * CONSUMERS, 1)
mxu_leaf_kernel(const __grid_constant__ CUtensorMap rays, const float4* __restrict__ c_frag,
                int n_tiles64, float* __restrict__ out) {
  constexpr int NB = a_blocks(M);
  constexpr int PER_REDUCE = M == 8 ? 1 : M / 32;  // pairs per flush
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned: the swizzle pattern repeats every 512 bytes
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* stage_buf = base;                                          // [CONSUMERS][2][4 KB]
  uint8_t* split_buf = stage_buf + CONSUMERS * 2 * TILE_BYTES;        // [CONSUMERS][2][4 KB]
  float4* a_smem = reinterpret_cast<float4*>(split_buf + CONSUMERS * 2 * TILE_BYTES);
  float* red_t = reinterpret_cast<float*>(a_smem + NB * (BLOCK_FLOATS / 4));
  int* red_s = reinterpret_cast<int*>(red_t + CONSUMERS * 2 * 4 * RAYS);
  uint64_t* full = reinterpret_cast<uint64_t*>(red_s + CONSUMERS * 2 * 4 * RAYS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < NB * BLOCK_FLOATS / 4; i += 128 * CONSUMERS) {
    a_smem[i] = __ldg(c_frag + i);
  }
  if (tid == 0) {
    for (int s = 0; s < 2 * CONSUMERS; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int mine = (n_tiles64 - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);  // tiles of this block

  const int c = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  const int wt = tid & 127;  // thread of the warpgroup
  auto load = [&](int it, int s) {  // tile `it` of the block into stage s of this warpgroup
    mbar_expect(full + s, TILE_BYTES);
    tma_rays(stage_buf + s * TILE_BYTES, &rays,
             (static_cast<int>(blockIdx.x) + it * static_cast<int>(gridDim.x)) * RAYS, full + s);
  };
  if (wt == 0 && c < mine) load(c, 2 * c);
  float4* head = reinterpret_cast<float4*>(split_buf + (2 * c) * TILE_BYTES);
  float4* tail = reinterpret_cast<float4*>(split_buf + (2 * c + 1) * TILE_BYTES);
  const uint32_t head_addr = smem_addr(head), tail_addr = smem_addr(tail);
  float* rt = red_t + c * 2 * 4 * RAYS;
  int* rs = red_s + c * 2 * 4 * RAYS;
  int flushes = 0;
  for (int it = c, k = 0; it < mine; it += CONSUMERS, ++k) {
    const int s = 2 * c + (k & 1);
    mbar_wait(full + s, (k >> 1) & 1);
    // the next tile into the other stage, whose split every thread of the
    // warpgroup passed a barrier ago
    if (wt == 0 && it + CONSUMERS < mine) load(it + CONSUMERS, s ^ 1);
    // split the tile: each thread 2 of its 256 float4, in place of the swizzle
    const float4* raw = reinterpret_cast<const float4*>(stage_buf + s * TILE_BYTES);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 x = raw[wt + 128 * k];
      uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
      split(x.x, h0, l0);
      split(x.y, h1, l1);
      split(x.z, h2, l2);
      split(x.w, h3, l3);
      head[wt + 128 * k] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                       __uint_as_float(h2), __uint_as_float(h3));
      tail[wt + 128 * k] = make_float4(__uint_as_float(l0), __uint_as_float(l1),
                                       __uint_as_float(l2), __uint_as_float(l3));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + c);

    float bt[2] = {FAR, FAR};  // the running (t, slot) of columns 8g + 2q + e
    int bs[2] = {-1, -1};
    float ct[16];
    int cs[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      ct[x] = FAR;
      cs[x] = 0x7fffffff;
    }
    uint32_t ah[2][2][4], al[2][2][4];  // A of a pair: [accumulator][k step][register]
    auto load_a = [&](int pair) {  // C's block for the pair, split into heads and tails
      const float4* ab = a_smem + (pair % NB) * (BLOCK_FLOATS / 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const float4 v = ab[(h * 2 + ks) * 128 + w * 32 + lane];
          split(v.x, ah[h][ks][0], al[h][ks][0]);
          split(v.y, ah[h][ks][1], al[h][ks][1]);
          split(v.z, ah[h][ks][2], al[h][ks][2]);
          split(v.w, ah[h][ks][3], al[h][ks][3]);
        }
    };
    if (NB == 1) load_a(0);  // m = 8: every pair reads the same block
#pragma unroll 1
    for (int pair = 0; pair < PAIRS; ++pair) {
      if (NB > 1) load_a(pair);
      // a pair's first products overwrite the accumulators (scale-d 0);
      // zeroing them per pair measured faster than once per tile (the
      // products then wait on the last pair's registers)
      float d0[32], d1[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        d0[x] = 0.0f;
        d1[x] = 0.0f;
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {  // the small terms first, the two chains in turn
        wgmma(d0, al[0][ks], b_desc(head_addr, ks), ks);
        wgmma(d1, al[1][ks], b_desc(head_addr, ks), ks);
        wgmma(d0, ah[0][ks], b_desc(tail_addr, ks), 1);
        wgmma(d1, ah[1][ks], b_desc(tail_addr, ks), 1);
        wgmma(d0, ah[0][ks], b_desc(head_addr, ks), 1);
        wgmma(d1, ah[1][ks], b_desc(head_addr, ks), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(d0);
      fence_operands(d1);
      const int slot = 32 * pair + 8 * w + g;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = d0[4 * j + e], ua = d0[4 * j + 2 + e];
          const float va = d1[4 * j + e], ta = d1[4 * j + 2 + e];
          // the correctly rounded reciprocal: 1.0f / x, without the division
          const float f = __frcp_rn(fabsf(a) < 1e-30f ? 1e-30f : a);
          const float uu = ua * f, vv = va * f, tt = ta * f;
          const bool ok = fabsf(a) >= 1e-4f && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f &&
                          uu + vv <= 1.0f && tt > 1e-4f;
          if (ok && tt < ct[2 * j + e]) {  // strict: slots grow pair by pair
            ct[2 * j + e] = tt;
            cs[2 * j + e] = slot;
          }
        }
      if ((pair + 1) % PER_REDUCE != 0) continue;
      // the flush's minimum: lanes g and g ^ 4, g ^ 2, g ^ 1 halve the
      // columns each round; lane g keeps columns 8g + 2q + e
      halve<8, 16>(ct, cs, lane);
      halve<4, 8>(ct, cs, lane);
      halve<2, 4>(ct, cs, lane);
      // across the four warps, through shared memory (two buffers, so one
      // barrier a flush), into every warp's running (t, slot)
      const int buf = (flushes++ & 1) * 4 * RAYS;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rt[buf + w * RAYS + 8 * g + 2 * q + e] = ct[e];
        rs[buf + w * RAYS + 8 * g + 2 * q + e] = cs[e];
      }
      named_sync(1 + c);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int ow = 0; ow < 4; ++ow) {
          lexmin(bt[e], bs[e], rt[buf + ow * RAYS + 8 * g + 2 * q + e],
                 rs[buf + ow * RAYS + 8 * g + 2 * q + e]);
        }
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        ct[x] = FAR;
        cs[x] = 0x7fffffff;
      }
    }
    if (w == 0) {
      const int tile = static_cast<int>(blockIdx.x) + it * static_cast<int>(gridDim.x);
      float2* o = reinterpret_cast<float2*>(out + static_cast<size_t>(tile) * RAYS + 8 * g + 2 * q);
      *o = make_float2(bt[0] + static_cast<float>(bs[0]), bt[1] + static_cast<float>(bs[1]));
    }
  }
}

// Bytes of dynamic shared memory for m: 1 KB of alignment slack, the
// rings, the split tiles, C, the reduction buffers and the barriers.
__host__ __device__ constexpr int mxu_smem(int m) {
  return 1024 + CONSUMERS * 4 * TILE_BYTES + a_blocks(m) * BLOCK_FLOATS * 4 +
         CONSUMERS * 2 * 4 * RAYS * 8 + CONSUMERS * 2 * 8;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry points
// (no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of the ray-major features (64-ray boxes of 64 bytes,
// 64-byte swizzle), then the launch: one resident block per SM.
template <int M>
int launch_mxu(const float* c_frag, const float* phi_rm, int n_tiles, float* out,
               cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map;
  const cuuint64_t dims[2] = {16, static_cast<cuuint64_t>(n_tiles) * TILE};
  const cuuint64_t strides[1] = {16 * sizeof(float)};
  const cuuint32_t box[2] = {16, RAYS};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(phi_rm), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = mxu_leaf_kernel<M>;
  constexpr int smem = mxu_smem(M);
  static int blocks = 0;  // resident blocks, for the first device asked
  if (blocks == 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128 * CONSUMERS, smem);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles64 = n_tiles * TILE / RAYS;
  kernel<<<blocks < tiles64 ? blocks : tiles64, 128 * CONSUMERS, smem, stream>>>(
      map, reinterpret_cast<const float4*>(c_frag), tiles64, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6: packed [n_tris, 16] (ops/leaf_probe.py pack_vpu; n_tris even), the
// six ray components [n] each, out [n].  n_tris * 64 bytes of shared
// memory.
int crt_vpu_leaf(const float* packed, int n_tris, const float* ox, const float* oy,
                 const float* oz, const float* dx, const float* dy, const float* dz, int n,
                 float* out, void* stream) {
  if (n_tris % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int per_block = VPU_RAYS * VPU_THREADS;
    const int blocks = (n + per_block - 1) / per_block;
    const size_t smem = static_cast<size_t>(n_tris) * 4 * sizeof(float4);
    vpu_leaf_kernel<<<blocks, VPU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(packed), n_tris, ox, oy, oz, dx, dy, dz, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: c_frag, C in the kernel's fragment order (ops/leaf_probe.py
// pack_c: a_blocks(m) x 8 KB), phi_rm [n_tiles * 4096, 16] the rays'
// features ray-major (pack_phi), out [n_tiles, 4096] = t + slot of every
// ray; m in 8, 32, 64, 128.
int crt_mxu_leaf(const float* c_frag, const float* phi_rm, int n_tiles, int m, float* out,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (m) {
    case 8: return launch_mxu<8>(c_frag, phi_rm, n_tiles, out, s);
    case 32: return launch_mxu<32>(c_frag, phi_rm, n_tiles, out, s);
    case 64: return launch_mxu<64>(c_frag, phi_rm, n_tiles, out, s);
    case 128: return launch_mxu<128>(c_frag, phi_rm, n_tiles, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
