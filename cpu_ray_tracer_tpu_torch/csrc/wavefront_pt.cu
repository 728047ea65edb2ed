// Wavefront path tracer: k bounce depths of the path tracer, one thread per
// ray, on the device without a host round trip between depths.
//
// Replaces the TPU kernel `_kernel` of
// cpu_ray_tracer_tpu/ops/pallas/wavefront_pt.py:165 (launched by `_run`
// :476 / `trace` :518), its stack walk and its link walk
// (ptraverse.py:35, :243).  Same contract, per ray, for depths
// depth_base + [0, k):
//   light quad -> floor -> BVH walk (csrc/ptraverse.cuh), hit info with the
//   back-face flip, material fields, Beer absorption while inside, four
//   xorshift draws (lobe, Fresnel, two for the hemisphere), the mirror,
//   dielectric or uniform-hemisphere diffuse continuation, throughput
//   update; a miss records `missed` before the depth cutoff
//   (depth_base + depth >= depth_limit ends the path); a light hit records
//   `lit`.  Emission is applied by the host.  Textured hits record the
//   nearest-texel index per depth and multiply albedo 1: the host multiplies
//   the texel factors in afterwards (albedo only scales the throughput).
// `trace_plain` in ops/wavefront_pt.py is the same per-ray math in plain
// PyTorch, lockstep over the rays.
//
// Where it differs from the TPU kernel, and why: the TPU kernel walks
// 4096-ray tiles behind one cursor in the tile's majority octant, takes
// draws for every lane of a tile with any live lane, and splits u32 -> f32
// and texture offsets into 16-bit and hi/lo parts for Mosaic.  Here a ray
// walks alone in its own octant, only live rays draw, u32 -> f32 is one
// round-to-nearest conversion, and offsets are plain int32.  Seeds arrive
// as the port's int64-held uint32 values and are narrowed to uint32 when
// loaded, widened again when stored.
//
// What bounds it on an H100: the walks' divergence inside a warp (the same
// primary rays in random warps take 1.7x as long, csrc/ptraverse.cuh), not
// bytes or float32 operations.  The design works on which rays share a
// warp, never on the walk order inside a ray, so every output stays the
// plain version's bit for bit: lane j takes ray perm[j]
// (`core/camera.lane_order`: a warp takes an 8x4 pixel tile, not a 1x32
// strip of a scanline) for all k depths, and every output is written at
// the ray's own index.  The tile order gains at k = 1 and loses at k = 6,
// so the path tracer passes it at k = 1 only (render/pathtracer.py).
// Handing each depth's survivors to the next launch through a device queue
// (ray indices bucketed by direction octant, or 64-byte records of the
// whole state appended a warp at a time; after every depth, or after depth
// 0 only) fills the warps of later depths but measured 1.2-1.4x slower
// than this one launch on an H100: each launch waits for its longest walk,
// and a queued warp mixes runs of rays from several screen regions
// (PERF.md).  So one launch runs all k depths with the state in registers,
// and the lanes of dead rays idle.
// The material table and scene scalars sit in shared memory.  The live
// count per depth is one __syncthreads_count per block and one atomicAdd.

#include <cstdint>
#include <cuda_runtime.h>

#include "surface.cuh"

namespace {

using namespace crt;

struct Args {
  const float *o, *d;
  const int64_t* seed_in;
  const uint8_t *alive_in, *inside_in;
  int n;
  SceneWalk walk;
  const float4* tris4;
  const float* shade;
  const float* params;
  int n_mats, k_depths, depth_limit, depth_base;
  float *tp_out, *o_out, *d_out;
  int64_t* seed_out;
  uint8_t *missed_out, *lit_out, *alive_out, *inside_out;
  int *tex_out, *locus_out, *trav_out, *test_out, *live_out;
  const int* perm;  // lane -> ray, or null (identity)
};

struct State {
  float ox, oy, oz, dx, dy, dz, tpx, tpy, tpz;
  uint32_t seed;
  bool inside, missed, lit;
  int locus, trav, test;
};

// The k depths of ray perm[j] in lane j.
template <bool LINKS, bool CODES>
__global__ void __launch_bounds__(THREADS) wavefront_kernel(const Args a) {
  __shared__ float s[PARAMS_MAX];
  load_params(s, a.params, a.n_mats);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  State st{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0u, false, false, false,
           -1, 0, 0};
  const bool in_range = j < a.n;
  const int i = !in_range ? -1 : a.perm != nullptr ? __ldg(a.perm + j) : j;
  bool alive = false;
  if (in_range) {
    st.ox = __ldg(a.o + 3 * i);
    st.oy = __ldg(a.o + 3 * i + 1);
    st.oz = __ldg(a.o + 3 * i + 2);
    st.dx = __ldg(a.d + 3 * i);
    st.dy = __ldg(a.d + 3 * i + 1);
    st.dz = __ldg(a.d + 3 * i + 2);
    st.seed = static_cast<uint32_t>(__ldg(a.seed_in + i));
    alive = a.alive_in == nullptr || a.alive_in[i] != 0;
    st.inside = a.inside_in != nullptr && a.inside_in[i] != 0;
  }
  for (int depth = 0; depth < a.k_depths; ++depth) {
    // rays alive entering the depth (the rays_traced count)
    const int live = __syncthreads_count(alive);
    if (threadIdx.x == 0 && live > 0) atomicAdd(a.live_out + depth, live);
    int tex = -1;
    if (alive) {
      const float dx = st.dx, dy = st.dy, dz = st.dz;
      const Surface sf = nearest_surface<LINKS, CODES>(
          s, a.n_mats, a.walk, a.tris4, a.shade, make_ray(st.ox, st.oy, st.oz, dx, dy, dz), true);
      st.trav += sf.traversed;
      st.test += sf.tested;
      bool hit = sf.obj >= 0;
      st.missed = st.missed || !hit;
      if (a.depth_base + depth >= a.depth_limit) hit = false;  // after the sky record
      const int mat = sf.mat;
      const bool is_light = hit && mat_i(s, mat, 8) != 0;
      st.lit = st.lit || is_light;
      const bool surf = hit && !is_light;

      float med_x = 1.0f, med_y = 1.0f, med_z = 1.0f;
      if (st.inside) {
        med_x = expf(mat_f(s, mat, 5) * (-sf.t));
        med_y = expf(mat_f(s, mat, 6) * (-sf.t));
        med_z = expf(mat_f(s, mat, 7) * (-sf.t));
      }
      const float refl = mat_f(s, mat, 3), refr = mat_f(s, mat, 4);
      const float r_lobe = rand_f32(st.seed);
      const bool pick_mirror = surf && r_lobe < refl;
      const bool pick_diel = surf && !pick_mirror && r_lobe < refl + refr;
      const bool pick_diff = surf && !pick_mirror && !pick_diel;
      const Dielectric dl = dielectric(dx, dy, dz, sf.nx, sf.ny, sf.nz, st.inside);
      const float r_fresnel = rand_f32(st.seed);
      const bool take_refract = pick_diel && dl.can && r_fresnel > dl.fr;

      // uniform hemisphere about the normal, Frisvad basis
      // (render/common.uniform_hemisphere, orthonormal_basis)
      const float z = rand_f32(st.seed);
      const float phi = s[P_TWO_PI] * rand_f32(st.seed);
      const float rxy = sqrtf(fmaxf(1.0f - z * z, 0.0f));
      const float hx = rxy * cosf(phi);
      const float hy = rxy * sinf(phi);
      const float nx = sf.nx, ny = sf.ny, nz = sf.nz;
      const float sgn = nz >= 0.0f ? 1.0f : -1.0f;
      const float af = -1.0f / (sgn + nz);
      const float bf = nx * ny * af;
      const float t1x = 1.0f + sgn * nx * nx * af;
      const float t1y = sgn * bf;
      const float t1z = -sgn * nx;
      const float t2y = sgn + ny * ny * af;
      const float ddx = t1x * hx + bf * hy + nx * z;
      const float ddy = t1y * hx + t2y * hy + ny * z;
      const float ddz = t1z * hx + -ny * hy + nz * z;
      const float cosr = fmaxf(ddx * nx + ddy * ny + ddz * nz, 0.0f);

      if (surf) tex = texel_index(s, mat, sf.u, sf.v);
      const bool record = tex >= 0;
      const float alb_x = record ? 1.0f : mat_f(s, mat, 0);
      const float alb_y = record ? 1.0f : mat_f(s, mat, 1);
      const float alb_z = record ? 1.0f : mat_f(s, mat, 2);
      const float dw = s[P_INV2PI_W] * cosr;
      if (surf) {
        st.tpx = st.tpx * med_x * (pick_diff ? alb_x * dw : alb_x);
        st.tpy = st.tpy * med_y * (pick_diff ? alb_y * dw : alb_y);
        st.tpz = st.tpz * med_z * (pick_diff ? alb_z * dw : alb_z);
        const float ndx = pick_diff ? ddx : (take_refract ? dl.tx : dl.rx);
        const float ndy = pick_diff ? ddy : (take_refract ? dl.ty : dl.ry);
        const float ndz = pick_diff ? ddz : (take_refract ? dl.tz : dl.rz);
        st.ox = sf.px + ndx * SHADE_EPS;
        st.oy = sf.py + ndy * SHADE_EPS;
        st.oz = sf.pz + ndz * SHADE_EPS;
        st.dx = ndx;
        st.dy = ndy;
        st.dz = ndz;
        st.locus = sf.slot;
      }
      st.inside = take_refract && !st.inside;
      alive = surf;
    }
    if (in_range) a.tex_out[(size_t)i * a.k_depths + depth] = tex;
  }
  if (!in_range) return;
  a.tp_out[3 * i] = st.tpx;
  a.tp_out[3 * i + 1] = st.tpy;
  a.tp_out[3 * i + 2] = st.tpz;
  a.o_out[3 * i] = st.ox;
  a.o_out[3 * i + 1] = st.oy;
  a.o_out[3 * i + 2] = st.oz;
  a.d_out[3 * i] = st.dx;
  a.d_out[3 * i + 1] = st.dy;
  a.d_out[3 * i + 2] = st.dz;
  a.seed_out[i] = static_cast<int64_t>(st.seed);
  a.missed_out[i] = st.missed;
  a.lit_out[i] = st.lit;
  a.alive_out[i] = alive;
  a.inside_out[i] = st.inside;
  a.locus_out[i] = st.locus;
  a.trav_out[i] = st.trav;
  a.test_out[i] = st.test;
}

template <bool LINKS, bool CODES>
int launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.n + THREADS - 1) / THREADS;
  wavefront_kernel<LINKS, CODES><<<blocks, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() of the launch.
// `alive` and `inside` may be null (all alive, none inside), `perm` too
// (the identity); `live_out` [k_depths] must be zeroed by the caller.
// `records` and `root` are the stack walk's `node_records` and
// `record_root`, or with `links` the link walk's `link_records` and first
// root over `m` nodes; `codes` is the scene's leaf code form
// (csrc/ptraverse.cuh).
int crt_wavefront_pt(const float* o, const float* d, const int64_t* seed, const uint8_t* alive,
                     const uint8_t* inside, int n, const int4* records, int m, int root, int links,
                     int codes, const float4* tris4, const float* shade, const float* params,
                     int n_mats, int k_depths, int depth_limit, int depth_base, const int* perm,
                     float* tp_out, float* o_out, float* d_out, int64_t* seed_out,
                     uint8_t* missed_out, uint8_t* lit_out, uint8_t* alive_out,
                     uint8_t* inside_out, int* tex_out, int* locus_out, int* trav_out,
                     int* test_out, int* live_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{o, d, seed, alive, inside, n, SceneWalk{records, m, root}, tris4, shade, params,
               n_mats, k_depths, depth_limit, depth_base, tp_out, o_out, d_out, seed_out,
               missed_out, lit_out, alive_out, inside_out, tex_out, locus_out, trav_out,
               test_out, live_out, perm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (links) return codes ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return codes ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

}  // extern "C"
