// One level of the Whitted tracer with its shadow ray, one thread per ray.
//
// Replaces the TPU kernel `_kernel` of
// cpu_ray_tracer_tpu/ops/pallas/whitted_wf.py:70 (launched by `_run` :306 /
// `trace_level0` :346).  Same contract, per ray (2. WhittedStyle/
// renderer.cpp:21-126 as render/whitted._shade_level computes it):
//   light quad -> floor -> BVH walk and hit info (csrc/surface.cuh); the
//   nearest-texel index of a textured surface; for a diffuse surface the
//   point-light shadow ray: the light quad occludes up to dist - 2 EPS, the
//   triangles through the any-hit walk (csrc/ptraverse.cuh) up to RAY_FAR
//   when the scene keeps the reference's shadow quirk (file_scene.cpp:
//   177-187), else up to the same distance; N.L / dist^2 where visible; the
//   Schlick Fresnel term and the reflected and transmitted directions.
// Flags use the TPU kernel's bits (whitted_wf.py:62-67).  Dead rays skip
// both walks and report no hit.  `trace_level0_plain` in ops/whitted_wf.py
// is the same math in plain PyTorch.
//
// The TPU kernel always takes the quirk; this one reads it from the scene.
// Its walks are the stack walk's or, on a BVH too deep for the stack, the
// link walk's (csrc/surface.cuh), the TPU kernel's `traverse_stack` and
// `traverse_links` (ptraverse.py:35, :243).
//
// What bounds it on an H100: the two walks per diffuse ray, divergence-bound
// (csrc/ptraverse.cuh).  The design works on which rays share a warp; the
// walks and every output stay the plain version's bit for bit: lane j
// takes ray perm[j] (`core/camera.lane_order`, an 8x4 pixel tile per warp
// at level 0), and outputs go to the ray's own index.  Packing each
// block's shadow walks into full warps (a ballot per warp, a prefix over
// the block, the rays through shared memory) measured slower on an H100
// than walking them in their own lanes, 0.2859 against 0.2317 ms of device
// time at level 0 with the lane order (PERF.md), and is not kept: a tile's
// diffuse lanes already walk similar shadow rays together.

#include <cstdint>
#include <cuda_runtime.h>

#include "surface.cuh"

namespace {

using namespace crt;

constexpr int F_MISS = 1, F_LIT = 2, F_SURF = 4, F_VIS = 8, F_EMIT1 = 16, F_EMIT2 = 32;

struct Args {
  const float *o, *d;
  const uint8_t *alive_in, *inside_in;
  int n;
  SceneWalk walk;
  const float4* tris4;
  const float* shade;
  const float* params;
  int n_mats, shadow_quirk;
  const int* perm;  // lane -> ray, or null (identity)
  float* t_out;
  int *flags_out, *mat_out, *tex_out;
  float *irr_out, *rdir_out, *tdir_out, *fr_out;
  int *trav_out, *test_out;
};

template <bool LINKS, bool CODES>
__global__ void __launch_bounds__(THREADS) whitted_kernel(const Args a) {
  __shared__ float s[PARAMS_MAX];
  load_params(s, a.params, a.n_mats);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n) return;
  const int i = a.perm != nullptr ? __ldg(a.perm + j) : j;
  const bool alive = a.alive_in == nullptr || a.alive_in[i] != 0;
  const bool inside = a.inside_in != nullptr && a.inside_in[i] != 0;
  const Ray r = load_ray(a.o, a.d, i);
  const Surface sf = nearest_surface<LINKS, CODES>(s, a.n_mats, a.walk, a.tris4, a.shade, r, alive);
  const bool hit = alive && sf.obj >= 0;
  const bool miss = alive && sf.obj < 0;
  const int mat = sf.mat;
  const float refl = mat_f(s, mat, 3), refr = mat_f(s, mat, 4);
  const bool is_light = hit && mat_i(s, mat, 8) != 0;
  const bool surf = hit && !is_light;
  const int tex = surf ? texel_index(s, mat, sf.u, sf.v) : -1;

  // diffuse: point-light direct illumination (render/common.direct_illumination)
  bool vis = false;
  float irr = 0.0f;
  if (surf && 1.0f - (refl + refr) > 0.0f) {
    const float lx = s[P_LIGHT_POS] - sf.px;
    const float ly = s[P_LIGHT_POS + 1] - sf.py;
    const float lz = s[P_LIGHT_POS + 2] - sf.pz;
    const float dist = sqrtf(lx * lx + ly * ly + lz * lz);
    const float inv_d = 1.0f / fmaxf(dist, 1e-20f);
    const float ldx = lx * inv_d, ldy = ly * inv_d, ldz = lz * inv_d;
    const float ndotl = sf.nx * ldx + sf.ny * ldy + sf.nz * ldz;
    const float sox = sf.px + ldx * SHADE_EPS;
    const float soy = sf.py + ldy * SHADE_EPS;
    const float soz = sf.pz + ldz * SHADE_EPS;
    const float dmax = fmaxf(dist - 2.0f * SHADE_EPS, 1e-6f);
    float t_q;
    const bool occ_q = quad_hit(s, sox, soy, soz, ldx, ldy, ldz, dmax, t_q);
    if (ndotl >= SHADE_EPS && !occ_q) {
      Hit sh = no_hit(a.shadow_quirk ? RAY_FAR : dmax);
      walk_scene<LINKS, CODES, true>(a.walk, a.tris4, make_ray(sox, soy, soz, ldx, ldy, ldz), sh);
      vis = sh.slot < 0;
    }
    const float att = 1.0f / fmaxf(dist * dist, 1e-20f);
    if (vis) irr = att * ndotl;
  }

  const Dielectric dl = dielectric(r.dx, r.dy, r.dz, sf.nx, sf.ny, sf.nz, inside);
  const bool is_mirror = surf && refl > 0.0f;
  const bool is_diel = surf && !(refl > 0.0f) && refr > 0.0f;
  a.t_out[i] = sf.t;
  a.flags_out[i] = (miss ? F_MISS : 0) | (is_light ? F_LIT : 0) | (surf ? F_SURF : 0) |
                   (vis ? F_VIS : 0) | (is_mirror || is_diel ? F_EMIT1 : 0) |
                   (is_diel && dl.can ? F_EMIT2 : 0);
  a.mat_out[i] = mat;
  a.tex_out[i] = tex;
  a.irr_out[i] = irr;
  a.rdir_out[3 * i] = dl.rx;
  a.rdir_out[3 * i + 1] = dl.ry;
  a.rdir_out[3 * i + 2] = dl.rz;
  a.tdir_out[3 * i] = dl.tx;
  a.tdir_out[3 * i + 1] = dl.ty;
  a.tdir_out[3 * i + 2] = dl.tz;
  a.fr_out[i] = dl.fr;
  a.trav_out[i] = sf.traversed;
  a.test_out[i] = sf.tested;
}

template <bool LINKS, bool CODES>
int launch(const Args& a, cudaStream_t stream) {
  whitted_kernel<LINKS, CODES><<<(a.n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() of the launch.  `alive`
// and `inside` may be null (all alive, none inside), `perm` too (the
// identity).  `records` and `root` are the stack walk's `node_records` and
// `record_root`, or with `links` the link walk's `link_records` and first
// root over `m` nodes; `codes` is the scene's leaf code form
// (csrc/ptraverse.cuh).
int crt_whitted_wf(const float* o, const float* d, const uint8_t* alive, const uint8_t* inside,
                   int n, const int4* records, int m, int root, int links, int codes,
                   const float4* tris4, const float* shade, const float* params, int n_mats,
                   int shadow_quirk, const int* perm, float* t_out, int* flags_out, int* mat_out,
                   int* tex_out, float* irr_out, float* rdir_out, float* tdir_out, float* fr_out,
                   int* trav_out, int* test_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{o, d, alive, inside, n, SceneWalk{records, m, root}, tris4, shade, params, n_mats,
               shadow_quirk, perm, t_out, flags_out, mat_out, tex_out, irr_out, rdir_out,
               tdir_out, fr_out, trav_out, test_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (links) return codes ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return codes ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

}  // extern "C"
