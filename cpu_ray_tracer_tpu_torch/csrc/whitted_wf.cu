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
// What bounds it on an H100: the two dependent-load walks per diffuse ray
// (csrc/closest_hit.cu); the shadow walk stops at its first hit.

#include <cstdint>
#include <cuda_runtime.h>

#include "surface.cuh"

namespace {

using namespace crt;

constexpr int F_MISS = 1, F_LIT = 2, F_SURF = 4, F_VIS = 8, F_EMIT1 = 16, F_EMIT2 = 32;

__global__ void __launch_bounds__(THREADS)
whitted_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const uint8_t* __restrict__ alive_in, const uint8_t* __restrict__ inside_in, int n,
               const int* __restrict__ nodes, const float* __restrict__ tris,
               const float* __restrict__ shade, int root, const float* __restrict__ params,
               int n_mats, int shadow_quirk, float* __restrict__ t_out,
               int* __restrict__ flags_out, int* __restrict__ mat_out, int* __restrict__ tex_out,
               float* __restrict__ irr_out, float* __restrict__ rdir_out,
               float* __restrict__ tdir_out, float* __restrict__ fr_out,
               int* __restrict__ trav_out, int* __restrict__ test_out) {
  __shared__ float s[PARAMS_MAX];
  load_params(s, params, n_mats);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool alive = alive_in == nullptr || alive_in[i] != 0;
  const bool inside = inside_in != nullptr && inside_in[i] != 0;
  const Ray r = load_ray(o, d, i);
  const Surface sf = nearest_surface(s, n_mats, nodes, tris, shade, root, r, alive);
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
      Hit sh = no_hit(shadow_quirk ? RAY_FAR : dmax);
      walk<true>(nodes, tris, root, make_ray(sox, soy, soz, ldx, ldy, ldz), sh);
      vis = sh.slot < 0;
    }
    const float att = 1.0f / fmaxf(dist * dist, 1e-20f);
    if (vis) irr = att * ndotl;
  }

  const Dielectric dl = dielectric(r.dx, r.dy, r.dz, sf.nx, sf.ny, sf.nz, inside);
  const bool is_mirror = surf && refl > 0.0f;
  const bool is_diel = surf && !(refl > 0.0f) && refr > 0.0f;
  t_out[i] = sf.t;
  flags_out[i] = (miss ? F_MISS : 0) | (is_light ? F_LIT : 0) | (surf ? F_SURF : 0) |
                 (vis ? F_VIS : 0) | (is_mirror || is_diel ? F_EMIT1 : 0) |
                 (is_diel && dl.can ? F_EMIT2 : 0);
  mat_out[i] = mat;
  tex_out[i] = tex;
  irr_out[i] = irr;
  rdir_out[3 * i] = dl.rx;
  rdir_out[3 * i + 1] = dl.ry;
  rdir_out[3 * i + 2] = dl.rz;
  tdir_out[3 * i] = dl.tx;
  tdir_out[3 * i + 1] = dl.ty;
  tdir_out[3 * i + 2] = dl.tz;
  fr_out[i] = dl.fr;
  trav_out[i] = sf.traversed;
  test_out[i] = sf.tested;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() of the launch.  `alive`
// and `inside` may be null (all alive, none inside).
int crt_whitted_wf(const float* o, const float* d, const uint8_t* alive, const uint8_t* inside,
                   int n, const int* nodes, const float* tris, const float* shade, int root,
                   const float* params, int n_mats, int shadow_quirk, float* t_out,
                   int* flags_out, int* mat_out, int* tex_out, float* irr_out, float* rdir_out,
                   float* tdir_out, float* fr_out, int* trav_out, int* test_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    whitted_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, alive, inside, n, nodes, tris, shade, root, params, n_mats, shadow_quirk, t_out,
        flags_out, mat_out, tex_out, irr_out, rdir_out, tdir_out, fr_out, trav_out, test_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
