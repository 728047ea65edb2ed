// The per-ray surface prologue shared by the wavefront path tracer
// (csrc/wavefront_pt.cu) and the Whitted level (csrc/whitted_wf.cu): the
// nearest hit over light quad -> floor plane -> BVH, hit info with the
// back-face flip, material fields, the xorshift draws and the dielectric
// terms.  Each formula follows the TPU kernel's own
// (cpu_ray_tracer_tpu/ops/pallas/wavefront_pt.py:221-393,
// whitted_wf.py:125-278) in the same float32 operation order; the plain
// versions in ops/wavefront_pt.py and ops/whitted_wf.py repeat it in
// PyTorch.
//
// Transcendentals are the CUDA math library's accurate functions, the ones
// PyTorch's own CUDA ops call for float32 (expf, sqrtf, sinf, cosf, rsqrtf,
// floorf), so that a kernel and its plain version on the card round alike.
//
// Scene scalars and the material table arrive as one float32 array
// (`ops/wavefront_pt.kernel_params`, integer fields bit-cast) that each
// block copies to shared memory.

#pragma once

#include <cstdint>

#include "ptraverse.cuh"

namespace crt {

constexpr float SHADE_EPS = 1e-3f;  // constants.SHADE_EPS
constexpr float IOR = 1.2f;  // constants.IOR
constexpr float UINT_TO_FLOAT = 2.3283064365387e-10f;  // core/rng.UINT_TO_FLOAT
constexpr int THREADS = 128;

// kernel_params layout (ops/wavefront_pt.py keeps the same numbers)
constexpr int P_LIGHT_INV_T = 0;  // 16, row-major 4x4
constexpr int P_LIGHT_N = 16;  // 3: -light_t[:3, 1]
constexpr int P_LIGHT_SIZE = 19;
constexpr int P_FLOOR_INV_TO = 20;
constexpr int P_LIGHT_POS = 21;  // 3: query.get_light_pos
constexpr int P_INV2PI_W = 24;  // diffuse estimator weight INVPI * 2pi
constexpr int P_TWO_PI = 25;
constexpr int P_MATS = 26;
constexpr int MAT_F = 13;  // per material: albedo 3, refl, refr, absorption 3,
//                            is_light, tex_id, tex_off, tex_w, tex_h (ints bit-cast)
constexpr int MAX_MATS = 64;
constexpr int PARAMS_MAX = P_MATS + MAX_MATS * MAT_F;

// Copy the params to shared memory; every thread of the block calls it.
__device__ __forceinline__ void load_params(float* s, const float* __restrict__ p, int n_mats) {
  const int n = P_MATS + n_mats * MAT_F;
  for (int k = threadIdx.x; k < n; k += blockDim.x) s[k] = __ldg(p + k);
  __syncthreads();
}

__device__ __forceinline__ float mat_f(const float* s, int mat, int field) {
  return s[P_MATS + mat * MAT_F + field];
}

__device__ __forceinline__ int mat_i(const float* s, int mat, int field) {
  return __float_as_int(s[P_MATS + mat * MAT_F + field]);
}

__device__ __forceinline__ float guard(float x) { return fabsf(x) < 1e-20f ? 1e-20f : x; }

// Light quad (object 0) in its local XZ plane, half-extent P_LIGHT_SIZE
// (template/primitives.h:321-345): hit iff 0 < t < t_max and inside.
__device__ __forceinline__ bool quad_hit(const float* s, float ox, float oy, float oz, float dx,
                                         float dy, float dz, float t_max, float& t) {
  const float* it = s + P_LIGHT_INV_T;
  const float oyq = ox * it[4] + oy * it[5] + oz * it[6] + it[7];
  const float dyq = guard(dx * it[4] + dy * it[5] + dz * it[6]);
  t = oyq / -dyq;
  const float oxq = ox * it[0] + oy * it[1] + oz * it[2] + it[3];
  const float ozq = ox * it[8] + oy * it[9] + oz * it[10] + it[11];
  const float dxq = dx * it[0] + dy * it[1] + dz * it[2];
  const float dzq = dx * it[8] + dy * it[9] + dz * it[10];
  const float ix = oxq + t * dxq;
  const float iz = ozq + t * dzq;
  const float size = s[P_LIGHT_SIZE];
  return t < t_max && t > 0.0f && ix > -size && ix < size && iz > -size && iz < size;
}

// What the nearest-hit prologue leaves for the shading.
struct Surface {
  float t, px, py, pz, nx, ny, nz, u, v;
  int obj;  // 0 light quad, 1 floor, 2 triangle, -1 miss
  int slot, mat, traversed, tested;
};

// FindNearest (file_scene.cpp:170-175) and GetHitInfo
// (tlas_file_scene.cpp:220-260): light quad, floor, then the BVH walk if
// `walk_bvh`; normal, uv and material id; back-face flip.
__device__ __forceinline__ Surface nearest_surface(const float* s, int n_mats,
                                                   const int* __restrict__ nodes,
                                                   const float* __restrict__ tris,
                                                   const float* __restrict__ shade, int root,
                                                   const Ray& r, bool walk_bvh) {
  float t = RAY_FAR, t_q;
  const bool hit_q = quad_hit(s, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t, t_q);
  if (hit_q) t = t_q;
  // floor: the +Y plane at distance 1 (template/primitives.h:107-111)
  const float t_f = -(r.oy + 1.0f) / guard(r.dy);
  const bool hit_f = t_f < t && t_f > 0.0f;
  if (hit_f) t = t_f;
  Hit h = no_hit(t);
  if (walk_bvh) walk<false>(nodes, tris, root, r, h);
  Surface o;
  o.t = h.t;
  o.slot = h.slot;
  o.traversed = h.traversed;
  o.tested = h.tested;
  const bool tri = h.slot >= 0;
  o.obj = tri ? 2 : (hit_f ? 1 : (hit_q ? 0 : -1));
  o.px = r.ox + h.t * r.dx;
  o.py = r.oy + h.t * r.dy;
  o.pz = r.oz + h.t * r.dz;
  if (tri) {
    const Attrs a = attributes(shade, h);
    const float sq = a.nx * a.nx + a.ny * a.ny + a.nz * a.nz;
    const float rn = rsqrtf(fmaxf(sq, 1e-20f));
    o.nx = a.nx * rn;
    o.ny = a.ny * rn;
    o.nz = a.nz * rn;
    o.u = a.tu;
    o.v = a.tv;
    o.mat = decode(shade, h.slot).mat;
  } else if (o.obj == 0) {
    o.nx = s[P_LIGHT_N];
    o.ny = s[P_LIGHT_N + 1];
    o.nz = s[P_LIGHT_N + 2];
    o.u = 0.0f;
    o.v = 0.0f;
    o.mat = 0;
  } else {
    // the floor, and the floor's normal for a miss, as the TPU kernel
    o.nx = 0.0f;
    o.ny = 1.0f;
    o.nz = 0.0f;
    if (o.obj == 1) {
      const float fito = s[P_FLOOR_INV_TO];
      const float fu = o.px * fito, fv = o.pz * fito;
      o.u = fu - floorf(fu);
      o.v = fv - floorf(fv);
    } else {
      o.u = 0.0f;
      o.v = 0.0f;
    }
    o.mat = o.obj == 1 ? 1 : n_mats - 1;  // error material for a miss
  }
  if (o.nx * r.dx + o.ny * r.dy + o.nz * r.dz > 0.0f) {
    o.nx = -o.nx;
    o.ny = -o.ny;
    o.nz = -o.nz;
  }
  return o;
}

// Nearest-texel index of a textured material (texture.h:61-96
// truncation), or -1 where the material has no texture.
__device__ __forceinline__ int texel_index(const float* s, int mat, float u, float v) {
  if (mat_i(s, mat, 9) < 0) return -1;
  const int off = mat_i(s, mat, 10), w = mat_i(s, mat, 11), h = mat_i(s, mat, 12);
  const float uu = fminf(fmaxf(u, 0.0f), 1.0f);
  const float vv = 1.0f - fminf(fmaxf(v, 0.0f), 1.0f);
  const int tx = min(max((int)(uu * (float)w), 0), w - 1);
  const int ty = min(max((int)(vv * (float)h), 0), h - 1);
  return off + tx + ty * w;
}

// xorshift32 (template/tmplmath.cpp:17-23) and RandomFloat: the uint32
// rounded to the nearest float32, times 2^-32.
__device__ __forceinline__ float rand_f32(uint32_t& seed) {
  seed ^= seed << 13;
  seed ^= seed >> 17;
  seed ^= seed << 5;
  return __uint2float_rn(seed) * UINT_TO_FLOAT;
}

// Dielectric terms (render/common.dielectric_terms, in the TPU kernel's
// operation order): Schlick Fresnel (1 under total internal reflection),
// whether refraction is possible, the transmitted and reflected directions.
struct Dielectric {
  float fr, tx, ty, tz, rx, ry, rz;
  bool can;
};

__device__ __forceinline__ Dielectric dielectric(float dx, float dy, float dz, float nx, float ny,
                                                 float nz, bool inside) {
  const float n1 = inside ? IOR : 1.0f;
  const float n2 = inside ? 1.0f : IOR;
  const float eta = n1 / n2;
  const float ddn = dx * nx + dy * ny + dz * nz;
  const float cosi = -ddn;
  const float cost2 = 1.0f - eta * eta * (1.0f - cosi * cosi);
  Dielectric o;
  o.can = cost2 > 0.0f;
  const float tscale = eta * cosi - sqrtf(fabsf(cost2));
  o.tx = eta * dx + tscale * nx;
  o.ty = eta * dy + tscale * ny;
  o.tz = eta * dz + tscale * nz;
  const float a = n1 - n2, b = n1 + n2;
  const float r0 = (a * a) / (b * b);
  const float c = 1.0f - cosi;
  o.fr = o.can ? r0 + (1.0f - r0) * c * c * c * c * c : 1.0f;
  o.rx = dx - 2.0f * nx * ddn;
  o.ry = dy - 2.0f * ny * ddn;
  o.rz = dz - 2.0f * nz * ddn;
  return o;
}

}  // namespace crt
