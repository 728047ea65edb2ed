// Wavefront path tracer: k bounce depths of the path tracer in one launch,
// one thread per ray, with the ray's state in registers across the depths.
//
// Replaces the TPU kernel `_kernel` of
// cpu_ray_tracer_tpu/ops/pallas/wavefront_pt.py:165 (launched by `_run`
// :476 / `trace` :518).  Same contract, per ray, for depths
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
// What bounds it on an H100: the walk's dependent loads and divergence
// (csrc/closest_hit.cu), now across k depths per thread without a host
// round trip.  The material table and scene scalars sit in shared memory.
// The live count per depth is one __syncthreads_count per block and one
// atomicAdd.  Making it fast (sorting rays between depths inside the
// launch, persistent threads) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "surface.cuh"

namespace {

using namespace crt;

__global__ void __launch_bounds__(THREADS)
wavefront_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const int64_t* __restrict__ seed_in, const uint8_t* __restrict__ alive_in,
                 const uint8_t* __restrict__ inside_in, int n, const int4* __restrict__ records,
                 const float4* __restrict__ tris4, const float* __restrict__ shade, int root,
                 const float* __restrict__ params, int n_mats, int k_depths, int depth_limit,
                 int depth_base, float* __restrict__ tp_out, float* __restrict__ o_out,
                 float* __restrict__ d_out, int64_t* __restrict__ seed_out,
                 uint8_t* __restrict__ missed_out, uint8_t* __restrict__ lit_out,
                 uint8_t* __restrict__ alive_out, uint8_t* __restrict__ inside_out,
                 int* __restrict__ tex_out, int* __restrict__ locus_out,
                 int* __restrict__ trav_out, int* __restrict__ test_out,
                 int* __restrict__ live_out) {
  __shared__ float s[PARAMS_MAX];
  load_params(s, params, n_mats);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  uint32_t seed = 0;
  bool alive = false, inside = false;
  if (in_range) {
    ox = __ldg(o + 3 * i);
    oy = __ldg(o + 3 * i + 1);
    oz = __ldg(o + 3 * i + 2);
    dx = __ldg(d + 3 * i);
    dy = __ldg(d + 3 * i + 1);
    dz = __ldg(d + 3 * i + 2);
    seed = static_cast<uint32_t>(__ldg(seed_in + i));
    alive = alive_in == nullptr || alive_in[i] != 0;
    inside = inside_in != nullptr && inside_in[i] != 0;
  }
  float tpx = 1.0f, tpy = 1.0f, tpz = 1.0f;
  bool missed = false, lit = false;
  int trav = 0, test = 0, locus = -1;
  for (int depth = 0; depth < k_depths; ++depth) {
    // rays alive entering the depth (the rays_traced count)
    const int live = __syncthreads_count(alive);
    if (threadIdx.x == 0 && live > 0) atomicAdd(live_out + depth, live);
    int tex = -1;
    if (alive) {
      const Surface sf = nearest_surface(s, n_mats, records, tris4, shade, root,
                                         make_ray(ox, oy, oz, dx, dy, dz), true);
      trav += sf.traversed;
      test += sf.tested;
      bool hit = sf.obj >= 0;
      missed = missed || !hit;
      if (depth_base + depth >= depth_limit) hit = false;  // after the sky record
      const int mat = sf.mat;
      const bool is_light = hit && mat_i(s, mat, 8) != 0;
      lit = lit || is_light;
      const bool surf = hit && !is_light;

      float med_x = 1.0f, med_y = 1.0f, med_z = 1.0f;
      if (inside) {
        med_x = expf(mat_f(s, mat, 5) * (-sf.t));
        med_y = expf(mat_f(s, mat, 6) * (-sf.t));
        med_z = expf(mat_f(s, mat, 7) * (-sf.t));
      }
      const float refl = mat_f(s, mat, 3), refr = mat_f(s, mat, 4);
      const float r_lobe = rand_f32(seed);
      const bool pick_mirror = surf && r_lobe < refl;
      const bool pick_diel = surf && !pick_mirror && r_lobe < refl + refr;
      const bool pick_diff = surf && !pick_mirror && !pick_diel;
      const Dielectric dl = dielectric(dx, dy, dz, sf.nx, sf.ny, sf.nz, inside);
      const float r_fresnel = rand_f32(seed);
      const bool take_refract = pick_diel && dl.can && r_fresnel > dl.fr;

      // uniform hemisphere about the normal, Frisvad basis
      // (render/common.uniform_hemisphere, orthonormal_basis)
      const float z = rand_f32(seed);
      const float phi = s[P_TWO_PI] * rand_f32(seed);
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
        tpx = tpx * med_x * (pick_diff ? alb_x * dw : alb_x);
        tpy = tpy * med_y * (pick_diff ? alb_y * dw : alb_y);
        tpz = tpz * med_z * (pick_diff ? alb_z * dw : alb_z);
        const float ndx = pick_diff ? ddx : (take_refract ? dl.tx : dl.rx);
        const float ndy = pick_diff ? ddy : (take_refract ? dl.ty : dl.ry);
        const float ndz = pick_diff ? ddz : (take_refract ? dl.tz : dl.rz);
        ox = sf.px + ndx * SHADE_EPS;
        oy = sf.py + ndy * SHADE_EPS;
        oz = sf.pz + ndz * SHADE_EPS;
        dx = ndx;
        dy = ndy;
        dz = ndz;
        locus = sf.slot;
      }
      inside = take_refract && !inside;
      alive = surf;
    }
    if (in_range) tex_out[(size_t)i * k_depths + depth] = tex;
  }
  if (!in_range) return;
  tp_out[3 * i] = tpx;
  tp_out[3 * i + 1] = tpy;
  tp_out[3 * i + 2] = tpz;
  o_out[3 * i] = ox;
  o_out[3 * i + 1] = oy;
  o_out[3 * i + 2] = oz;
  d_out[3 * i] = dx;
  d_out[3 * i + 1] = dy;
  d_out[3 * i + 2] = dz;
  seed_out[i] = static_cast<int64_t>(seed);
  missed_out[i] = missed;
  lit_out[i] = lit;
  alive_out[i] = alive;
  inside_out[i] = inside;
  locus_out[i] = locus;
  trav_out[i] = trav;
  test_out[i] = test;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() of the launch.  `alive`
// and `inside` may be null (all alive, none inside); `live_out` [k_depths]
// must be zeroed by the caller.
int crt_wavefront_pt(const float* o, const float* d, const int64_t* seed, const uint8_t* alive,
                     const uint8_t* inside, int n, const int4* records, const float4* tris4,
                     const float* shade, int root, const float* params, int n_mats,
                     int k_depths, int depth_limit, int depth_base, float* tp_out, float* o_out,
                     float* d_out, int64_t* seed_out, uint8_t* missed_out, uint8_t* lit_out,
                     uint8_t* alive_out, uint8_t* inside_out, int* tex_out, int* locus_out,
                     int* trav_out, int* test_out, int* live_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    wavefront_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, seed, alive, inside, n, records, tris4, shade, root, params, n_mats, k_depths,
        depth_limit, depth_base, tp_out, o_out, d_out, seed_out, missed_out, lit_out, alive_out,
        inside_out, tex_out, locus_out, trav_out, test_out, live_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
