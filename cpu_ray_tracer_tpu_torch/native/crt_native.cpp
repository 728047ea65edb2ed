// Host-side BVH builders of the PyTorch port: the binned-SAH build, the SBVH
// (spatial-split) build and the per-octant threaded links.
//
// A copy of the JAX package's native/crt_native.cpp with the same build
// semantics, function for function (subdivide, s_build, crt_thread_links),
// so that both packages build the same trees from the same triangles.  Its
// unused grid insertion is left out.  Build semantics mirror
// infra/bvh.cpp:63-178 (binned SAH, vertex-grown bounds, centroid*0.3333,
// no-gain stop) and accel/bvh_builder.py's extensions (median fallback under
// force_split_cap, leaf_target).
//
// The trees depend on the compiler flags: the SAH costs are float32, and
// fused multiply-adds round differently from a product and a sum.
// accel/native.py compiles this file with exactly the flags of the JAX
// package's native/Makefile (-O3 -march=native -fPIC -std=c++17 -Wall).
//
// Exposed as a plain C ABI for ctypes; all buffers are caller-allocated
// numpy arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float half_area(const V3 &lo, const V3 &hi) {
  float ex = std::max(hi.x - lo.x, 0.0f);
  float ey = std::max(hi.y - lo.y, 0.0f);
  float ez = std::max(hi.z - lo.z, 0.0f);
  return ex * ey + ey * ez + ez * ex;
}
static inline float getc(const V3 &v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

struct BuildCtx {
  const float *tri_v;  // N*9
  int n;
  std::vector<V3> cent, tmin, tmax;
  float *node_min;
  float *node_max;
  int32_t *left_first, *tri_count, *left, *right, *axis, *tri_indices;
  int nodes_used = 1;
  int max_depth = 0;
  bool sah;
  int bins, force_split_cap, leaf_target;
};

static void update_bounds(BuildCtx &c, int node) {
  V3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
  int first = c.left_first[node], count = c.tri_count[node];
  for (int i = 0; i < count; i++) {
    int t = c.tri_indices[first + i];
    lo = vmin(lo, c.tmin[t]);
    hi = vmax(hi, c.tmax[t]);
  }
  c.node_min[node * 3 + 0] = lo.x;
  c.node_min[node * 3 + 1] = lo.y;
  c.node_min[node * 3 + 2] = lo.z;
  c.node_max[node * 3 + 0] = hi.x;
  c.node_max[node * 3 + 1] = hi.y;
  c.node_max[node * 3 + 2] = hi.z;
}

struct Bin {
  V3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
  int count = 0;
};

static void subdivide(BuildCtx &c, int node, int depth) {
  update_bounds(c, node);
  if (depth > c.max_depth) c.max_depth = depth;
  int first = c.left_first[node], count = c.tri_count[node];
  int leaf_stop = c.leaf_target > 0 ? c.leaf_target : 2;
  if (count <= leaf_stop) return;

  int best_axis = -1;
  float split_pos = 0.0f;
  bool do_median = false;

  if (c.sah) {
    float best_cost = 1e30f;
    for (int a = 0; a < 3; a++) {
      float cmin = 1e30f, cmax = -1e30f;
      for (int i = 0; i < count; i++) {
        float v = getc(c.cent[c.tri_indices[first + i]], a);
        cmin = std::min(cmin, v);
        cmax = std::max(cmax, v);
      }
      if (cmin == cmax) continue;
      std::vector<Bin> bins((size_t)c.bins);
      float scale = c.bins / (cmax - cmin);
      for (int i = 0; i < count; i++) {
        int t = c.tri_indices[first + i];
        int b = std::min(c.bins - 1, (int)((getc(c.cent[t], a) - cmin) * scale));
        bins[b].count++;
        bins[b].lo = vmin(bins[b].lo, c.tmin[t]);
        bins[b].hi = vmax(bins[b].hi, c.tmax[t]);
      }
      // prefix/suffix sweeps over the planes (reference FindBestSplitPlane)
      std::vector<float> larea(c.bins), rarea(c.bins);
      std::vector<int> lcount(c.bins), rcount(c.bins);
      {
        V3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
        int s = 0;
        for (int i = 0; i < c.bins; i++) {
          s += bins[i].count;
          lcount[i] = s;
          if (bins[i].count) {
            lo = vmin(lo, bins[i].lo);
            hi = vmax(hi, bins[i].hi);
          }
          larea[i] = s ? half_area(lo, hi) : 0.0f;
        }
      }
      {
        V3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
        int s = 0;
        for (int i = c.bins - 1; i >= 0; i--) {
          s += bins[i].count;
          rcount[i] = s;
          if (bins[i].count) {
            lo = vmin(lo, bins[i].lo);
            hi = vmax(hi, bins[i].hi);
          }
          rarea[i] = s ? half_area(lo, hi) : 0.0f;
        }
      }
      for (int i = 0; i < c.bins - 1; i++) {
        float cost = lcount[i] * larea[i] + rcount[i + 1] * rarea[i + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          split_pos = cmin + (cmax - cmin) / c.bins * (i + 1);
        }
      }
    }
    V3 nlo{c.node_min[node * 3], c.node_min[node * 3 + 1], c.node_min[node * 3 + 2]};
    V3 nhi{c.node_max[node * 3], c.node_max[node * 3 + 1], c.node_max[node * 3 + 2]};
    float no_split = count * half_area(nlo, nhi);
    if (best_axis < 0 || best_cost >= no_split) {
      if (c.force_split_cap > 0 && count > c.force_split_cap) {
        do_median = true;
      } else {
        return;  // leaf (reference SAH no-gain stop)
      }
    }
  } else {
    V3 nlo{c.node_min[node * 3], c.node_min[node * 3 + 1], c.node_min[node * 3 + 2]};
    V3 nhi{c.node_max[node * 3], c.node_max[node * 3 + 1], c.node_max[node * 3 + 2]};
    V3 ext{nhi.x - nlo.x, nhi.y - nlo.y, nhi.z - nlo.z};
    best_axis = 0;
    if (ext.y > ext.x) best_axis = 1;
    if (getc(ext, 2) > getc(ext, best_axis)) best_axis = 2;
    split_pos = getc(nlo, best_axis) + getc(ext, best_axis) * 0.5f;
  }

  int left_count;
  int32_t *ids = c.tri_indices + first;
  if (do_median) {
    V3 nlo{c.node_min[node * 3], c.node_min[node * 3 + 1], c.node_min[node * 3 + 2]};
    V3 nhi{c.node_max[node * 3], c.node_max[node * 3 + 1], c.node_max[node * 3 + 2]};
    V3 ext{nhi.x - nlo.x, nhi.y - nlo.y, nhi.z - nlo.z};
    int a = 0;
    if (ext.y > ext.x) a = 1;
    if (getc(ext, 2) > getc(ext, a)) a = 2;
    std::stable_sort(ids, ids + count, [&](int32_t p, int32_t q) {
      return getc(c.cent[p], a) < getc(c.cent[q], a);
    });
    left_count = count / 2;
  } else {
    // in-place partition by centroid < split (stable variant)
    std::stable_partition(ids, ids + count, [&](int32_t p) {
      return getc(c.cent[p], best_axis) < split_pos;
    });
    left_count = 0;
    for (int i = 0; i < count; i++)
      if (getc(c.cent[ids[i]], best_axis) < split_pos) left_count++;
    if (left_count == 0 || left_count == count) {
      if (c.force_split_cap > 0 && count > c.force_split_cap) {
        std::stable_sort(ids, ids + count, [&](int32_t p, int32_t q) {
          return getc(c.cent[p], best_axis) < getc(c.cent[q], best_axis);
        });
        left_count = count / 2;
      } else {
        return;  // leaf (degenerate partition)
      }
    }
  }

  int li = c.nodes_used++;
  int ri = c.nodes_used++;
  c.left_first[li] = first;
  c.tri_count[li] = left_count;
  c.left_first[ri] = first + left_count;
  c.tri_count[ri] = count - left_count;
  c.left[node] = li;
  c.right[node] = ri;
  c.axis[node] = best_axis < 0 ? 0 : best_axis;
  c.left_first[node] = li;
  c.tri_count[node] = 0;
  subdivide(c, li, depth + 1);
  subdivide(c, ri, depth + 1);
}

// --------------------------------------------------------------------------
// SBVH: binned-SAH build with SPATIAL SPLITS (Stich et al. 2009, box-chop
// variant).  Straddling triangle REFERENCES are duplicated into both
// children with their boxes clipped to the split plane, shrinking the
// overlap between sibling boxes.  References (not triangles) are the build
// unit, so leaf lists may repeat a triangle id: a walk's running-min test is
// idempotent, and accel/pack.py slots a repeated id twice.

struct Ref {
  int32_t tri;
  V3 lo, hi;
};

struct SCtx {
  std::vector<float> node_min, node_max;
  std::vector<int32_t> left_first, tri_count, left, right, axis, ids;
  int bins = 8, leaf_target = 8;
  float alpha = 1e-5f;  // spatial splits only where overlap/root_area > alpha
  float root_area = 1.0f;
  size_t max_refs = 0;
  int max_depth = 0;
};

static int s_new_node(SCtx &c, const V3 &lo, const V3 &hi) {
  c.node_min.insert(c.node_min.end(), {lo.x, lo.y, lo.z});
  c.node_max.insert(c.node_max.end(), {hi.x, hi.y, hi.z});
  c.left_first.push_back(0);
  c.tri_count.push_back(0);
  c.left.push_back(-1);
  c.right.push_back(-1);
  c.axis.push_back(0);
  return (int)c.left.size() - 1;
}

static void ref_bounds(const std::vector<Ref> &refs, V3 &lo, V3 &hi) {
  lo = {1e30f, 1e30f, 1e30f};
  hi = {-1e30f, -1e30f, -1e30f};
  for (const Ref &r : refs) {
    lo = vmin(lo, r.lo);
    hi = vmax(hi, r.hi);
  }
}

static int s_build(SCtx &c, std::vector<Ref> refs, int depth) {
  V3 nlo, nhi;
  ref_bounds(refs, nlo, nhi);
  int node = s_new_node(c, nlo, nhi);
  if (depth > c.max_depth) c.max_depth = depth;
  int count = (int)refs.size();

  auto emit_leaf = [&]() {
    c.left_first[node] = (int)c.ids.size();
    c.tri_count[node] = count;
    for (const Ref &r : refs) c.ids.push_back(r.tri);
    return node;
  };
  if (count <= c.leaf_target || depth >= 60) return emit_leaf();

  // ---- best OBJECT split (binned SAH over reference-box centroids) ----
  float best_obj = 1e30f;
  int obj_axis = -1;
  float obj_pos = 0.0f;
  for (int a = 0; a < 3; a++) {
    float cmin = 1e30f, cmax = -1e30f;
    for (const Ref &r : refs) {
      float v = (getc(r.lo, a) + getc(r.hi, a)) * 0.5f;
      cmin = std::min(cmin, v);
      cmax = std::max(cmax, v);
    }
    if (cmin == cmax) continue;
    std::vector<Bin> bins((size_t)c.bins);
    float scale = c.bins / (cmax - cmin);
    for (const Ref &r : refs) {
      float v = (getc(r.lo, a) + getc(r.hi, a)) * 0.5f;
      int b = std::min(c.bins - 1, (int)((v - cmin) * scale));
      bins[b].count++;
      bins[b].lo = vmin(bins[b].lo, r.lo);
      bins[b].hi = vmax(bins[b].hi, r.hi);
    }
    V3 llo{1e30f, 1e30f, 1e30f}, lhi{-1e30f, -1e30f, -1e30f};
    std::vector<float> larea(c.bins);
    std::vector<int> lcount(c.bins);
    int s = 0;
    for (int i = 0; i < c.bins; i++) {
      s += bins[i].count;
      lcount[i] = s;
      if (bins[i].count) {
        llo = vmin(llo, bins[i].lo);
        lhi = vmax(lhi, bins[i].hi);
      }
      larea[i] = s ? half_area(llo, lhi) : 0.0f;
    }
    V3 rlo{1e30f, 1e30f, 1e30f}, rhi{-1e30f, -1e30f, -1e30f};
    int rs = 0;
    for (int i = c.bins - 1; i >= 1; i--) {
      rs += bins[i].count;
      if (bins[i].count) {
        rlo = vmin(rlo, bins[i].lo);
        rhi = vmax(rhi, bins[i].hi);
      }
      float cost = lcount[i - 1] * larea[i - 1] + rs * half_area(rlo, rhi);
      if (rs && lcount[i - 1] && cost < best_obj) {
        best_obj = cost;
        obj_axis = a;
        obj_pos = cmin + (cmax - cmin) / c.bins * i;
      }
    }
  }

  // ---- overlap test: consider SPATIAL split only where siblings overlap
  float best_spat = 1e30f;
  int sp_axis = -1;
  float sp_pos = 0.0f;
  if (obj_axis >= 0) {
    // sibling overlap of the chosen object split
    V3 llo{1e30f, 1e30f, 1e30f}, lhi{-1e30f, -1e30f, -1e30f};
    V3 rlo{1e30f, 1e30f, 1e30f}, rhi{-1e30f, -1e30f, -1e30f};
    for (const Ref &r : refs) {
      float v = (getc(r.lo, obj_axis) + getc(r.hi, obj_axis)) * 0.5f;
      if (v < obj_pos) {
        llo = vmin(llo, r.lo);
        lhi = vmax(lhi, r.hi);
      } else {
        rlo = vmin(rlo, r.lo);
        rhi = vmax(rhi, r.hi);
      }
    }
    V3 olo = vmax(llo, rlo), ohi = vmin(lhi, rhi);
    float overlap = (ohi.x > olo.x && ohi.y > olo.y && ohi.z > olo.z)
                        ? half_area(olo, ohi)
                        : 0.0f;
    if (overlap / c.root_area > c.alpha && c.ids.size() + 2 * refs.size() < c.max_refs) {
      // chop-bin count: the JAX package measured 4x finer bins slower end
      // to end on its TPU (extra references cost more leaf rows than the
      // tighter boxes save), so the spatial sweep uses the object sweep's
      // bin count
      int sbins = c.bins;
      for (int a = 0; a < 3; a++) {
        float lo_a = getc(nlo, a), hi_a = getc(nhi, a);
        if (hi_a <= lo_a) continue;
        float scale = sbins / (hi_a - lo_a);
        std::vector<Bin> bins((size_t)sbins);  // clipped bounds per bin
        std::vector<int> entry(sbins, 0), exit_(sbins, 0);
        for (const Ref &r : refs) {
          int b0 = std::min(c.bins - 1, std::max(0, (int)((getc(r.lo, a) - lo_a) * scale)));
          int b1 = std::min(c.bins - 1, std::max(0, (int)((getc(r.hi, a) - lo_a) * scale)));
          entry[b0]++;
          exit_[b1]++;
          for (int b = b0; b <= b1; b++) {
            // box-chop: clip the reference box to the bin slab on axis a
            V3 clo = r.lo, chi = r.hi;
            float slab_lo = lo_a + b / scale, slab_hi = lo_a + (b + 1) / scale;
            if (a == 0) { clo.x = std::max(clo.x, slab_lo); chi.x = std::min(chi.x, slab_hi); }
            if (a == 1) { clo.y = std::max(clo.y, slab_lo); chi.y = std::min(chi.y, slab_hi); }
            if (a == 2) { clo.z = std::max(clo.z, slab_lo); chi.z = std::min(chi.z, slab_hi); }
            bins[b].lo = vmin(bins[b].lo, clo);
            bins[b].hi = vmax(bins[b].hi, chi);
          }
        }
        V3 llo2{1e30f, 1e30f, 1e30f}, lhi2{-1e30f, -1e30f, -1e30f};
        std::vector<float> larea(c.bins);
        std::vector<int> lcount(c.bins);
        int s = 0;
        for (int i = 0; i < c.bins; i++) {
          s += entry[i];
          lcount[i] = s;
          llo2 = vmin(llo2, bins[i].lo);
          lhi2 = vmax(lhi2, bins[i].hi);
          larea[i] = s ? half_area(llo2, lhi2) : 0.0f;
        }
        V3 rlo2{1e30f, 1e30f, 1e30f}, rhi2{-1e30f, -1e30f, -1e30f};
        int rs = 0;
        for (int i = c.bins - 1; i >= 1; i--) {
          rs += exit_[i];
          rlo2 = vmin(rlo2, bins[i].lo);
          rhi2 = vmax(rhi2, bins[i].hi);
          float cost = lcount[i - 1] * larea[i - 1] + rs * half_area(rlo2, rhi2);
          if (rs && lcount[i - 1] && cost < best_spat) {
            best_spat = cost;
            sp_axis = a;
            sp_pos = lo_a + (hi_a - lo_a) / c.bins * i;
          }
        }
      }
    }
  }

  float no_split = count * half_area(nlo, nhi);
  bool use_spatial = sp_axis >= 0 && best_spat < best_obj;
  float best = use_spatial ? best_spat : best_obj;
  if (obj_axis < 0 || best >= no_split) {
    if (count <= 4 * std::max(c.leaf_target, 1)) return emit_leaf();
    // oversize no-gain node: median object split (mirrors the binary
    // builder's force_split_cap fallback)
    int a = 0;
    V3 ext{nhi.x - nlo.x, nhi.y - nlo.y, nhi.z - nlo.z};
    if (ext.y > ext.x) a = 1;
    if (getc(ext, 2) > getc(ext, a)) a = 2;
    std::sort(refs.begin(), refs.end(), [&](const Ref &p, const Ref &q) {
      return getc(p.lo, a) + getc(p.hi, a) < getc(q.lo, a) + getc(q.hi, a);
    });
    std::vector<Ref> lrefs(refs.begin(), refs.begin() + count / 2);
    std::vector<Ref> rrefs(refs.begin() + count / 2, refs.end());
    refs.clear();
    refs.shrink_to_fit();
    int li = s_build(c, std::move(lrefs), depth + 1);
    int ri = s_build(c, std::move(rrefs), depth + 1);
    c.left[node] = li;
    c.right[node] = ri;
    c.axis[node] = a;
    c.left_first[node] = li;
    return node;
  }

  std::vector<Ref> lrefs, rrefs;
  int split_axis;
  if (use_spatial) {
    split_axis = sp_axis;
    for (const Ref &r : refs) {
      if (getc(r.hi, sp_axis) <= sp_pos) {
        lrefs.push_back(r);
      } else if (getc(r.lo, sp_axis) >= sp_pos) {
        rrefs.push_back(r);
      } else {
        Ref a = r, b = r;  // duplicate, boxes clipped at the plane
        if (sp_axis == 0) { a.hi.x = sp_pos; b.lo.x = sp_pos; }
        if (sp_axis == 1) { a.hi.y = sp_pos; b.lo.y = sp_pos; }
        if (sp_axis == 2) { a.hi.z = sp_pos; b.lo.z = sp_pos; }
        lrefs.push_back(a);
        rrefs.push_back(b);
      }
    }
  } else {
    split_axis = obj_axis;
    for (const Ref &r : refs) {
      float v = (getc(r.lo, obj_axis) + getc(r.hi, obj_axis)) * 0.5f;
      (v < obj_pos ? lrefs : rrefs).push_back(r);
    }
  }
  if (lrefs.empty() || rrefs.empty()) return emit_leaf();
  refs.clear();
  refs.shrink_to_fit();
  int li = s_build(c, std::move(lrefs), depth + 1);
  int ri = s_build(c, std::move(rrefs), depth + 1);
  c.left[node] = li;
  c.right[node] = ri;
  c.axis[node] = split_axis;
  c.left_first[node] = li;
  return node;
}

}  // namespace

extern "C" {

// SBVH build.  Caller provides output capacities: `node_cap` nodes and
// `ref_cap` leaf reference slots.  Returns nodes_used, or -1 when a cap
// would be exceeded (caller retries with the plain SAH build).
// out_meta = {max_depth, total_refs}.
int crt_build_sbvh(const float *tri_v, int n_tris, int bins, int leaf_target,
                   float alpha, int node_cap, int ref_cap, float *node_min,
                   float *node_max, int32_t *left_first, int32_t *tri_count,
                   int32_t *left, int32_t *right, int32_t *axis,
                   int32_t *tri_indices, int32_t *out_meta) {
  SCtx c;
  c.bins = bins;
  c.leaf_target = leaf_target > 0 ? leaf_target : 8;
  c.alpha = alpha;
  c.max_refs = (size_t)ref_cap;
  std::vector<Ref> refs((size_t)n_tris);
  V3 rlo{1e30f, 1e30f, 1e30f}, rhi{-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n_tris; i++) {
    V3 a{tri_v[i * 9 + 0], tri_v[i * 9 + 1], tri_v[i * 9 + 2]};
    V3 b{tri_v[i * 9 + 3], tri_v[i * 9 + 4], tri_v[i * 9 + 5]};
    V3 d{tri_v[i * 9 + 6], tri_v[i * 9 + 7], tri_v[i * 9 + 8]};
    refs[i] = {i, vmin(vmin(a, b), d), vmax(vmax(a, b), d)};
    rlo = vmin(rlo, refs[i].lo);
    rhi = vmax(rhi, refs[i].hi);
  }
  c.root_area = std::max(half_area(rlo, rhi), 1e-20f);
  c.node_min.reserve((size_t)node_cap * 3);
  c.ids.reserve((size_t)ref_cap);
  s_build(c, std::move(refs), 0);
  if ((int)c.left.size() > node_cap || (int)c.ids.size() > ref_cap) return -1;
  int used = (int)c.left.size();
  std::memcpy(node_min, c.node_min.data(), sizeof(float) * 3 * used);
  std::memcpy(node_max, c.node_max.data(), sizeof(float) * 3 * used);
  std::memcpy(left_first, c.left_first.data(), sizeof(int32_t) * used);
  std::memcpy(tri_count, c.tri_count.data(), sizeof(int32_t) * used);
  std::memcpy(left, c.left.data(), sizeof(int32_t) * used);
  std::memcpy(right, c.right.data(), sizeof(int32_t) * used);
  std::memcpy(axis, c.axis.data(), sizeof(int32_t) * used);
  std::memcpy(tri_indices, c.ids.data(), sizeof(int32_t) * c.ids.size());
  out_meta[0] = c.max_depth;
  out_meta[1] = (int)c.ids.size();
  return used;
}

// Returns nodes_used. Buffers sized for 2N-1 nodes.
int crt_build_bvh(const float *tri_v, int n_tris, int sah, int bins,
                  int force_split_cap, int leaf_target, float *node_min,
                  float *node_max, int32_t *left_first, int32_t *tri_count,
                  int32_t *left, int32_t *right, int32_t *axis,
                  int32_t *tri_indices, int32_t *out_max_depth) {
  BuildCtx c;
  c.tri_v = tri_v;
  c.n = n_tris;
  c.node_min = node_min;
  c.node_max = node_max;
  c.left_first = left_first;
  c.tri_count = tri_count;
  c.left = left;
  c.right = right;
  c.axis = axis;
  c.tri_indices = tri_indices;
  c.sah = sah != 0;
  c.bins = bins;
  c.force_split_cap = force_split_cap;
  c.leaf_target = leaf_target;

  c.cent.resize(n_tris);
  c.tmin.resize(n_tris);
  c.tmax.resize(n_tris);
  for (int i = 0; i < n_tris; i++) {
    V3 a{tri_v[i * 9 + 0], tri_v[i * 9 + 1], tri_v[i * 9 + 2]};
    V3 b{tri_v[i * 9 + 3], tri_v[i * 9 + 4], tri_v[i * 9 + 5]};
    V3 d{tri_v[i * 9 + 6], tri_v[i * 9 + 7], tri_v[i * 9 + 8]};
    // centroid * 0.3333 exactly as the reference (model.cpp:78)
    c.cent[i] = {(a.x + b.x + d.x) * 0.3333f, (a.y + b.y + d.y) * 0.3333f,
                 (a.z + b.z + d.z) * 0.3333f};
    c.tmin[i] = vmin(vmin(a, b), d);
    c.tmax[i] = vmax(vmax(a, b), d);
    tri_indices[i] = i;
  }
  int cap = n_tris * 2 - 1;
  if (cap < 1) cap = 1;
  std::memset(left, 0xFF, sizeof(int32_t) * cap);
  std::memset(right, 0xFF, sizeof(int32_t) * cap);
  std::memset(axis, 0, sizeof(int32_t) * cap);
  c.left_first[0] = 0;
  c.tri_count[0] = n_tris;
  subdivide(c, 0, 0);
  *out_max_depth = c.max_depth;
  return c.nodes_used;
}

// Per-octant threaded hit/miss links (accel/bvh_builder.thread_links).
void crt_thread_links(const int32_t *left, const int32_t *right,
                      const int32_t *tri_count, const int32_t *axis, int m,
                      const int32_t *roots, int n_roots, int32_t *hit,
                      int32_t *miss) {
  std::vector<std::pair<int32_t, int32_t>> stack;
  for (int o = 0; o < 8; o++) {
    int neg[3] = {(o >> 0) & 1, (o >> 1) & 1, (o >> 2) & 1};
    int32_t *ho = hit + (size_t)o * m;
    int32_t *mo = miss + (size_t)o * m;
    stack.clear();
    for (int i = n_roots - 1; i >= 0; i--) {
      int32_t nxt = (i + 1 < n_roots) ? roots[i + 1] : -1;
      stack.push_back({roots[i], nxt});
    }
    while (!stack.empty()) {
      auto [node, ex] = stack.back();
      stack.pop_back();
      mo[node] = ex;
      if (tri_count[node] > 0) {
        ho[node] = ex;
        continue;
      }
      int a = axis[node];
      int32_t nearc = neg[a] ? right[node] : left[node];
      int32_t farc = neg[a] ? left[node] : right[node];
      ho[node] = nearc;
      stack.push_back({nearc, farc});
      stack.push_back({farc, ex});
    }
  }
}

}  // extern "C"
