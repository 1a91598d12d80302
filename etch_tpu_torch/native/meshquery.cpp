// Native mesh-query backend: BVH-accelerated closest-point and ray-cast
// queries over triangle meshes.
//
// Fills the role that embree (via trimesh.ray) and trimesh.proximity play in
// the reference's CPU pipeline (scripts/generate_infopoints.py:117-174 ray
// tests; src/data_utils/GT_dataloader.py:110 closest_point): the per-sample
// GT generation is the CPU hot loop, so these queries are native C++ with a
// ctypes binding (see native/__init__.py) and a numpy fallback
// (data/proximity.py).  A copy of etch_tpu/native/meshquery.cpp.
//
// Build: native/__init__.py runs g++ -O3 -shared -fPIC -std=c++17 at first
// use, into build/etch_tpu_torch/native/<hash>/ at the repository root.
//
// Design: median-split AABB BVH over triangles; branchless slab test for
// rays; Ericson closest-point-on-triangle; iterative traversal with an
// explicit stack (no recursion, no allocations per query); OpenMP-free
// (callers parallelize across meshes with processes, matching the
// reference's ProcessPoolExecutor layout).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

static inline Vec3 sub(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
static inline Vec3 add(const Vec3& a, const Vec3& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
static inline Vec3 mul(const Vec3& a, double s) {
  return {a.x * s, a.y * s, a.z * s};
}
static inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct AABB {
  Vec3 lo, hi;
  void reset() {
    constexpr double inf = std::numeric_limits<double>::infinity();
    lo = {inf, inf, inf};
    hi = {-inf, -inf, -inf};
  }
  void grow(const Vec3& p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB& b) {
    grow(b.lo);
    grow(b.hi);
  }
  double dist2(const Vec3& p) const {
    double dx = std::max({lo.x - p.x, 0.0, p.x - hi.x});
    double dy = std::max({lo.y - p.y, 0.0, p.y - hi.y});
    double dz = std::max({lo.z - p.z, 0.0, p.z - hi.z});
    return dx * dx + dy * dy + dz * dz;
  }
  // slab test; returns entry t or inf
  double ray_hit(const Vec3& o, const Vec3& inv_d, double tmax) const {
    double t1 = (lo.x - o.x) * inv_d.x, t2 = (hi.x - o.x) * inv_d.x;
    double tmin_ = std::min(t1, t2), tmax_ = std::max(t1, t2);
    t1 = (lo.y - o.y) * inv_d.y; t2 = (hi.y - o.y) * inv_d.y;
    tmin_ = std::max(tmin_, std::min(t1, t2));
    tmax_ = std::min(tmax_, std::max(t1, t2));
    t1 = (lo.z - o.z) * inv_d.z; t2 = (hi.z - o.z) * inv_d.z;
    tmin_ = std::max(tmin_, std::min(t1, t2));
    tmax_ = std::min(tmax_, std::max(t1, t2));
    if (tmax_ < std::max(tmin_, 0.0) || tmin_ > tmax) {
      return std::numeric_limits<double>::infinity();
    }
    return std::max(tmin_, 0.0);
  }
};

struct Node {
  AABB box;
  int32_t left;   // index of left child, or -1 for leaf
  int32_t right;  // right child
  int32_t start;  // leaf: first tri index in order[]
  int32_t count;  // leaf: number of tris
};

struct BVH {
  std::vector<Vec3> va, vb, vc;     // triangle vertices (per tri)
  std::vector<int32_t> order;       // tri permutation
  std::vector<Node> nodes;

  void build(const double* verts, const int32_t* faces, int64_t n_faces) {
    va.resize(n_faces); vb.resize(n_faces); vc.resize(n_faces);
    std::vector<Vec3> centroid(n_faces);
    std::vector<AABB> tri_box(n_faces);
    for (int64_t i = 0; i < n_faces; ++i) {
      const int32_t* f = faces + 3 * i;
      va[i] = {verts[3 * f[0]], verts[3 * f[0] + 1], verts[3 * f[0] + 2]};
      vb[i] = {verts[3 * f[1]], verts[3 * f[1] + 1], verts[3 * f[1] + 2]};
      vc[i] = {verts[3 * f[2]], verts[3 * f[2] + 1], verts[3 * f[2] + 2]};
      tri_box[i].reset();
      tri_box[i].grow(va[i]); tri_box[i].grow(vb[i]); tri_box[i].grow(vc[i]);
      centroid[i] = mul(add(add(va[i], vb[i]), vc[i]), 1.0 / 3.0);
    }
    order.resize(n_faces);
    for (int64_t i = 0; i < n_faces; ++i) order[i] = (int32_t)i;
    nodes.clear();
    nodes.reserve(2 * n_faces);
    build_node(0, (int32_t)n_faces, centroid, tri_box);
  }

  int32_t build_node(int32_t start, int32_t count,
                     const std::vector<Vec3>& centroid,
                     const std::vector<AABB>& tri_box) {
    Node node;
    node.box.reset();
    for (int32_t i = start; i < start + count; ++i) node.box.grow(tri_box[order[i]]);
    int32_t idx = (int32_t)nodes.size();
    nodes.push_back(node);
    if (count <= 4) {
      nodes[idx].left = -1;
      nodes[idx].right = -1;
      nodes[idx].start = start;
      nodes[idx].count = count;
      return idx;
    }
    // split along the widest centroid axis at the median
    AABB cb; cb.reset();
    for (int32_t i = start; i < start + count; ++i) cb.grow(centroid[order[i]]);
    Vec3 ext = sub(cb.hi, cb.lo);
    int axis = 0;
    if (ext.y > ext.x && ext.y >= ext.z) axis = 1;
    else if (ext.z > ext.x && ext.z >= ext.y) axis = 2;
    int32_t mid = start + count / 2;
    auto key = [&](int32_t t) {
      const Vec3& c = centroid[t];
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    std::nth_element(order.begin() + start, order.begin() + mid,
                     order.begin() + start + count,
                     [&](int32_t a, int32_t b) { return key(a) < key(b); });
    int32_t l = build_node(start, mid - start, centroid, tri_box);
    int32_t r = build_node(mid, start + count - mid, centroid, tri_box);
    nodes[idx].left = l;
    nodes[idx].right = r;
    nodes[idx].start = -1;
    nodes[idx].count = 0;
    return idx;
  }
};

// Ericson: closest point on triangle
static Vec3 closest_on_tri(const Vec3& p, const Vec3& a, const Vec3& b,
                           const Vec3& c) {
  Vec3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return a;
  Vec3 bp = sub(p, b);
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return b;
  double vc_ = d1 * d4 - d3 * d2;
  if (vc_ <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    return add(a, mul(ab, v));
  }
  Vec3 cp = sub(p, c);
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return c;
  double vb_ = d5 * d2 - d1 * d6;
  if (vb_ <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    return add(a, mul(ac, w));
  }
  double va_ = d3 * d6 - d5 * d4;
  if (va_ <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    return add(b, mul(sub(c, b), w));
  }
  double denom = 1.0 / (va_ + vb_ + vc_);
  double v = vb_ * denom, w = vc_ * denom;
  return add(a, add(mul(ab, v), mul(ac, w)));
}

// Moller-Trumbore
static bool ray_tri(const Vec3& o, const Vec3& d, const Vec3& a, const Vec3& b,
                    const Vec3& c, double& t_out) {
  constexpr double eps = 1e-12;
  Vec3 e1 = sub(b, a), e2 = sub(c, a);
  Vec3 pv = cross(d, e2);
  double det = dot(e1, pv);
  if (std::fabs(det) < eps) return false;
  double inv = 1.0 / det;
  Vec3 tv = sub(o, a);
  double u = dot(tv, pv) * inv;
  if (u < -1e-9 || u > 1 + 1e-9) return false;
  Vec3 qv = cross(tv, e1);
  double v = dot(d, qv) * inv;
  if (v < -1e-9 || u + v > 1 + 1e-9) return false;
  double t = dot(e2, qv) * inv;
  if (t <= 1e-9) return false;
  t_out = t;
  return true;
}

}  // namespace

extern "C" {

void* mq_build(const double* verts, int64_t n_verts, const int32_t* faces,
               int64_t n_faces) {
  (void)n_verts;
  BVH* bvh = new BVH();
  bvh->build(verts, faces, n_faces);
  return bvh;
}

void mq_free(void* handle) { delete static_cast<BVH*>(handle); }

// closest point queries: out_points (Q,3), out_dists (Q), out_faces (Q)
void mq_closest_point(void* handle, const double* queries, int64_t n_queries,
                      double* out_points, double* out_dists,
                      int32_t* out_faces) {
  const BVH& bvh = *static_cast<BVH*>(handle);
  std::vector<int32_t> stack;
  stack.reserve(128);
  for (int64_t q = 0; q < n_queries; ++q) {
    Vec3 p = {queries[3 * q], queries[3 * q + 1], queries[3 * q + 2]};
    double best2 = std::numeric_limits<double>::infinity();
    Vec3 best_pt = p;
    int32_t best_face = -1;
    stack.clear();
    stack.push_back(0);
    while (!stack.empty()) {
      int32_t ni = stack.back();
      stack.pop_back();
      const Node& node = bvh.nodes[ni];
      if (node.box.dist2(p) >= best2) continue;
      if (node.left < 0) {
        for (int32_t i = node.start; i < node.start + node.count; ++i) {
          int32_t t = bvh.order[i];
          Vec3 cp = closest_on_tri(p, bvh.va[t], bvh.vb[t], bvh.vc[t]);
          Vec3 dv = sub(cp, p);
          double d2 = dot(dv, dv);
          if (d2 < best2) {
            best2 = d2;
            best_pt = cp;
            best_face = t;
          }
        }
      } else {
        // visit nearer child first
        double dl = bvh.nodes[node.left].box.dist2(p);
        double dr = bvh.nodes[node.right].box.dist2(p);
        if (dl < dr) {
          stack.push_back(node.right);
          stack.push_back(node.left);
        } else {
          stack.push_back(node.left);
          stack.push_back(node.right);
        }
      }
    }
    out_points[3 * q] = best_pt.x;
    out_points[3 * q + 1] = best_pt.y;
    out_points[3 * q + 2] = best_pt.z;
    out_dists[q] = std::sqrt(best2);
    out_faces[q] = best_face;
  }
}

// first-hit ray casts: out_t (Q) = inf on miss, out_faces (Q) = -1 on miss
void mq_raycast(void* handle, const double* origins, const double* dirs,
                int64_t n_queries, double max_dist, double* out_t,
                int32_t* out_faces) {
  const BVH& bvh = *static_cast<BVH*>(handle);
  std::vector<int32_t> stack;
  stack.reserve(128);
  for (int64_t q = 0; q < n_queries; ++q) {
    Vec3 o = {origins[3 * q], origins[3 * q + 1], origins[3 * q + 2]};
    Vec3 d = {dirs[3 * q], dirs[3 * q + 1], dirs[3 * q + 2]};
    double n = std::sqrt(dot(d, d));
    if (n > 0) d = mul(d, 1.0 / n);
    Vec3 inv = {1.0 / (d.x == 0 ? 1e-300 : d.x),
                1.0 / (d.y == 0 ? 1e-300 : d.y),
                1.0 / (d.z == 0 ? 1e-300 : d.z)};
    double best = max_dist;
    int32_t best_face = -1;
    stack.clear();
    stack.push_back(0);
    while (!stack.empty()) {
      int32_t ni = stack.back();
      stack.pop_back();
      const Node& node = bvh.nodes[ni];
      if (node.box.ray_hit(o, inv, best) ==
          std::numeric_limits<double>::infinity()) {
        continue;
      }
      if (node.left < 0) {
        for (int32_t i = node.start; i < node.start + node.count; ++i) {
          int32_t t = bvh.order[i];
          double th;
          if (ray_tri(o, d, bvh.va[t], bvh.vb[t], bvh.vc[t], th) && th < best) {
            best = th;
            best_face = t;
          }
        }
      } else {
        stack.push_back(node.left);
        stack.push_back(node.right);
      }
    }
    out_t[q] = best_face >= 0 ? best
                              : std::numeric_limits<double>::infinity();
    out_faces[q] = best_face;
  }
}

}  // extern "C"
