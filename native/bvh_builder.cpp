// Native binned-SAH BVH builder for yulio_raytracer.
//
// Replaces the role of Embree's rtcCommit BVH build (the reference's only
// native acceleration-structure component) for large scenes where the
// numpy reference builder (geometry/bvh.py) is too slow.  Produces the
// exact same flattened skip-pointer layout: DFS order, interior node i's
// left child at i+1, skip[i] = end of subtree; leaf = (start, count) into
// the permuted triangle order.
//
// C ABI, consumed via ctypes (no pybind11 in the build image).
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const AABB *boxes;
  const Vec3 *cents;
  int leaf_size;
  int nbins;

  std::vector<float> lo, hi;
  std::vector<int32_t> start, count, skip;
  std::vector<int64_t> order;

  int emit_leaf(const AABB &b, int64_t *idx, int64_t n) {
    int me = (int)count.size();
    push_node(b);
    start[me] = (int32_t)order.size();
    count[me] = (int32_t)n;
    order.insert(order.end(), idx, idx + n);
    return me;
  }

  void push_node(const AABB &b) {
    lo.insert(lo.end(), {b.lo.x, b.lo.y, b.lo.z});
    hi.insert(hi.end(), {b.hi.x, b.hi.y, b.hi.z});
    start.push_back(0);
    count.push_back(0);
    skip.push_back(0);
  }

  // returns subtree end (== skip of the root of this subtree)
  int build(int64_t *idx, int64_t n) {
    AABB bounds;
    for (int64_t i = 0; i < n; ++i) bounds.grow(boxes[idx[i]]);

    if (n <= leaf_size) {
      int me = emit_leaf(bounds, idx, n);
      skip[me] = me + 1;
      return me + 1;
    }

    // centroid bounds + widest axis
    AABB cb;
    for (int64_t i = 0; i < n; ++i) cb.grow(cents[idx[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    float clo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    float extent = ext[axis];

    int64_t *mid = nullptr;
    if (extent > 1e-30f) {
      // binned SAH sweep
      const int B = nbins;
      std::vector<AABB> bbox(B);
      std::vector<int64_t> cnt(B, 0);
      float scale = B * (1.0f - 1e-6f) / extent;
      auto bin_of = [&](int64_t t) {
        const Vec3 &c = cents[t];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = (int)((v - clo) * scale);
        return std::min(std::max(b, 0), B - 1);
      };
      for (int64_t i = 0; i < n; ++i) {
        int b = bin_of(idx[i]);
        cnt[b]++;
        bbox[b].grow(boxes[idx[i]]);
      }
      // suffix sweep
      std::vector<float> rarea(B);
      std::vector<int64_t> rcnt(B);
      {
        AABB acc;
        int64_t c = 0;
        for (int b = B - 1; b >= 0; --b) {
          acc.grow(bbox[b]);
          c += cnt[b];
          rarea[b] = acc.half_area();
          rcnt[b] = c;
        }
      }
      // prefix sweep + best split
      float best_cost = std::numeric_limits<float>::infinity();
      int best_k = -1;
      {
        AABB acc;
        int64_t c = 0;
        for (int b = 0; b < B - 1; ++b) {
          acc.grow(bbox[b]);
          c += cnt[b];
          if (c == 0 || rcnt[b + 1] == 0) continue;
          float cost = c * acc.half_area() + rcnt[b + 1] * rarea[b + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best_k = b;
          }
        }
      }
      if (best_k >= 0) {
        mid = std::partition(idx, idx + n, [&](int64_t t) {
          return bin_of(t) <= best_k;
        });
        if (mid == idx || mid == idx + n) mid = nullptr;
      }
    }
    if (!mid) {
      // median fallback
      mid = idx + n / 2;
      std::nth_element(idx, mid, idx + n, [&](int64_t a, int64_t b) {
        const Vec3 &ca = cents[a];
        const Vec3 &cb2 = cents[b];
        float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
        float vb = axis == 0 ? cb2.x : (axis == 1 ? cb2.y : cb2.z);
        return va < vb;
      });
    }

    int me = (int)count.size();
    push_node(bounds);
    build(idx, mid - idx);
    int end = build(mid, idx + n - mid);
    skip[me] = end;
    return end;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// SBVH: spatial-split BVH builder (Stich et al., HPG 2009).
//
// Parity target: the reference commits every scene with
// RTC_SCENE_HIGH_QUALITY | RTC_SCENE_ROBUST (scene_flat.h:90-96), which in
// Embree enables SBVH-style spatial splits: they cut node/leaf overlap on
// architectural scenes, so fewer nodes and leaves are visited per ray, at
// the price of duplicated triangle references.
//
// Differences from the object-split builder above:
//  * a triangle REFERENCE (tri id + clipped AABB) is the unit of work;
//    spatial splits duplicate straddling references into both children,
//    so `order` becomes a gather list (length >= T), not a permutation.
//  * both object and spatial candidates sweep ALL THREE axes.
//  * chopped binning clips the actual triangle polygon to bin slabs
//    (Sutherland-Hodgman) for tight per-bin bounds.
//  * duplication draws from a global budget (max_refs); when exhausted,
//    straddlers are assigned whole to one side by box center.
// ---------------------------------------------------------------------------

namespace {

static inline float axval(const Vec3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

static inline bool box_valid(const AABB &b) {
  return b.lo.x <= b.hi.x && b.lo.y <= b.hi.y && b.lo.z <= b.hi.z;
}

static inline AABB box_intersect(const AABB &a, const AABB &b) {
  AABB r;
  r.lo = vmax(a.lo, b.lo);
  r.hi = vmin(a.hi, b.hi);
  return r;
}

struct SRef {
  int64_t tri;
  AABB box;  // clipped bounds
};

// Small polygon buffer for triangle/plane clipping.  A triangle chopped
// by PARALLEL planes stays small: the remainder keeps <= 3 original
// vertices plus <= 2 plane intersections, and a slab piece <= 7 vertices;
// 12 leaves slack for on-plane float degeneracies (a vertex exactly on
// the plane is emitted to both sides).
struct Poly {
  Vec3 p[12];
  int n = 0;
};

// Split `poly` by plane (axis == a, coordinate == s) into the part with
// coord <= s (into `left`) and the part with coord >= s (back into
// `poly`).  Sutherland-Hodgman with both outputs in one pass.
static void poly_split(const Poly &in, int a, float s, Poly &left,
                       Poly &right) {
  left.n = 0;
  right.n = 0;
  if (in.n == 0) return;
  for (int i = 0; i < in.n; ++i) {
    const Vec3 &u = in.p[i];
    const Vec3 &v = in.p[(i + 1) % in.n];
    float du = axval(u, a) - s;
    float dv = axval(v, a) - s;
    if (du <= 0) left.p[left.n++] = u;
    if (du >= 0) right.p[right.n++] = u;
    if ((du < 0 && dv > 0) || (du > 0 && dv < 0)) {
      float t = du / (du - dv);
      Vec3 w{u.x + t * (v.x - u.x), u.y + t * (v.y - u.y),
             u.z + t * (v.z - u.z)};
      left.p[left.n++] = w;
      right.p[right.n++] = w;
    }
  }
}

static AABB poly_box(const Poly &p) {
  AABB b;
  for (int i = 0; i < p.n; ++i) b.grow(p.p[i]);
  return b;
}

struct SBuilder {
  const Vec3 *v0e, *e1e, *e2e;  // triangle vertex data (for clipping)
  int leaf_size;
  int nbins;
  float alpha;          // overlap/root-area threshold to try spatial
  bool enable_spatial;  // try spatial-split candidates at all
  bool align_rows;      // pad each leaf start to a multiple of 8
                        // triangles (invalid padding triangles)
  float c_trav;         // SAH termination: interior-visit cost in packed-
                        // row units (<0: always split down to leaf_size).
                        // With it, a node below the cap stays a leaf when
                        // ceil(n/8) rows is cheaper than splitting —
                        // row-quantized SAH matched to the kernel's
                        // 8-tri-per-row cost model
  int64_t dup_pool;     // remaining duplications allowed (global)
  float root_area;

  std::vector<float> lo, hi;
  std::vector<int32_t> start, count, skip;
  std::vector<int64_t> order;

  Poly tri_poly(int64_t t) const {
    Poly p;
    p.n = 3;
    p.p[0] = v0e[t];
    p.p[1] = {v0e[t].x + e1e[t].x, v0e[t].y + e1e[t].y, v0e[t].z + e1e[t].z};
    p.p[2] = {v0e[t].x + e2e[t].x, v0e[t].y + e2e[t].y, v0e[t].z + e2e[t].z};
    return p;
  }

  void push_node(const AABB &b) {
    lo.insert(lo.end(), {b.lo.x, b.lo.y, b.lo.z});
    hi.insert(hi.end(), {b.hi.x, b.hi.y, b.hi.z});
    start.push_back(0);
    count.push_back(0);
    skip.push_back(0);
  }

  int emit_leaf(const AABB &b, const std::vector<SRef> &refs) {
    int me = (int)count.size();
    push_node(b);
    start[me] = (int32_t)order.size();
    count[me] = (int32_t)refs.size();
    for (const SRef &r : refs) order.push_back(r.tri);
    if (align_rows && !refs.empty()) {
      // tail-pad to the row boundary with this leaf's last triangle
      // (duplicate refs are sound: any hit on them is a true hit), so
      // the NEXT leaf starts row-aligned and no leaf pays boundary rows
      while (order.size() % 8) order.push_back(refs.back().tri);
    }
    skip[me] = me + 1;
    return me + 1;
  }

  struct Cand {
    float cost = std::numeric_limits<float>::infinity();
    int axis = -1;
    int bin = -1;        // split after this bin
    bool spatial = false;
    float plane = 0.f;   // spatial only
    AABB lb, rb;         // geometric child bounds of the candidate
    int64_t nl = 0, nr = 0;  // child reference counts of the candidate
  };

  // Best object split over all 3 axes (binned by reference-box centroid).
  Cand object_split(const std::vector<SRef> &refs, const AABB &cb) const {
    Cand best;
    const int B = nbins;
    const int64_t n = (int64_t)refs.size();
    for (int a = 0; a < 3; ++a) {
      float clo = axval(cb.lo, a);
      float extent = axval(cb.hi, a) - clo;
      if (!(extent > 1e-30f)) continue;
      float scale = B * (1.0f - 1e-6f) / extent;
      std::vector<AABB> bbox(B);
      std::vector<int64_t> cnt(B, 0);
      for (const SRef &r : refs) {
        float c = 0.5f * (axval(r.box.lo, a) + axval(r.box.hi, a));
        int b = (int)((c - clo) * scale);
        b = std::min(std::max(b, 0), B - 1);
        cnt[b]++;
        bbox[b].grow(r.box);
      }
      // suffix sweep
      std::vector<float> rarea(B);
      std::vector<int64_t> rcnt(B);
      std::vector<AABB> racc(B);
      {
        AABB acc;
        int64_t c = 0;
        for (int b = B - 1; b >= 0; --b) {
          acc.grow(bbox[b]);
          c += cnt[b];
          rarea[b] = acc.half_area();
          rcnt[b] = c;
          racc[b] = acc;
        }
      }
      // prefix sweep
      AABB acc;
      int64_t c = 0;
      for (int b = 0; b < B - 1; ++b) {
        acc.grow(bbox[b]);
        c += cnt[b];
        if (c == 0 || rcnt[b + 1] == 0) continue;
        if (c == n || rcnt[b + 1] == n) continue;
        float cost = c * acc.half_area() + rcnt[b + 1] * rarea[b + 1];
        if (cost < best.cost) {
          best.cost = cost;
          best.axis = a;
          best.bin = b;
          best.spatial = false;
          best.lb = acc;
          best.rb = racc[b + 1];
          best.nl = c;
          best.nr = rcnt[b + 1];
        }
      }
    }
    return best;
  }

  // Best spatial split over all 3 axes (chopped binning over the node's
  // geometric bounds; references counted in every bin they span, with
  // polygon-clipped per-bin bounds).
  Cand spatial_split(const std::vector<SRef> &refs, const AABB &nb) const {
    Cand best;
    const int B = nbins;
    for (int a = 0; a < 3; ++a) {
      float nlo = axval(nb.lo, a);
      float extent = axval(nb.hi, a) - nlo;
      if (!(extent > 1e-30f)) continue;
      float binw = extent / B;
      float scale = B * (1.0f - 1e-6f) / extent;
      std::vector<AABB> bbox(B);
      std::vector<int64_t> entry(B, 0), exit_(B, 0);
      for (const SRef &r : refs) {
        int b0 = (int)((axval(r.box.lo, a) - nlo) * scale);
        int b1 = (int)((axval(r.box.hi, a) - nlo) * scale);
        b0 = std::min(std::max(b0, 0), B - 1);
        b1 = std::min(std::max(b1, b0), B - 1);
        entry[b0]++;
        exit_[b1]++;
        if (b0 == b1) {
          bbox[b0].grow(r.box);
          continue;
        }
        // progressive polygon chop: clip off bin b's slab at each step.
        // The ref box (already clipped by ancestors) bounds every piece.
        Poly rest = tri_poly(r.tri);
        for (int b = b0; b < b1; ++b) {
          Poly piece, next;
          poly_split(rest, a, nlo + (b + 1) * binw, piece, next);
          AABB pb = box_intersect(poly_box(piece), r.box);
          if (box_valid(pb)) bbox[b].grow(pb);
          rest = next;
        }
        AABB pb = box_intersect(poly_box(rest), r.box);
        if (box_valid(pb)) bbox[b1].grow(pb);
      }
      // suffix sweep (right side uses EXIT counts)
      std::vector<float> rarea(B);
      std::vector<int64_t> rcnt(B);
      std::vector<AABB> racc(B);
      {
        AABB acc;
        int64_t c = 0;
        for (int b = B - 1; b >= 0; --b) {
          acc.grow(bbox[b]);
          c += exit_[b];
          rarea[b] = acc.half_area();
          rcnt[b] = c;
          racc[b] = acc;
        }
      }
      AABB acc;
      int64_t c = 0;
      for (int b = 0; b < B - 1; ++b) {
        acc.grow(bbox[b]);
        c += entry[b];
        if (c == 0 || rcnt[b + 1] == 0) continue;
        float cost = c * acc.half_area() + rcnt[b + 1] * rarea[b + 1];
        if (cost < best.cost) {
          best.cost = cost;
          best.axis = a;
          best.bin = b;
          best.spatial = true;
          best.plane = nlo + (b + 1) * binw;
          best.lb = acc;
          best.rb = racc[b + 1];
          best.nl = c;
          best.nr = rcnt[b + 1];
        }
      }
    }
    return best;
  }

  // returns subtree end (== skip of this subtree's root)
  int build(std::vector<SRef> refs) {
    AABB bounds;
    for (const SRef &r : refs) bounds.grow(r.box);
    const int64_t n = (int64_t)refs.size();

    // hard leaf floor: a node of <= 8 refs is one packed row; splitting
    // it can never cost fewer rows
    if (n <= (c_trav >= 0 ? std::min<int64_t>(8, leaf_size) : leaf_size))
      return emit_leaf(bounds, refs);

    AABB cb;  // centroid bounds (of clipped ref boxes)
    for (const SRef &r : refs)
      cb.grow(Vec3{0.5f * (r.box.lo.x + r.box.hi.x),
                   0.5f * (r.box.lo.y + r.box.hi.y),
                   0.5f * (r.box.lo.z + r.box.hi.z)});

    Cand obj = object_split(refs, cb);
    Cand pick = obj;
    if (enable_spatial) {
      if (obj.axis >= 0) {
        AABB ov = box_intersect(obj.lb, obj.rb);
        if (box_valid(ov) && ov.half_area() > alpha * root_area) {
          Cand sp = spatial_split(refs, bounds);
          if (sp.axis >= 0 && sp.cost < obj.cost) pick = sp;
        }
      } else {
        Cand sp = spatial_split(refs, bounds);
        if (sp.axis >= 0) pick = sp;
      }
    }

    // row-quantized SAH termination below the leaf cap: keep the node a
    // leaf when its ceil(n/8) packed rows beat the one-level-lookahead
    // split cost (c_trav + area-weighted child rows).  This adapts leaf
    // granularity per region instead of one global leaf_size.
    if (n <= leaf_size && c_trav >= 0) {
      if (pick.axis < 0) return emit_leaf(bounds, refs);
      float a_me = bounds.half_area();
      if (!(a_me > 0)) return emit_leaf(bounds, refs);
      float leaf_cost = (float)((n + 7) / 8);
      float split_cost =
          c_trav + (pick.lb.half_area() * (float)((pick.nl + 7) / 8) +
                    pick.rb.half_area() * (float)((pick.nr + 7) / 8)) /
                       a_me;
      if (split_cost >= leaf_cost) return emit_leaf(bounds, refs);
    }

    std::vector<SRef> L, R;
    L.reserve(refs.size());
    R.reserve(refs.size());
    if (pick.axis >= 0 && pick.spatial) {
      const int a = pick.axis;
      const float p = pick.plane;
      for (const SRef &r : refs) {
        if (axval(r.box.hi, a) <= p) {
          L.push_back(r);
        } else if (axval(r.box.lo, a) >= p) {
          R.push_back(r);
        } else if (dup_pool > 0) {
          Poly pl, pr;
          poly_split(tri_poly(r.tri), a, p, pl, pr);
          AABB bl = box_intersect(poly_box(pl), r.box);
          AABB br = box_intersect(poly_box(pr), r.box);
          // numerical safety: a piece can degenerate to empty
          if (box_valid(bl) && box_valid(br)) {
            L.push_back({r.tri, bl});
            R.push_back({r.tri, br});
            dup_pool--;
          } else if (box_valid(bl)) {
            L.push_back({r.tri, bl});
          } else if (box_valid(br)) {
            R.push_back({r.tri, br});
          } else {
            L.push_back(r);
          }
        } else {
          float c = 0.5f * (axval(r.box.lo, a) + axval(r.box.hi, a));
          (c <= p ? L : R).push_back(r);
        }
      }
      // termination guard: both children must shrink
      if (L.empty() || R.empty() || (int64_t)L.size() >= n ||
          (int64_t)R.size() >= n) {
        dup_pool += (int64_t)L.size() + (int64_t)R.size() - n;
        L.clear();
        R.clear();
        pick = obj;  // fall back to the object candidate (or median)
        pick.spatial = false;
      }
    }
    if (L.empty() && R.empty()) {
      if (pick.axis >= 0 && !pick.spatial) {
        const int a = pick.axis;
        float clo = axval(cb.lo, a);
        float scale = nbins * (1.0f - 1e-6f) /
                      (axval(cb.hi, a) - clo);
        for (const SRef &r : refs) {
          float c = 0.5f * (axval(r.box.lo, a) + axval(r.box.hi, a));
          int b = (int)((c - clo) * scale);
          b = std::min(std::max(b, 0), nbins - 1);
          (b <= pick.bin ? L : R).push_back(r);
        }
      }
      if (L.empty() || R.empty()) {
        // median fallback on the widest centroid axis
        L.clear();
        R.clear();
        float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y,
                        cb.hi.z - cb.lo.z};
        int a = 0;
        if (ext[1] > ext[a]) a = 1;
        if (ext[2] > ext[a]) a = 2;
        std::vector<SRef> tmp = refs;
        std::nth_element(
            tmp.begin(), tmp.begin() + n / 2, tmp.end(),
            [a](const SRef &x, const SRef &y) {
              return axval(x.box.lo, a) + axval(x.box.hi, a) <
                     axval(y.box.lo, a) + axval(y.box.hi, a);
            });
        L.assign(tmp.begin(), tmp.begin() + n / 2);
        R.assign(tmp.begin() + n / 2, tmp.end());
      }
    }

    refs.clear();
    refs.shrink_to_fit();
    int me = (int)count.size();
    push_node(bounds);
    build(std::move(L));
    int end = build(std::move(R));
    skip[me] = end;
    return end;
  }
};

}  // namespace

extern "C" {

// High-quality build — the RTC_SCENE_HIGH_QUALITY analog
// (scene_flat.h:93).  Same flattened skip-pointer output layout as
// yrt_build_bvh, except `order` is a GATHER LIST of max_refs capacity:
// spatial splits duplicate straddling triangles into several leaves and
// row alignment tail-pads leaves.  Returns the node count, or -1 if
// max_nodes/max_refs was insufficient; *out_nrefs gets the total order
// length (live refs + padding + trailing dead tris).
//
// flags: bit0 = enable spatial splits, bit1 = align leaf starts to the
// packed 8-triangle row grid.  c_trav: interior-visit cost in packed-row
// units for row-quantized SAH leaf termination (< 0 disables: always
// split down to leaf_size).
int64_t yrt_build_sbvh(const float *v0, const float *e1, const float *e2,
                       const uint8_t *valid, int64_t T, int32_t leaf_size,
                       int32_t nbins, float alpha, int32_t flags,
                       float c_trav, float *out_lo,
                       float *out_hi, int32_t *out_start,
                       int32_t *out_count, int32_t *out_skip,
                       int64_t *out_order, int64_t max_nodes,
                       int64_t max_refs, int64_t *out_nrefs) {
  const Vec3 *V0 = reinterpret_cast<const Vec3 *>(v0);
  const Vec3 *E1 = reinterpret_cast<const Vec3 *>(e1);
  const Vec3 *E2 = reinterpret_cast<const Vec3 *>(e2);

  std::vector<SRef> live;
  std::vector<int64_t> dead;
  live.reserve(T);
  for (int64_t t = 0; t < T; ++t) {
    if (!valid[t]) {
      dead.push_back(t);
      continue;
    }
    Vec3 a = V0[t];
    Vec3 b{a.x + E1[t].x, a.y + E1[t].y, a.z + E1[t].z};
    Vec3 c{a.x + E2[t].x, a.y + E2[t].y, a.z + E2[t].z};
    AABB bb;
    bb.grow(a);
    bb.grow(b);
    bb.grow(c);
    live.push_back({t, bb});
  }

  SBuilder bld;
  bld.v0e = V0;
  bld.e1e = E1;
  bld.e2e = E2;
  bld.leaf_size = leaf_size;
  bld.nbins = nbins;
  bld.alpha = alpha;
  bld.enable_spatial = (flags & 1) != 0;
  bld.align_rows = (flags & 2) != 0;
  bld.c_trav = c_trav;
  int64_t n_live = (int64_t)live.size();
  bld.dup_pool = max_refs - n_live - (int64_t)dead.size();
  if (bld.dup_pool < 0) return -1;
  {
    AABB rb;
    for (const SRef &r : live) rb.grow(r.box);
    bld.root_area = rb.half_area();
  }
  if (n_live) bld.build(std::move(live));

  int64_t n = (int64_t)bld.count.size();
  if (n > max_nodes) return -1;
  bld.order.insert(bld.order.end(), dead.begin(), dead.end());
  int64_t nrefs = (int64_t)bld.order.size();
  if (nrefs > max_refs) return -1;
  std::memcpy(out_lo, bld.lo.data(), n * 3 * sizeof(float));
  std::memcpy(out_hi, bld.hi.data(), n * 3 * sizeof(float));
  std::memcpy(out_start, bld.start.data(), n * sizeof(int32_t));
  std::memcpy(out_count, bld.count.data(), n * sizeof(int32_t));
  std::memcpy(out_skip, bld.skip.data(), n * sizeof(int32_t));
  std::memcpy(out_order, bld.order.data(), nrefs * sizeof(int64_t));
  *out_nrefs = nrefs;
  return n;
}

// Returns number of nodes, or -1 if max_nodes was insufficient.
// Outputs: lo/hi (max_nodes*3), start/count/skip (max_nodes),
// order (T entries: new position -> old triangle index).
int64_t yrt_build_bvh(const float *v0, const float *e1, const float *e2,
                      const uint8_t *valid, int64_t T, int32_t leaf_size,
                      int32_t nbins, float *out_lo, float *out_hi,
                      int32_t *out_start, int32_t *out_count,
                      int32_t *out_skip, int64_t *out_order,
                      int64_t max_nodes) {
  std::vector<AABB> boxes(T);
  std::vector<Vec3> cents(T);
  std::vector<int64_t> live;
  std::vector<int64_t> dead;
  live.reserve(T);
  for (int64_t t = 0; t < T; ++t) {
    Vec3 a{v0[3 * t], v0[3 * t + 1], v0[3 * t + 2]};
    Vec3 b{a.x + e1[3 * t], a.y + e1[3 * t + 1], a.z + e1[3 * t + 2]};
    Vec3 c{a.x + e2[3 * t], a.y + e2[3 * t + 1], a.z + e2[3 * t + 2]};
    AABB bb;
    bb.grow(a);
    bb.grow(b);
    bb.grow(c);
    boxes[t] = bb;
    cents[t] = {0.5f * (bb.lo.x + bb.hi.x), 0.5f * (bb.lo.y + bb.hi.y),
                0.5f * (bb.lo.z + bb.hi.z)};
    if (valid[t])
      live.push_back(t);
    else
      dead.push_back(t);
  }

  Builder bld;
  bld.boxes = boxes.data();
  bld.cents = cents.data();
  bld.leaf_size = leaf_size;
  bld.nbins = nbins;
  bld.build(live.data(), (int64_t)live.size());

  int64_t n = (int64_t)bld.count.size();
  if (n > max_nodes) return -1;
  std::memcpy(out_lo, bld.lo.data(), n * 3 * sizeof(float));
  std::memcpy(out_hi, bld.hi.data(), n * 3 * sizeof(float));
  std::memcpy(out_start, bld.start.data(), n * sizeof(int32_t));
  std::memcpy(out_count, bld.count.data(), n * sizeof(int32_t));
  std::memcpy(out_skip, bld.skip.data(), n * sizeof(int32_t));
  bld.order.insert(bld.order.end(), dead.begin(), dead.end());
  std::memcpy(out_order, bld.order.data(), T * sizeof(int64_t));
  return n;
}

}  // extern "C"
