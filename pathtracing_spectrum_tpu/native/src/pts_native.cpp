// Native runtime components for pathtracing_spectrum_tpu.
//
// The reference keeps its whole runtime in C++ (tiny_obj_loader parsing at
// pathtracer.cpp:46-150 / previewer.cpp:294+, and the recursive sort-split
// BVH build at mesh.cpp:177-221). The device compute path needs neither on
// device, but scene ingest and acceleration-structure *construction* stay
// host-side and latency-bound, so they are implemented natively here:
//
//  * a Wavefront OBJ parser with the same semantics as the Python fallback
//    (utils/obj_loader.py): o/g shape splitting, fan triangulation,
//    negative indices, per-face smoothing groups, fail-soft on bad lines;
//  * a binned-SAH BVH builder emitting the flat skip-link layout consumed
//    by ops/bvh.py (DFS preorder, leaf ranges over a triangle permutation)
//    — an upgrade over both the Python median-split builder and the
//    reference's random-axis full-sort build.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cctype>
#include <cfloat>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <charconv>
#include <cmath>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader
// ---------------------------------------------------------------------------

struct ObjShapeData {
  std::string name;
  std::vector<int32_t> v_idx;   // 3 per face
  std::vector<int32_t> vt_idx;
  std::vector<int32_t> vn_idx;
  std::vector<uint32_t> smoothing;  // 1 per face
};

struct ObjHandle {
  std::vector<float> vertices;   // 3 per vertex
  std::vector<float> texcoords;  // 2 per vt
  std::vector<float> normals;    // 3 per vn
  std::vector<ObjShapeData> shapes;
};

static inline int resolve_index(long idx, size_t count) {
  return idx > 0 ? static_cast<int>(idx - 1)
                 : static_cast<int>(static_cast<long>(count) + idx);
}

static inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

ObjHandle* pts_obj_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&data[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  ObjHandle* h = new ObjHandle();
  ObjShapeData cur;
  uint32_t smooth_group = 0;

  struct Corner { int v, t, n; };
  std::vector<Corner> corners;
  corners.reserve(8);

  auto flush = [&]() {
    if (!cur.v_idx.empty()) {
      h->shapes.push_back(std::move(cur));
      cur = ObjShapeData();
      cur.name.clear();
    } else {
      cur.v_idx.clear();
      cur.vt_idx.clear();
      cur.vn_idx.clear();
      cur.smoothing.clear();
    }
  };

  const char* p = data.c_str();
  const char* end = p + data.size();
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p);

    if (q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char* e;
      float x = std::strtof(q + 2, &e);
      float y = std::strtof(e, &e);
      float z = std::strtof(e, &e);
      if (e > q + 2) {
        h->vertices.push_back(x);
        h->vertices.push_back(y);
        h->vertices.push_back(z);
      }
    } else if (q[0] == 'v' && q[1] == 't' && (q[2] == ' ' || q[2] == '\t')) {
      char* e;
      float u = std::strtof(q + 3, &e);
      float v = std::strtof(e, &e);
      if (e > q + 3) {
        h->texcoords.push_back(u);
        h->texcoords.push_back(v);
      }
    } else if (q[0] == 'v' && q[1] == 'n' && (q[2] == ' ' || q[2] == '\t')) {
      char* e;
      float x = std::strtof(q + 3, &e);
      float y = std::strtof(e, &e);
      float z = std::strtof(e, &e);
      if (e > q + 3) {
        h->normals.push_back(x);
        h->normals.push_back(y);
        h->normals.push_back(z);
      }
    } else if (q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      corners.clear();
      const char* c = q + 1;
      bool ok = true;
      while (c < line_end) {
        c = skip_ws(c);
        if (c >= line_end || *c == '\n') break;
        char* e;
        long vi = std::strtol(c, &e, 10);
        if (e == c) { ok = false; break; }
        int v = resolve_index(vi, h->vertices.size() / 3);
        int t = -1, n = -1;
        c = e;
        if (*c == '/') {
          ++c;
          if (*c != '/') {
            long ti = std::strtol(c, &e, 10);
            if (e != c) t = resolve_index(ti, h->texcoords.size() / 2);
            c = e;
          }
          if (*c == '/') {
            ++c;
            long ni = std::strtol(c, &e, 10);
            if (e != c) n = resolve_index(ni, h->normals.size() / 3);
            c = e;
          }
        }
        corners.push_back({v, t, n});
      }
      if (ok && corners.size() >= 3) {
        for (size_t k = 1; k + 1 < corners.size(); ++k) {
          const Corner tri[3] = {corners[0], corners[k], corners[k + 1]};
          for (const Corner& cr : tri) {
            cur.v_idx.push_back(cr.v);
            cur.vt_idx.push_back(cr.t);
            cur.vn_idx.push_back(cr.n);
          }
          cur.smoothing.push_back(smooth_group);
        }
      }
    } else if ((q[0] == 'o' || q[0] == 'g') &&
               (q[1] == ' ' || q[1] == '\t' || q + 1 == line_end)) {
      flush();
      const char* name_start = skip_ws(q + 1);
      std::string name(name_start, static_cast<size_t>(line_end - name_start));
      while (!name.empty() &&
             (name.back() == '\r' || name.back() == ' ' || name.back() == '\t'))
        name.pop_back();
      cur.name = name;
    } else if (q[0] == 's' && (q[1] == ' ' || q[1] == '\t')) {
      const char* val = skip_ws(q + 1);
      if (std::strncmp(val, "off", 3) == 0) {
        smooth_group = 0;
      } else {
        char* e;
        long g = std::strtol(val, &e, 10);
        smooth_group = (e == val) ? 1u : static_cast<uint32_t>(g);
      }
    }
    p = line_end + 1;
  }
  flush();
  return h;
}

void pts_obj_counts(ObjHandle* h, int32_t* n_vertices, int32_t* n_texcoords,
                    int32_t* n_normals, int32_t* n_shapes) {
  *n_vertices = static_cast<int32_t>(h->vertices.size() / 3);
  *n_texcoords = static_cast<int32_t>(h->texcoords.size() / 2);
  *n_normals = static_cast<int32_t>(h->normals.size() / 3);
  *n_shapes = static_cast<int32_t>(h->shapes.size());
}

void pts_obj_copy_attribs(ObjHandle* h, float* vertices, float* texcoords,
                          float* normals) {
  std::memcpy(vertices, h->vertices.data(), h->vertices.size() * sizeof(float));
  std::memcpy(texcoords, h->texcoords.data(),
              h->texcoords.size() * sizeof(float));
  std::memcpy(normals, h->normals.data(), h->normals.size() * sizeof(float));
}

int32_t pts_obj_shape_faces(ObjHandle* h, int32_t shape) {
  return static_cast<int32_t>(h->shapes[shape].smoothing.size());
}

int32_t pts_obj_shape_name(ObjHandle* h, int32_t shape, char* out,
                           int32_t cap) {
  const std::string& s = h->shapes[shape].name;
  int32_t n = static_cast<int32_t>(
      std::min<size_t>(s.size(), static_cast<size_t>(cap - 1)));
  std::memcpy(out, s.data(), static_cast<size_t>(n));
  out[n] = '\0';
  return n;
}

void pts_obj_shape_indices(ObjHandle* h, int32_t shape, int32_t* v_idx,
                           int32_t* vt_idx, int32_t* vn_idx,
                           uint32_t* smoothing) {
  const ObjShapeData& s = h->shapes[shape];
  std::memcpy(v_idx, s.v_idx.data(), s.v_idx.size() * sizeof(int32_t));
  std::memcpy(vt_idx, s.vt_idx.data(), s.vt_idx.size() * sizeof(int32_t));
  std::memcpy(vn_idx, s.vn_idx.data(), s.vn_idx.size() * sizeof(int32_t));
  std::memcpy(smoothing, s.smoothing.data(),
              s.smoothing.size() * sizeof(uint32_t));
}

void pts_obj_free(ObjHandle* h) { delete h; }

// ---------------------------------------------------------------------------
// Binned-SAH BVH builder (flat skip-link layout, DFS preorder)
// ---------------------------------------------------------------------------

struct BvhHandle {
  std::vector<float> node_min;   // 3 per node
  std::vector<float> node_max;
  std::vector<int32_t> node_skip;
  std::vector<int32_t> node_first;
  std::vector<int32_t> node_count;
  std::vector<int64_t> tri_order;
};

namespace {

struct Builder {
  const float* tmin;
  const float* tmax;
  std::vector<double> cx, cy, cz;  // centroids
  BvhHandle* out;
  std::vector<int64_t>* order;
  int leaf_size;

  static constexpr int kBins = 16;

  int emit(int64_t lo, int64_t hi) {
    float bmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float bmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int64_t i = lo; i < hi; ++i) {
      int64_t t = (*order)[i];
      for (int a = 0; a < 3; ++a) {
        bmin[a] = std::min(bmin[a], tmin[t * 3 + a]);
        bmax[a] = std::max(bmax[a], tmax[t * 3 + a]);
      }
    }
    for (int a = 0; a < 3; ++a)
      if (bmax[a] == bmin[a]) bmax[a] += 1e-3f;  // AABB::Check parity
    int idx = static_cast<int>(out->node_min.size() / 3);
    for (int a = 0; a < 3; ++a) out->node_min.push_back(bmin[a]);
    for (int a = 0; a < 3; ++a) out->node_max.push_back(bmax[a]);
    out->node_skip.push_back(-1);
    out->node_first.push_back(static_cast<int32_t>(lo));
    out->node_count.push_back(0);
    return idx;
  }

  double centroid(int64_t t, int axis) const {
    switch (axis) {
      case 0: return cx[t];
      case 1: return cy[t];
      default: return cz[t];
    }
  }

  void build(int64_t lo, int64_t hi) {
    int idx = emit(lo, hi);
    int64_t n = hi - lo;
    if (n <= leaf_size) {
      out->node_count[idx] = static_cast<int32_t>(n);
      out->node_skip[idx] = static_cast<int32_t>(out->node_min.size() / 3);
      return;
    }

    // binned SAH over the widest centroid axis
    double cmin[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
    double cmax[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
    for (int64_t i = lo; i < hi; ++i) {
      int64_t t = (*order)[i];
      double c[3] = {cx[t], cy[t], cz[t]};
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    int axis = 0;
    double ext = -1.0;
    for (int a = 0; a < 3; ++a) {
      double e = cmax[a] - cmin[a];
      if (e > ext) { ext = e; axis = a; }
    }

    int64_t mid;
    if (ext <= 0.0) {
      mid = lo + n / 2;  // degenerate: median split
    } else {
      // bin triangles
      struct Bin { double bmin[3], bmax[3]; int64_t count = 0; };
      Bin bins[kBins];
      for (Bin& b : bins)
        for (int a = 0; a < 3; ++a) { b.bmin[a] = DBL_MAX; b.bmax[a] = -DBL_MAX; }
      double inv = kBins / ext;
      for (int64_t i = lo; i < hi; ++i) {
        int64_t t = (*order)[i];
        int b = static_cast<int>((centroid(t, axis) - cmin[axis]) * inv);
        b = std::min(std::max(b, 0), kBins - 1);
        bins[b].count++;
        for (int a = 0; a < 3; ++a) {
          bins[b].bmin[a] = std::min(bins[b].bmin[a],
                                     static_cast<double>(tmin[t * 3 + a]));
          bins[b].bmax[a] = std::max(bins[b].bmax[a],
                                     static_cast<double>(tmax[t * 3 + a]));
        }
      }
      // sweep SAH costs
      double larea[kBins], rarea[kBins];
      int64_t lcount[kBins];
      double bmn[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
      double bmx[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
      int64_t cnt = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        if (bins[b].count) {
          for (int a = 0; a < 3; ++a) {
            bmn[a] = std::min(bmn[a], bins[b].bmin[a]);
            bmx[a] = std::max(bmx[a], bins[b].bmax[a]);
          }
        }
        cnt += bins[b].count;
        lcount[b] = cnt;
        double dx = std::max(bmx[0] - bmn[0], 0.0);
        double dy = std::max(bmx[1] - bmn[1], 0.0);
        double dz = std::max(bmx[2] - bmn[2], 0.0);
        larea[b] = cnt ? (dx * dy + dy * dz + dz * dx) : 0.0;
      }
      for (int a = 0; a < 3; ++a) { bmn[a] = DBL_MAX; bmx[a] = -DBL_MAX; }
      for (int b = kBins - 1; b > 0; --b) {
        if (bins[b].count) {
          for (int a = 0; a < 3; ++a) {
            bmn[a] = std::min(bmn[a], bins[b].bmin[a]);
            bmx[a] = std::max(bmx[a], bins[b].bmax[a]);
          }
        }
        double dx = std::max(bmx[0] - bmn[0], 0.0);
        double dy = std::max(bmx[1] - bmn[1], 0.0);
        double dz = std::max(bmx[2] - bmn[2], 0.0);
        rarea[b - 1] = dx * dy + dy * dz + dz * dx;
      }
      int best = -1;
      double best_cost = DBL_MAX;
      for (int b = 0; b < kBins - 1; ++b) {
        int64_t lc = lcount[b], rc = n - lc;
        if (lc == 0 || rc == 0) continue;
        double cost = larea[b] * lc + rarea[b] * rc;
        if (cost < best_cost) { best_cost = cost; best = b; }
      }
      if (best < 0) {
        mid = lo + n / 2;
        int64_t* base = order->data();
        std::nth_element(base + lo, base + mid, base + hi,
                         [&](int64_t a, int64_t b) {
                           return centroid(a, axis) < centroid(b, axis);
                         });
      } else {
        double split = cmin[axis] + (best + 1) / inv;
        int64_t* base = order->data();
        int64_t* pmid = std::partition(base + lo, base + hi, [&](int64_t t) {
          return centroid(t, axis) < split;
        });
        mid = pmid - base;
        if (mid == lo || mid == hi) mid = lo + n / 2;  // guard
      }
    }

    build(lo, mid);
    build(mid, hi);
    out->node_skip[idx] = static_cast<int32_t>(out->node_min.size() / 3);
  }
};

}  // namespace

BvhHandle* pts_bvh_build(const float* tri_min, const float* tri_max,
                         int64_t n_tris, int32_t leaf_size) {
  BvhHandle* h = new BvhHandle();
  h->tri_order.resize(static_cast<size_t>(n_tris));
  for (int64_t i = 0; i < n_tris; ++i) h->tri_order[i] = i;
  if (n_tris == 0) return h;

  Builder b;
  b.tmin = tri_min;
  b.tmax = tri_max;
  b.out = h;
  b.order = &h->tri_order;
  b.leaf_size = leaf_size;
  b.cx.resize(static_cast<size_t>(n_tris));
  b.cy.resize(static_cast<size_t>(n_tris));
  b.cz.resize(static_cast<size_t>(n_tris));
  for (int64_t i = 0; i < n_tris; ++i) {
    b.cx[i] = 0.5 * (tri_min[i * 3 + 0] + tri_max[i * 3 + 0]);
    b.cy[i] = 0.5 * (tri_min[i * 3 + 1] + tri_max[i * 3 + 1]);
    b.cz[i] = 0.5 * (tri_min[i * 3 + 2] + tri_max[i * 3 + 2]);
  }
  b.build(0, n_tris);
  return h;
}

int32_t pts_bvh_node_count(BvhHandle* h) {
  return static_cast<int32_t>(h->node_min.size() / 3);
}

void pts_bvh_export(BvhHandle* h, float* node_min, float* node_max,
                    int32_t* skip, int32_t* first, int32_t* count,
                    int64_t* tri_order) {
  std::memcpy(node_min, h->node_min.data(),
              h->node_min.size() * sizeof(float));
  std::memcpy(node_max, h->node_max.data(),
              h->node_max.size() * sizeof(float));
  std::memcpy(skip, h->node_skip.data(),
              h->node_skip.size() * sizeof(int32_t));
  std::memcpy(first, h->node_first.data(),
              h->node_first.size() * sizeof(int32_t));
  std::memcpy(count, h->node_count.data(),
              h->node_count.size() * sizeof(int32_t));
  std::memcpy(tri_order, h->tri_order.data(),
              h->tri_order.size() * sizeof(int64_t));
}

void pts_bvh_free(BvhHandle* h) { delete h; }

// ---------------------------------------------------------------------------
// Spectral ASCII export (reference ExportAt, main.cpp:951-983): for each
// wavelength, h lines of w "%g "-formatted values, NaN -> 0, top row first.
// Byte-identical to the Python writer (utils/spectral_io.format_spectrum);
// exists because formatting 10s of MB of text dominates export time at
// 1080p+ in Python.
// ---------------------------------------------------------------------------
int32_t pts_export_spectrum(const char* path, const float* img, int32_t h,
                            int32_t w, int32_t nw) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  // std::to_chars(general, 6) is specified to format "as if by printf %g"
  // in the C locale — byte-identical to the Python writer — at a fraction
  // of fprintf's per-call cost (no format parsing, no locale, no lock).
  std::vector<char> line((size_t)w * 16 + 64);
  for (int32_t k = 0; k < nw; ++k) {
    for (int32_t i = 0; i < h; ++i) {
      const float* row = img + ((int64_t)i * w) * nw;
      char* p = line.data();
      for (int32_t j = 0; j < w; ++j) {
        double v = (double)row[(int64_t)j * nw + k];
        if (std::isnan(v)) v = 0.0;
        auto res = std::to_chars(p, line.data() + line.size() - 2, v,
                                 std::chars_format::general, 6);
        p = res.ptr;
        *p++ = ' ';
      }
      *p++ = '\n';
      if (std::fwrite(line.data(), 1, (size_t)(p - line.data()), f)
          != (size_t)(p - line.data())) {
        std::fclose(f);
        return 1;
      }
    }
  }
  return std::fclose(f) ? 1 : 0;
}

}  // extern "C"
