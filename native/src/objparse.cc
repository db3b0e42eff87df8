// Fast Wavefront OBJ geometry parser (native ingest path).
//
// The reference uses C++ loaders (tiny_obj_loader / tinygltf) on its host
// side; this is this framework's native equivalent for the heavy part
// of ingest — tokenizing multi-MB OBJ geometry — exposed through a tiny
// C ABI consumed via ctypes (prismarine_core_tpu/native.py).  Python
// keeps the small-file MTL/material logic.
//
// Supported: v / vn / vt, polygonal `f` with triangle-fan splitting,
// negative indices, usemtl (material slot tracked per face), mtllib
// (first library path exposed).  Two-call protocol: parse -> query
// counts -> fill caller-allocated buffers -> free.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 { float x, y, z; };
struct Vec2 { float x, y; };

struct Corner { int64_t v, t, n; };

struct ObjData {
  std::vector<Vec3> positions;
  std::vector<Vec3> normals;
  std::vector<Vec2> texcoords;
  // per-triangle corner index triples + material slot
  std::vector<Corner> c0, c1, c2;
  std::vector<int32_t> mat;
  std::vector<std::string> mat_names;   // slot -> usemtl name
  std::string mtllib;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
  char* q = nullptr;
  *out = strtof(p, &q);
  return (q && q <= end) ? q : p;
}

// parse "v/t/n", "v//n", "v/t", "v" with 1-based or negative indices
inline const char* parse_corner(const char* p, const char* end, Corner* c,
                                int64_t nv, int64_t nt, int64_t nn) {
  char* q = nullptr;
  long long v = strtoll(p, &q, 10);
  if (q == p) return p;
  p = q;
  c->v = v > 0 ? v - 1 : nv + v;
  c->t = -1;
  c->n = -1;
  if (p < end && *p == '/') {
    ++p;
    if (p < end && *p != '/') {
      long long t = strtoll(p, &q, 10);
      if (q != p) { c->t = t > 0 ? t - 1 : nt + t; p = q; }
    }
    if (p < end && *p == '/') {
      ++p;
      long long n = strtoll(p, &q, 10);
      if (q != p) { c->n = n > 0 ? n - 1 : nn + n; p = q; }
    }
  }
  return p;
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (size > 0 && fread(&buf[0], 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* d = new ObjData();
  std::unordered_map<std::string, int32_t> mat_index;
  int32_t cur_mat = 0;
  // slot 0 = default material until a usemtl appears
  const char* p = buf.data();
  const char* end = buf.data() + buf.size();
  std::vector<Corner> corners;
  corners.reserve(8);

  while (p < end) {
    p = skip_ws(p, end);
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    if (p < line_end) {
      if (p[0] == 'v' && p + 1 < line_end &&
          (p[1] == ' ' || p[1] == '\t')) {
        Vec3 v{};
        const char* q = p + 2;
        q = parse_float(q, line_end, &v.x);
        q = parse_float(q, line_end, &v.y);
        parse_float(q, line_end, &v.z);
        d->positions.push_back(v);
      } else if (p[0] == 'v' && p[1] == 'n') {
        Vec3 v{};
        const char* q = p + 3;
        q = parse_float(q, line_end, &v.x);
        q = parse_float(q, line_end, &v.y);
        parse_float(q, line_end, &v.z);
        d->normals.push_back(v);
      } else if (p[0] == 'v' && p[1] == 't') {
        Vec2 v{};
        const char* q = p + 3;
        q = parse_float(q, line_end, &v.x);
        parse_float(q, line_end, &v.y);
        d->texcoords.push_back(v);
      } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
        corners.clear();
        const char* q = p + 2;
        const int64_t nv = d->positions.size();
        const int64_t nt = d->texcoords.size();
        const int64_t nn = d->normals.size();
        while (true) {
          q = skip_ws(q, line_end);
          if (q >= line_end) break;
          Corner c{};
          const char* r = parse_corner(q, line_end, &c, nv, nt, nn);
          if (r == q) break;
          q = r;
          corners.push_back(c);
        }
        for (size_t k = 1; k + 1 < corners.size(); ++k) {
          d->c0.push_back(corners[0]);
          d->c1.push_back(corners[k]);
          d->c2.push_back(corners[k + 1]);
          d->mat.push_back(cur_mat);
        }
      } else if (!strncmp(p, "usemtl", 6)) {
        const char* q = skip_ws(p + 6, line_end);
        std::string name(q, line_end - q);
        while (!name.empty() &&
               (name.back() == '\r' || name.back() == ' '))
          name.pop_back();
        auto it = mat_index.find(name);
        if (it == mat_index.end()) {
          cur_mat = static_cast<int32_t>(d->mat_names.size());
          mat_index.emplace(name, cur_mat);
          d->mat_names.push_back(name);
        } else {
          cur_mat = it->second;
        }
      } else if (!strncmp(p, "mtllib", 6)) {
        const char* q = skip_ws(p + 6, line_end);
        std::string name(q, line_end - q);
        while (!name.empty() &&
               (name.back() == '\r' || name.back() == ' '))
          name.pop_back();
        if (d->mtllib.empty()) d->mtllib = name;
      }
    }
    p = next_line(line_end, end);
  }
  if (d->mat_names.empty()) d->mat_names.push_back("");
  return d;
}

void obj_counts(void* h, int64_t* n_tris, int64_t* n_mats) {
  auto* d = static_cast<ObjData*>(h);
  *n_tris = d->c0.size();
  *n_mats = d->mat_names.size();
}

const char* obj_mat_name(void* h, int64_t i) {
  auto* d = static_cast<ObjData*>(h);
  if (i < 0 || i >= static_cast<int64_t>(d->mat_names.size())) return "";
  return d->mat_names[i].c_str();
}

const char* obj_mtllib(void* h) {
  return static_cast<ObjData*>(h)->mtllib.c_str();
}

// Fill caller-allocated buffers: v0/v1/v2/n0/n1/n2 f32[n,3],
// t0/t1/t2 f32[n,2], mat i32[n].  Missing normals are area-weighted
// smooth normals accumulated here (matching the Python loader).
void obj_fill(void* h, float* v0, float* v1, float* v2, float* n0,
              float* n1, float* n2, float* t0, float* t1, float* t2,
              int32_t* mat) {
  auto* d = static_cast<ObjData*>(h);
  const size_t n = d->c0.size();
  const bool have_normals = !d->normals.empty();

  // smooth normals fallback (area-weighted, like geometry.py)
  std::vector<Vec3> smooth;
  if (!have_normals) {
    smooth.assign(d->positions.size(), Vec3{0, 0, 0});
    for (size_t i = 0; i < n; ++i) {
      const Vec3 a = d->positions[d->c0[i].v];
      const Vec3 b = d->positions[d->c1[i].v];
      const Vec3 c = d->positions[d->c2[i].v];
      const Vec3 e1{b.x - a.x, b.y - a.y, b.z - a.z};
      const Vec3 e2{c.x - a.x, c.y - a.y, c.z - a.z};
      const Vec3 fn{e1.y * e2.z - e1.z * e2.y,
                    e1.z * e2.x - e1.x * e2.z,
                    e1.x * e2.y - e1.y * e2.x};
      for (int64_t vi : {d->c0[i].v, d->c1[i].v, d->c2[i].v}) {
        smooth[vi].x += fn.x;
        smooth[vi].y += fn.y;
        smooth[vi].z += fn.z;
      }
    }
    for (auto& s : smooth) {
      float len = std::sqrt(s.x * s.x + s.y * s.y + s.z * s.z);
      if (len < 1e-12f) len = 1e-12f;
      s.x /= len; s.y /= len; s.z /= len;
    }
  }

  auto put3 = [](float* dst, size_t i, const Vec3& v) {
    dst[3 * i] = v.x; dst[3 * i + 1] = v.y; dst[3 * i + 2] = v.z;
  };
  auto put2 = [](float* dst, size_t i, const Vec2& v) {
    dst[2 * i] = v.x; dst[2 * i + 1] = v.y;
  };

  for (size_t i = 0; i < n; ++i) {
    const Corner cs[3] = {d->c0[i], d->c1[i], d->c2[i]};
    float* vs[3] = {v0, v1, v2};
    float* ns[3] = {n0, n1, n2};
    float* ts[3] = {t0, t1, t2};
    for (int k = 0; k < 3; ++k) {
      const Corner& c = cs[k];
      put3(vs[k], i, d->positions[c.v]);
      if (have_normals && c.n >= 0 &&
          c.n < static_cast<int64_t>(d->normals.size())) {
        put3(ns[k], i, d->normals[c.n]);
      } else if (!have_normals) {
        put3(ns[k], i, smooth[c.v]);
      } else {
        put3(ns[k], i, Vec3{0, 0, 0});
      }
      if (c.t >= 0 && c.t < static_cast<int64_t>(d->texcoords.size())) {
        put2(ts[k], i, d->texcoords[c.t]);
      } else {
        put2(ts[k], i, Vec2{0, 0});
      }
    }
    mat[i] = d->mat[i];
  }
}

void obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
