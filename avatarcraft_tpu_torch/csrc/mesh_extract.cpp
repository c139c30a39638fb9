// Native iso-surface extraction: marching tetrahedra over a dense scalar
// field, multithreaded, with exact shared-vertex welding.
//
// Plays the role of the reference's `mcubes` C extension
// (reference: models/instant_nsr.py:758) in the TPU framework's runtime:
// the field is evaluated on-device (JAX), the grid is streamed to host, and
// this extractor produces the watertight mesh. Same Kuhn 6-tetrahedra
// decomposition as the numpy fallback (avatarcraft_tpu/utils/marching_cubes.py),
// so both paths emit identical geometry.
//
// C ABI (ctypes): see mesh_extract_run / mesh_extract_free below.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Kuhn decomposition around the 0-7 body diagonal; corner bits: x + 2y + 4z.
constexpr int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7},
};
constexpr int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};
constexpr int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// Triangulation per sign config (bit i set = vertex i above iso); entries are
// edge ids, up to 2 triangles, -1 terminated. Orientation: outward w.r.t. the
// "above" region (matches the numpy implementation's table).
// NOTE: every row is explicitly -1 terminated (aggregate init pads with 0,
// which is a valid edge id and must not appear past the terminator).
constexpr int kTriTable[16][7] = {
    {-1, -1, -1, -1, -1, -1, -1},  // 0000
    {0, 2, 1, -1, -1, -1, -1},     // 0001
    {0, 3, 4, -1, -1, -1, -1},     // 0010
    {1, 2, 4, 1, 4, 3, -1},        // 0011
    {1, 5, 3, -1, -1, -1, -1},     // 0100
    {0, 2, 5, 0, 5, 3, -1},        // 0101
    {0, 1, 5, 0, 5, 4, -1},        // 0110
    {2, 5, 4, -1, -1, -1, -1},     // 0111
    {2, 4, 5, -1, -1, -1, -1},     // 1000
    {0, 5, 1, 0, 4, 5, -1},        // 1001
    {0, 5, 2, 0, 3, 5, -1},        // 1010
    {1, 3, 5, -1, -1, -1, -1},     // 1011
    {1, 4, 2, 1, 3, 4, -1},        // 1100
    {0, 4, 3, -1, -1, -1, -1},     // 1101
    {0, 1, 2, -1, -1, -1, -1},     // 1110
    {-1, -1, -1, -1, -1, -1, -1},  // 1111
};

struct V3 {
  float x, y, z;
};

struct ThreadOut {
  std::vector<V3> verts;
  std::vector<int64_t> vert_keys;  // exact grid-edge key per vertex
  std::vector<int64_t> tris;       // flat triples of local vertex ids
};

// a,b are global grid-vertex linear ids; exact order-independent key
inline int64_t edge_key(int64_t a, int64_t b, int64_t n_grid) {
  if (a > b) std::swap(a, b);
  return a * n_grid + b;  // exact for n_grid^2 < 2^63 (grids beyond 2M^0.5 ok)
}

void process_slab(const float* f, int X, int Y, int Z, float iso, int x0,
                  int x1, ThreadOut* out) {
  auto fid = [&](int x, int y, int z) -> int64_t {
    return (int64_t)(x * Y + y) * Z + z;
  };
  std::unordered_map<int64_t, int64_t> edge_cache;
  edge_cache.reserve(1 << 14);

  float vals[8];
  int64_t gids[8];
  int gx[8], gy[8], gz[8];

  for (int x = x0; x < x1; ++x) {
    for (int y = 0; y + 1 < Y; ++y) {
      for (int z = 0; z + 1 < Z; ++z) {
        for (int c = 0; c < 8; ++c) {
          gx[c] = x + kCorner[c][0];
          gy[c] = y + kCorner[c][1];
          gz[c] = z + kCorner[c][2];
          gids[c] = fid(gx[c], gy[c], gz[c]);
          vals[c] = f[gids[c]];
        }
        for (int t = 0; t < 6; ++t) {
          const int* tet = kTets[t];
          int cfg = 0;
          for (int i = 0; i < 4; ++i)
            if (vals[tet[i]] > iso) cfg |= 1 << i;
          const int* tri = kTriTable[cfg];
          if (tri[0] < 0) continue;
          // tet parity for consistent winding
          double e1[3], e2[3], e3[3];
          for (int d = 0; d < 3; ++d) {
            e1[d] = kCorner[tet[1]][d] - kCorner[tet[0]][d];
            e2[d] = kCorner[tet[2]][d] - kCorner[tet[0]][d];
            e3[d] = kCorner[tet[3]][d] - kCorner[tet[0]][d];
          }
          double det = e1[0] * (e2[1] * e3[2] - e2[2] * e3[1]) -
                       e1[1] * (e2[0] * e3[2] - e2[2] * e3[0]) +
                       e1[2] * (e2[0] * e3[1] - e2[1] * e3[0]);
          bool flip = det < 0;

          int64_t tri_v[6];
          int n_edges_used = 0;
          int64_t edge_vid[6];
          bool edge_seen[6] = {false, false, false, false, false, false};
          auto vert_for_edge = [&](int e) -> int64_t {
            if (edge_seen[e]) return edge_vid[e];
            int a = tet[kTetEdges[e][0]], b = tet[kTetEdges[e][1]];
            int64_t key = edge_key(gids[a], gids[b], (int64_t)X * Y * Z);
            auto it = edge_cache.find(key);
            if (it != edge_cache.end()) {
              edge_seen[e] = true;
              edge_vid[e] = it->second;
              return it->second;
            }
            float va = vals[a], vb = vals[b];
            float tt = (iso - va) / (vb - va);
            V3 p;
            p.x = gx[a] + tt * (gx[b] - gx[a]);
            p.y = gy[a] + tt * (gy[b] - gy[a]);
            p.z = gz[a] + tt * (gz[b] - gz[a]);
            int64_t vid = (int64_t)out->verts.size();
            out->verts.push_back(p);
            out->vert_keys.push_back(key);
            edge_cache.emplace(key, vid);
            edge_seen[e] = true;
            edge_vid[e] = vid;
            (void)n_edges_used;
            (void)tri_v;
            return vid;
          };

          for (int k = 0; k < 7 && tri[k] >= 0; k += 3) {
            int64_t v0 = vert_for_edge(tri[k]);
            int64_t v1 = vert_for_edge(tri[k + 1]);
            int64_t v2 = vert_for_edge(tri[k + 2]);
            if (v0 == v1 || v1 == v2 || v0 == v2) continue;
            if (flip) std::swap(v1, v2);
            out->tris.push_back(v0);
            out->tris.push_back(v1);
            out->tris.push_back(v2);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Extract the iso-surface. Returns 0 on success. Caller frees with
// mesh_extract_free. verts: float32 [n_verts*3] in index coordinates;
// tris: int32 [n_tris*3].
int mesh_extract_run(const float* field, int X, int Y, int Z, float iso,
                     int n_threads, float** out_verts, int64_t* out_n_verts,
                     int32_t** out_tris, int64_t* out_n_tris) {
  if (X < 2 || Y < 2 || Z < 2) {
    *out_verts = nullptr;
    *out_tris = nullptr;
    *out_n_verts = 0;
    *out_n_tris = 0;
    return 0;
  }
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min(n_threads, X - 1));

  std::vector<ThreadOut> outs(n_threads);
  std::vector<std::thread> threads;
  int cells_x = X - 1;
  for (int i = 0; i < n_threads; ++i) {
    int x0 = (int)((int64_t)cells_x * i / n_threads);
    int x1 = (int)((int64_t)cells_x * (i + 1) / n_threads);
    threads.emplace_back(process_slab, field, X, Y, Z, iso, x0, x1, &outs[i]);
  }
  for (auto& t : threads) t.join();

  // merge thread outputs; weld duplicate vertices across slab boundaries
  int64_t total_v = 0, total_t = 0;
  for (auto& o : outs) {
    total_v += (int64_t)o.verts.size();
    total_t += (int64_t)o.tris.size() / 3;
  }
  std::vector<V3> verts;
  verts.reserve(total_v);
  std::vector<int32_t> tris;
  tris.reserve(total_t * 3);

  std::unordered_map<int64_t, int32_t> weld;  // exact grid-edge key -> vid
  weld.reserve(total_v * 2);

  for (auto& o : outs) {
    std::vector<int32_t> remap(o.verts.size());
    for (size_t i = 0; i < o.verts.size(); ++i) {
      int64_t key = o.vert_keys[i];
      auto it = weld.find(key);
      if (it == weld.end()) {
        int32_t vid = (int32_t)verts.size();
        verts.push_back(o.verts[i]);
        weld.emplace(key, vid);
        remap[i] = vid;
      } else {
        remap[i] = it->second;
      }
    }
    for (size_t i = 0; i + 2 < o.tris.size() || (i + 3 <= o.tris.size()); i += 3) {
      if (i + 3 > o.tris.size()) break;
      int32_t a = remap[o.tris[i]], b = remap[o.tris[i + 1]], c = remap[o.tris[i + 2]];
      if (a == b || b == c || a == c) continue;
      tris.push_back(a);
      tris.push_back(b);
      tris.push_back(c);
    }
  }

  *out_n_verts = (int64_t)verts.size();
  *out_n_tris = (int64_t)tris.size() / 3;
  *out_verts = (float*)std::malloc(verts.size() * 3 * sizeof(float));
  *out_tris = (int32_t*)std::malloc(tris.size() * sizeof(int32_t));
  if (!*out_verts || !*out_tris) return 1;
  std::memcpy(*out_verts, verts.data(), verts.size() * 3 * sizeof(float));
  std::memcpy(*out_tris, tris.data(), tris.size() * sizeof(int32_t));
  return 0;
}

void mesh_extract_free(float* verts, int32_t* tris) {
  std::free(verts);
  std::free(tris);
}

}  // extern "C"
