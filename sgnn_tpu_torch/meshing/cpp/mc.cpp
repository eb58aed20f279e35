// Native marching-cubes core: corner-grid sampling + cube scan.
//
// Port of sgnn_tpu/meshing/cpp/mc.cpp. Same semantics as
// sgnn_tpu_torch/meshing/marching_cubes.py (see its docstring for the
// reference citations); this is the production hot path for large scene
// volumes, OpenMP-parallel over z-slabs. One change from the JAX package's
// copy: triangles are buffered per z-slice, not per thread, and written
// out in z order, so the output (and the PLY bytes) do not depend on how
// the dynamic schedule handed slices to threads.
// Lookup tables are passed in from Python so the constants live in one
// place (sgnn_tpu_torch/meshing/tables.py).
//
// Built at first use by sgnn_tpu_torch/meshing/native.py (g++ -O3
// -march=native -fPIC -shared -fopenmp -std=c++17, the JAX package's
// flags) into build/ at the repository root.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 lerp_edge(float iso, const V3& p1, const V3& p2, float d1, float d2) {
  const float eps = 1e-5f;
  if (std::fabs(iso - d1) < eps) return p1;
  if (std::fabs(iso - d2) < eps) return p2;
  if (std::fabs(d1 - d2) < eps) return p1;
  float mu = (iso - d1) / (d2 - d1);
  return V3{p1.x + mu * (p2.x - p1.x), p1.y + mu * (p2.y - p1.y),
            p1.z + mu * (p2.z - p1.z)};
}

// Corner label order p000..p111 as (x,y,z) offsets — must match the Python
// module's _CORNER_OFFSETS_XYZ.
const int kCornerOff[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
                              {1, 1, 0}, {0, 1, 1}, {1, 0, 1}, {1, 1, 1}};
// Cube-index bit per corner (reference marching_cubes.cpp:192-199).
const int kCornerBit[8] = {8, 4, 1, 128, 2, 16, 64, 32};
// Edge endpoints as corner label indices (reference :234-245).
const int kEdgeEnds[12][2] = {{2, 4}, {4, 1}, {1, 0}, {0, 2},
                              {5, 7}, {7, 6}, {6, 3}, {3, 5},
                              {2, 5}, {4, 7}, {1, 6}, {0, 3}};

struct Tri {
  float v[9];
  uint8_t c[9];
};

}  // namespace

extern "C" {

// Returns the number of triangles written, or -(needed) if max_tris was too
// small (caller should retry with a larger buffer).
int64_t mc_extract(const float* tsdf, const uint8_t* colors, int64_t Z,
                   int64_t Y, int64_t X, float isovalue, float truncation,
                   float thresh, const int32_t* edge_table,
                   const int32_t* tri_table, float* out_verts,
                   uint8_t* out_cols, int64_t max_tris) {
  const int64_t CZ = Z + 1, CY = Y + 1, CX = X + 1;
  // Corner grid: mean of the 8 adjacent voxels; valid iff all 8 valid.
  std::vector<float> cg(CZ * CY * CX, 0.f);
  std::vector<uint8_t> ok(CZ * CY * CX, 0);
#pragma omp parallel for schedule(static)
  for (int64_t cz = 0; cz < CZ; ++cz) {
    for (int64_t cy = 0; cy < CY; ++cy) {
      for (int64_t cx = 0; cx < CX; ++cx) {
        if (cz == 0 || cy == 0 || cx == 0 || cz == Z || cy == Y || cx == X)
          continue;  // boundary corners touch out-of-bounds voxels
        float acc = 0.f;
        bool valid = true;
        for (int dz = -1; dz <= 0 && valid; ++dz)
          for (int dy = -1; dy <= 0 && valid; ++dy)
            for (int dx = -1; dx <= 0 && valid; ++dx) {
              float d = tsdf[((cz + dz) * Y + (cy + dy)) * X + (cx + dx)];
              if (!std::isfinite(d) || std::fabs(d) >= truncation) {
                valid = false;
              } else {
                acc += d;
              }
            }
        if (valid) {
          cg[(cz * CY + cy) * CX + cx] = acc / 8.f;
          ok[(cz * CY + cy) * CX + cx] = 1;
        }
      }
    }
  }

  std::vector<std::vector<Tri>> bufs(Z);  // per z-slice, joined in z order

#pragma omp parallel for schedule(dynamic, 4)
  for (int64_t z = 0; z < Z; ++z) {
    auto& buf = bufs[z];
    for (int64_t y = 0; y < Y; ++y) {
      for (int64_t x = 0; x < X; ++x) {
        float d[8];
        bool all_valid = true;
        for (int c = 0; c < 8 && all_valid; ++c) {
          int64_t cz = z + kCornerOff[c][2];
          int64_t cy = y + kCornerOff[c][1];
          int64_t cx = x + kCornerOff[c][0];
          int64_t ci = (cz * CY + cy) * CX + cx;
          if (!ok[ci]) {
            all_valid = false;
          } else {
            d[c] = cg[ci];
          }
        }
        if (!all_valid) continue;

        int cube = 0;
        bool reject = false;
        for (int c = 0; c < 8; ++c) {
          if (d[c] < isovalue) cube += kCornerBit[c];
          if (std::fabs(d[c]) > thresh) reject = true;
        }
        if (reject) continue;
        for (int i = 0; i < 8 && !reject; ++i)
          for (int j = 0; j < 8; ++j) {
            if (d[i] * d[j] < 0.f) {
              if (std::fabs(d[i]) + std::fabs(d[j]) > thresh) {
                reject = true;
                break;
              }
            } else if (std::fabs(d[i] - d[j]) > thresh) {
              reject = true;
              break;
            }
          }
        if (reject) continue;
        int et = edge_table[cube];
        if (et == 0 || et == 255) continue;

        V3 cpos[8];
        for (int c = 0; c < 8; ++c) {
          cpos[c] = V3{(float)x + kCornerOff[c][0] - 0.5f,
                       (float)y + kCornerOff[c][1] - 0.5f,
                       (float)z + kCornerOff[c][2] - 0.5f};
        }
        V3 vert[12];
        for (int e = 0; e < 12; ++e) {
          if (et & (1 << e)) {
            int a = kEdgeEnds[e][0], b = kEdgeEnds[e][1];
            vert[e] = lerp_edge(isovalue, cpos[a], cpos[b], d[a], d[b]);
          }
        }
        uint8_t col[3] = {220, 220, 220};
        if (colors) {
          const uint8_t* c = &colors[((z * Y + y) * X + x) * 3];
          col[0] = c[0];
          col[1] = c[1];
          col[2] = c[2];
        }
        const int32_t* tt = &tri_table[cube * 16];
        for (int i = 0; tt[i] != -1; i += 3) {
          Tri t;
          for (int k = 0; k < 3; ++k) {
            const V3& v = vert[tt[i + k]];
            t.v[3 * k] = v.x;
            t.v[3 * k + 1] = v.y;
            t.v[3 * k + 2] = v.z;
            t.c[3 * k] = col[0];
            t.c[3 * k + 1] = col[1];
            t.c[3 * k + 2] = col[2];
          }
          buf.push_back(t);
        }
      }
    }
  }

  int64_t total = 0;
  for (auto& b : bufs) total += (int64_t)b.size();
  if (total > max_tris) return -total;
  int64_t off = 0;
  for (auto& b : bufs) {
    for (auto& t : b) {
      std::memcpy(out_verts + off * 9, t.v, sizeof(t.v));
      std::memcpy(out_cols + off * 9, t.c, sizeof(t.c));
      ++off;
    }
  }
  return total;
}

}  // extern "C"
