// Software depth rasterizer: the datagen's rendered-depth mode.
//
// Replaces the reference's D3D11 mesh depth render (Scene::renderDepthFrame,
// the reference's datagen/GenerateScans/src/Scene.cpp:107-158) with a
// headless z-buffer rasterizer: perspective-correct depth interpolation,
// OpenMP over triangles with per-thread depth buffers min-reduced at the
// end. Output is camera-space z (the same quantity the fusion projects
// against), -inf where nothing was hit or outside [near, far].
//
// Built by g++ at first use (render.get_raster_lib,
// utils/native_build.py) into build/rasterize-<hash>/ at the repository root.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
const float kInf = std::numeric_limits<float>::infinity();
}

extern "C" {

void rasterize_depth(
    const float* verts,      // [V, 3] world coordinates
    const int32_t* tris,     // [T, 3] vertex indices
    int64_t num_tris,
    const float* world2cam,  // [16] row-major 4x4
    const float* intrinsic,  // [16] row-major 4x4 (fx, fy, cx, cy)
    int32_t width, int32_t height,
    float near, float far,
    float* out_depth         // [height * width], filled with -inf misses
) {
  const float fx = intrinsic[0], fy = intrinsic[5];
  const float cx = intrinsic[2], cy = intrinsic[6];
  const float* R = world2cam;  // rows: R[0..3], R[4..7], R[8..11]

  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::vector<float>> zbufs(
      nthreads, std::vector<float>(width * height, kInf));

#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t t = 0; t < num_tris; ++t) {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    float* zb = zbufs[tid].data();
    float px[3], py[3], pz[3];
    bool ok = true;
    for (int k = 0; k < 3 && ok; ++k) {
      const float* v = &verts[3 * tris[3 * t + k]];
      float x = R[0] * v[0] + R[1] * v[1] + R[2] * v[2] + R[3];
      float y = R[4] * v[0] + R[5] * v[1] + R[6] * v[2] + R[7];
      float z = R[8] * v[0] + R[9] * v[1] + R[10] * v[2] + R[11];
      if (z < 1e-4f) ok = false;  // clip triangles crossing the camera plane
      pz[k] = z;
      px[k] = x * fx / z + cx;
      py[k] = y * fy / z + cy;
    }
    if (!ok) continue;
    int x0 = std::max(0, (int)std::floor(std::min({px[0], px[1], px[2]})));
    int x1 = std::min(width - 1,
                      (int)std::ceil(std::max({px[0], px[1], px[2]})));
    int y0 = std::max(0, (int)std::floor(std::min({py[0], py[1], py[2]})));
    int y1 = std::min(height - 1,
                      (int)std::ceil(std::max({py[0], py[1], py[2]})));
    if (x0 > x1 || y0 > y1) continue;
    const float ax = px[1] - px[0], ay = py[1] - py[0];
    const float bx = px[2] - px[0], by = py[2] - py[0];
    const float det = ax * by - ay * bx;
    if (std::fabs(det) < 1e-12f) continue;
    const float inv_det = 1.0f / det;
    const float iz0 = 1.0f / pz[0], iz1 = 1.0f / pz[1], iz2 = 1.0f / pz[2];
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        const float dx = (float)x - px[0];
        const float dy = (float)y - py[0];
        const float l1 = (dx * by - dy * bx) * inv_det;
        const float l2 = (ay * dx * -1.0f + ax * dy) * inv_det;
        const float l0 = 1.0f - l1 - l2;
        const float eps = -1e-5f;
        if (l0 < eps || l1 < eps || l2 < eps) continue;
        // perspective-correct depth: interpolate 1/z
        const float iz = l0 * iz0 + l1 * iz1 + l2 * iz2;
        const float z = 1.0f / iz;
        float& cur = zb[y * width + x];
        if (z < cur) cur = z;
      }
    }
  }

  // min-reduce per-thread buffers; apply the valid depth range
  for (int64_t i = 0; i < (int64_t)width * height; ++i) {
    float best = kInf;
    for (int tth = 0; tth < nthreads; ++tth) {
      best = std::min(best, zbufs[tth][i]);
    }
    out_depth[i] = (best >= near && best <= far) ? best : -kInf;
  }
}

// Depth + nearest-face-id rasterization: the face id buffer is what the
// color/Phong render modes key off (datagen/render.py:render_color) —
// the reference's annotation shader emits a flat per-primitive color
// (nointerpolation, drawAnnotations.hlsl:12), so shading needs only
// which face won each pixel, not interpolated attributes.
void rasterize_faceid(
    const float* verts,      // [V, 3] world coordinates
    const int32_t* tris,     // [T, 3] vertex indices
    int64_t num_tris,
    const float* world2cam,  // [16] row-major 4x4
    const float* intrinsic,  // [16] row-major 4x4 (fx, fy, cx, cy)
    int32_t width, int32_t height,
    float near, float far,
    float* out_depth,        // [height * width], -inf misses
    int32_t* out_face        // [height * width], -1 misses
) {
  const float fx = intrinsic[0], fy = intrinsic[5];
  const float cx = intrinsic[2], cy = intrinsic[6];
  const float* R = world2cam;

  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::vector<float>> zbufs(
      nthreads, std::vector<float>(width * height, kInf));
  std::vector<std::vector<int32_t>> fbufs(
      nthreads, std::vector<int32_t>(width * height, -1));

#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t t = 0; t < num_tris; ++t) {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    float* zb = zbufs[tid].data();
    int32_t* fb = fbufs[tid].data();
    float px[3], py[3], pz[3];
    bool ok = true;
    for (int k = 0; k < 3 && ok; ++k) {
      const float* v = &verts[3 * tris[3 * t + k]];
      float x = R[0] * v[0] + R[1] * v[1] + R[2] * v[2] + R[3];
      float y = R[4] * v[0] + R[5] * v[1] + R[6] * v[2] + R[7];
      float z = R[8] * v[0] + R[9] * v[1] + R[10] * v[2] + R[11];
      if (z < 1e-4f) ok = false;
      pz[k] = z;
      px[k] = x * fx / z + cx;
      py[k] = y * fy / z + cy;
    }
    if (!ok) continue;
    int x0 = std::max(0, (int)std::floor(std::min({px[0], px[1], px[2]})));
    int x1 = std::min(width - 1,
                      (int)std::ceil(std::max({px[0], px[1], px[2]})));
    int y0 = std::max(0, (int)std::floor(std::min({py[0], py[1], py[2]})));
    int y1 = std::min(height - 1,
                      (int)std::ceil(std::max({py[0], py[1], py[2]})));
    if (x0 > x1 || y0 > y1) continue;
    const float ax = px[1] - px[0], ay = py[1] - py[0];
    const float bx = px[2] - px[0], by = py[2] - py[0];
    const float det = ax * by - ay * bx;
    if (std::fabs(det) < 1e-12f) continue;
    const float inv_det = 1.0f / det;
    const float iz0 = 1.0f / pz[0], iz1 = 1.0f / pz[1], iz2 = 1.0f / pz[2];
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        const float dx = (float)x - px[0];
        const float dy = (float)y - py[0];
        const float l1 = (dx * by - dy * bx) * inv_det;
        const float l2 = (ay * dx * -1.0f + ax * dy) * inv_det;
        const float l0 = 1.0f - l1 - l2;
        const float eps = -1e-5f;
        if (l0 < eps || l1 < eps || l2 < eps) continue;
        const float iz = l0 * iz0 + l1 * iz1 + l2 * iz2;
        const float z = 1.0f / iz;
        const int64_t i = (int64_t)y * width + x;
        if (z < zb[i]) {
          zb[i] = z;
          fb[i] = (int32_t)t;
        }
      }
    }
  }

  for (int64_t i = 0; i < (int64_t)width * height; ++i) {
    float best = kInf;
    int32_t face = -1;
    for (int tth = 0; tth < nthreads; ++tth) {
      if (zbufs[tth][i] < best) {
        best = zbufs[tth][i];
        face = fbufs[tth][i];
      }
    }
    const bool hit = best >= near && best <= far;
    out_depth[i] = hit ? best : -kInf;
    out_face[i] = hit ? face : -1;
  }
}

}  // extern "C"
