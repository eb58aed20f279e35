// The activation-scale pre-pass of the int8 sites (K1q, K2q, K3q).
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py, the per-tile activation
// amax of the int8 bodies of _kernel_fused (:419-421), _kernel_upconv
// (:875-876) and _kernel_downconv (:1231-1233):
//
//   amax[b, iz, iy, g] = max |tf_g| over the padded rows (z, y) of the
//                        window of TPU tile (iz, iy), every x block and
//                        every lane, dead lanes included
//   tf_g = relu(x_g * scale_g + bias_g) * mask   (with the site's affine)
//   tf_g = x_g                                   (without)
//
// Tile (iz, iy)'s window is z in [iz sz + oz, iz sz + oz + lz), y alike
// (ops/quant.py Tiles); windows overlap where the TPU tiles'
// halos do, so a row can belong to several tiles.
//
// What bounds it on Hopper: bytes, a few f32 operations per value. With an
// affine the function needs the mask in full and the groups only where the
// mask is set (tf is +0 elsewhere: relu(.) >= 0 times a zero mask, and a
// max that starts at 0 does not move); without one, every value of every
// group. Design: a warp takes a padded (b, z, y) row and streams its
// 16-byte vectors, a lane UNROLL at a time with the next UNROLL already in
// flight (the rate of a streaming pass follows the bytes in flight).
// - With the affine the stream is the mask: each mask vector is read once
//   for all groups, and a group's vector only where some lane of that mask
//   vector is non-zero as a float (-0 counts as zero: a masked grid holds
//   x * 0), so a skipped vector is one whose values would all give
//   |tf| = 0.
// - Without it, each group's row is streamed in turn.
// A warp max per group, then the block's 8 rows are combined per tile:
// each tile whose window holds one of them gets one atomicMax of the
// largest among the block's rows in its window, on the float's bits
// (|tf| >= 0, so the integer order is the float order), into a zeroed
// [B, nz, ny, G] buffer. The int8 kernels turn amax into the scale
// themselves.
#include "common.cuh"

namespace sgnn {
namespace {

constexpr int UNROLL = 4;  // 16-byte vectors a lane reads at once

struct Window {
  int sz, oz, lz, sy, oy, ly;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The tiles whose windows hold a padded row of batch element b: [z0, z1] x
// [y0, y1] (none when z0 > z1 or y0 > y1).
struct RowTiles {
  int b, z0, z1, y0, y1;
  __device__ __forceinline__ bool live() const {
    return z0 <= z1 && y0 <= y1;
  }
  __device__ __forceinline__ bool holds(int bb, int iz, int iy) const {
    return bb == b && iz >= z0 && iz <= z1 && iy >= y0 && iy <= y1;
  }
};

__device__ __forceinline__ bool any_nonzero(const uint4& u, unsigned mag) {
  return ((u.x | u.y | u.z | u.w) & mag) != 0;
}

__device__ __forceinline__ void load_lot(uint4* v, const uint4* p, int i0,
                                         int nv) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = i0 + 32 * u;
    v[u] = i < nv ? __ldg(p + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// max |values| of a 16-byte vector of T (raw: tf = x)
template <typename T>
__device__ __forceinline__ float vec_max(const uint4& xv, float mx) {
  constexpr int E = 16 / sizeof(T);
  const T* t = reinterpret_cast<const T*>(&xv);
#pragma unroll
  for (int e = 0; e < E; ++e) mx = fmaxf(mx, fabsf(to_f(t[e])));
  return mx;
}

// max |relu(x * a + b) * m| over a 16-byte vector, at channel c0 of sc
template <typename T>
__device__ __forceinline__ float vec_max_affine(const uint4& xv,
                                                const uint4& mv,
                                                const float* sc, int c0,
                                                float mx) {
  constexpr int E = 16 / sizeof(T);
  const T* t = reinterpret_cast<const T*>(&xv);
  const T* m = reinterpret_cast<const T*>(&mv);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float v = affine_relu_mask(to_f(t[e]), sc[c0 + e],
                                     sc[MAXC + c0 + e], to_f(m[e]));
    mx = fmaxf(mx, fabsf(v));
  }
  return mx;
}

template <typename T, bool AFF>
__global__ void __launch_bounds__(THREADS)
    tile_amax_kernel(Groups xs, const T* __restrict__ mask,
                     const float* __restrict__ aff,  // [G, 2, MAXC] or null
                     float* __restrict__ out,        // [B, nz, ny, G]
                     long long nrows, int Zp, int Yp, int row, int cpad,
                     int nz, int ny, Window w) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte vector
  constexpr unsigned MAG = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  __shared__ float s_aff[MAXG * 2 * MAXC];
  __shared__ float s_max[WARPS][MAXG];
  __shared__ RowTiles s_rows[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = xs.n;
  const long long rid = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if constexpr (AFF) {
    for (int i = threadIdx.x; i < G * 2 * MAXC; i += THREADS)
      s_aff[i] = __ldg(aff + i);
  }
  RowTiles rt{0, 0, -1, 0, -1};
  if (rid < nrows) {
    const int y = static_cast<int>(rid % Yp);
    const int z = static_cast<int>(rid / Yp % Zp);
    rt.b = static_cast<int>(rid / (static_cast<long long>(Yp) * Zp));
    rt.z0 = max(floor_div(z - w.oz - w.lz + w.sz, w.sz), 0);
    rt.z1 = min(floor_div(z - w.oz, w.sz), nz - 1);
    rt.y0 = max(floor_div(y - w.oy - w.ly + w.sy, w.sy), 0);
    rt.y1 = min(floor_div(y - w.oy, w.sy), ny - 1);
  }
  if (lane == 0) s_rows[warp] = rt;
  float mx[MAXG] = {0.f, 0.f, 0.f, 0.f};
  const int nv = row / E;
  const long long base = rid * row;
  const uint4* xrow[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    xrow[g] = g < G ? reinterpret_cast<const uint4*>(
                          static_cast<const T*>(xs.p[g]) + base)
                    : nullptr;
  if constexpr (AFF) {
    __syncthreads();  // s_aff
    if (rt.live()) {
      const uint4* mrow = reinterpret_cast<const uint4*>(mask + base);
      uint4 mv[UNROLL], nx[UNROLL];
      load_lot(mv, mrow, lane, nv);
      for (int i0 = lane; i0 < nv; i0 += 32 * UNROLL) {
        load_lot(nx, mrow, i0 + 32 * UNROLL, nv);  // in flight meanwhile
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (!any_nonzero(mv[u], MAG)) continue;
          const int i = i0 + 32 * u;
          const int c0 = i * E % cpad;  // E divides cpad
          uint4 xv[MAXG];
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) xv[g] = __ldg(xrow[g] + i);
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G)
              mx[g] = vec_max_affine<T>(xv[g], mv[u], s_aff + g * 2 * MAXC,
                                        c0, mx[g]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) mv[u] = nx[u];
      }
    }
  } else if (rt.live()) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      uint4 v[UNROLL], nx[UNROLL];
      load_lot(v, xrow[g], lane, nv);
      for (int i0 = lane; i0 < nv; i0 += 32 * UNROLL) {
        load_lot(nx, xrow[g], i0 + 32 * UNROLL, nv);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) mx[g] = vec_max<T>(v[u], mx[g]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = nx[u];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
    if (lane == 0) s_max[warp][g] = mx[g];
  }
  __syncthreads();
  // each (tile, group) once per block: by the lowest of the block's rows
  // that the tile's window holds, with the largest max among the block's
  // rows in that window; a warp for its own row, a lane a tile
  if (!rt.live()) return;
  const int wy = rt.y1 - rt.y0 + 1;
  for (int q = lane; q < (rt.z1 - rt.z0 + 1) * wy; q += 32) {
    const int iz = rt.z0 + q / wy, iy = rt.y0 + q % wy;
    bool first = true;
    for (int r2 = 0; r2 < warp && first; ++r2)
      first = !s_rows[r2].holds(rt.b, iz, iy);
    if (!first) continue;
    float m[MAXG] = {0.f, 0.f, 0.f, 0.f};
    for (int r2 = warp; r2 < WARPS; ++r2) {
      if (!s_rows[r2].holds(rt.b, iz, iy)) continue;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) m[g] = fmaxf(m[g], s_max[r2][g]);
    }
    for (int g = 0; g < G; ++g) {
      if (m[g] > 0.f) {
        atomicMax(reinterpret_cast<int*>(
                      out + ((static_cast<long long>(rt.b) * nz + iz) * ny +
                             iy) * G + g),
                  __float_as_int(m[g]));
      }
    }
  }
}

template <typename T>
int launch_tile_amax(const Groups& g, const void* mask, const float* aff,
                     float* out, int B, int Zp, int Yp, int xq, int cpad,
                     int nz, int ny, const Window& w, cudaStream_t stream) {
  const long long nrows = static_cast<long long>(B) * Zp * Yp;
  const unsigned blocks = static_cast<unsigned>((nrows + WARPS - 1) / WARPS);
  if (blocks == 0) return 0;
  const T* m = static_cast<const T*>(mask);
  if (aff != nullptr) {
    tile_amax_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        g, m, aff, out, nrows, Zp, Yp, xq * LANES, cpad, nz, ny, w);
  } else {
    tile_amax_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        g, m, aff, out, nrows, Zp, Yp, xq * LANES, cpad, nz, ny, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sgnn

using namespace sgnn;

// xs: host array of G device pointers; aff null without an affine; out:
// zeroed [B, nz, ny, G] f32; window: host (sz, oz, lz, sy, oy, ly).
extern "C" int sgnn_tile_amax(const void* const* xs, int G, const void* mask,
                              const float* aff, float* out, int B, int Zp,
                              int Yp, int xq, int cpad, int nz, int ny,
                              const int* window, int bf16, void* stream) {
  if (G < 1 || G > MAXG || (cpad != 8 && cpad != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Groups g{};
  for (int i = 0; i < G; ++i) g.p[i] = xs[i];
  g.n = G;
  const Window w{window[0], window[1], window[2],
                 window[3], window[4], window[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_tile_amax<__nv_bfloat16>(g, mask, aff, out, B, Zp, Yp,
                                                xq, cpad, nz, ny, w, s)
              : launch_tile_amax<float>(g, mask, aff, out, B, Zp, Yp, xq,
                                        cpad, nz, ny, w, s);
}
