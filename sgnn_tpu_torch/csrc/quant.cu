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
// What bounds it on Hopper: bytes, a few f32 operations per value. The
// function needs each input grid in full without an affine; with one, the
// mask and the grids only where the mask is set (tf is 0 elsewhere), but
// this design reads every value of the grids all the same. Design:
// one warp per padded (b, z, y) row, 16-byte loads of consecutive lanes,
// a warp max per group, and one atomicMax per tile whose window holds the
// row on the float's bits (|tf| >= 0, so the integer order is the float
// order) into a zeroed [B, nz, ny, G] buffer. The int8 kernels turn amax
// into the scale themselves.
#include "common.cuh"

namespace sgnn {

struct Window {
  int sz, oz, lz, sy, oy, ly;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    tile_amax_kernel(Groups xs, const T* __restrict__ mask,
                     const float* __restrict__ aff,  // [G, 2, MAXC] or null
                     float* __restrict__ out,        // [B, nz, ny, G]
                     int B, int Zp, int Yp, int row, int cpad, int nz,
                     int ny, Window w) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(B) * Zp * Yp) return;
  const int y = static_cast<int>(warp % Yp);
  const int z = static_cast<int>((warp / Yp) % Zp);
  const int b = static_cast<int>(warp / (static_cast<long long>(Yp) * Zp));
  // the tiles whose windows hold row (z, y)
  const int z0 = max(floor_div(z - w.oz - w.lz + w.sz, w.sz), 0);
  const int z1 = min(floor_div(z - w.oz, w.sz), nz - 1);
  const int y0 = max(floor_div(y - w.oy - w.ly + w.sy, w.sy), 0);
  const int y1 = min(floor_div(y - w.oy, w.sy), ny - 1);
  if (z0 > z1 || y0 > y1) return;
  constexpr int E = 16 / sizeof(T);  // values per 16-byte vector
  const long long base = (static_cast<long long>(b * Zp + z) * Yp + y) * row;
  const uint4* mrow = reinterpret_cast<const uint4*>(mask + base);
  for (int g = 0; g < xs.n; ++g) {
    const uint4* xrow =
        reinterpret_cast<const uint4*>(static_cast<const T*>(xs.p[g]) + base);
    const float* sc = aff != nullptr ? aff + g * 2 * MAXC : nullptr;
    float mx = 0.f;
    for (int i = lane; i < row / E; i += 32) {
      const uint4 u = __ldg(xrow + i);
      const T* t = reinterpret_cast<const T*>(&u);
      if (sc != nullptr) {
        const uint4 mu = __ldg(mrow + i);
        const T* m = reinterpret_cast<const T*>(&mu);
        const int c0 = (i * E) % cpad;  // E divides cpad
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float v = affine_relu_mask(to_f(t[e]), sc[c0 + e],
                                           sc[MAXC + c0 + e], to_f(m[e]));
          mx = fmaxf(mx, fabsf(v));
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) mx = fmaxf(mx, fabsf(to_f(t[e])));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0 && mx > 0.f) {
      for (int iz = z0; iz <= z1; ++iz) {
        for (int iy = y0; iy <= y1; ++iy) {
          atomicMax(reinterpret_cast<int*>(
                        out + ((static_cast<long long>(b) * nz + iz) * ny +
                               iy) * xs.n + g),
                    __float_as_int(mx));
        }
      }
    }
  }
}

template <typename T>
static int launch_tile_amax(const Groups& g, const void* mask,
                            const float* aff, float* out, int B, int Zp,
                            int Yp, int xq, int cpad, int nz, int ny,
                            const Window& w, cudaStream_t stream) {
  const long long threads = static_cast<long long>(B) * Zp * Yp * 32;
  tile_amax_kernel<T><<<blocks_for(threads), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), aff, out, B, Zp, Yp, xq * LANES, cpad,
      nz, ny, w);
  return static_cast<int>(cudaGetLastError());
}

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
