// K1, the fused 3^3 submanifold conv site.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_conv_folded (:593),
// body _kernel_fused (:319); called by ops/folded.py subm_conv_fused (:631).
//
//   out[v] = round(mask[v] * sum_g sum_taps sum_ci in_g'[v + tap][ci] *
//                  W_g[tap][ci][:]) (+ residual[v], in the compute type)
//   in_g'  = round(relu(in_g * scale_g + bias_g) * mask)   (with an affine)
//
// What bounds it on Hopper: the site is 27 * cin * cout MACs per active
// voxel over grids of a few hundred MB; most voxels of a scene are
// inactive (the mask is ~2-10% dense at full resolution), so the work
// that matters is the active voxels' FMAs and the read of every voxel's
// mask. Design: one thread per output voxel holding all cpad output
// channels in registers; a voxel whose mask is zero writes zeros (or the
// residual) after one mask read and does nothing else, an active voxel
// runs the taps with the weights read as uniform float4 loads (one
// broadcast per warp). Neighbour reads of a warp are 32 consecutive x
// slots, so they coalesce. Tensor cores, shared-memory tiles and TMA are
// left to a later version.
//
// K1q, the int8 mode (quantize=True, _kernel_fused :413-451), in the same
// design: the thread reads its TPU tile's amax per group (tile (iz, iy)
// holds interior rows [iz tz, (iz + 1) tz) x [iy ty, (iy + 1) ty)), turns
// it into s and 1 / s, quantizes each neighbour's f32 input (the
// affine's value before any rounding to the compute type) on the fly,
// sums int8 products in int32 with __dp4a against int8 weights
// [G, 27, co, ci], and dequantizes per group, acc += f32(iacc) *
// (s * ws[g, co]), before the mask. Bound: the same bytes as K1, and
// 27 * cin * cout int8 MACs per active voxel (int8 tensor-core rate).
#include "common.cuh"

namespace sgnn {

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    conv_site_kernel(Groups xs, const T* __restrict__ mask,
                     const T* __restrict__ resid,
                     const float* __restrict__ w,    // [G, 27, MAXC, MAXC]
                     const float* __restrict__ aff,  // [G, 2, MAXC] or null
                     T* __restrict__ out, int B, int Zp, int Yp,
                     int Xs) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zp * Yp * Xs) return;
  const Voxel v = decode(idx, Zp, Yp, Xs);
  T* o = out + idx * CPAD;
  const bool ring = v.z == 0 || v.z == Zp - 1 || v.y == 0 || v.y == Yp - 1;
  const float m = ring ? 0.f : to_f(mask[idx * CPAD]);
  if (m == 0.f) {
    // masked output is zero; the residual is added after the mask
    if (resid != nullptr && !ring) {
#pragma unroll
      for (int c = 0; c < CPAD; ++c) o[c] = resid[idx * CPAD + c];
    } else {
      store_zero<T, CPAD>(o);
    }
    return;
  }
  float acc[CPAD];
#pragma unroll
  for (int c = 0; c < CPAD; ++c) acc[c] = 0.f;
  for (int g = 0; g < xs.n; ++g) {
    const T* __restrict__ xg = static_cast<const T*>(xs.p[g]);
    const int cin = xs.cin[g];
    const float* sc = aff != nullptr ? aff + g * 2 * MAXC : nullptr;
    for (int dz = 0; dz < 3; ++dz) {
      for (int dy = 0; dy < 3; ++dy) {
        const long long row =
            voxel_index(v.b, v.z + dz - 1, v.y + dy - 1, 0, Zp, Yp, Xs);
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = v.x + dx - 1;
          if (xx < 0 || xx >= Xs) continue;
          const long long nv = (row + xx) * CPAD;
          float mi = 1.f;
          if (sc != nullptr) {
            mi = to_f(mask[nv]);
            if (mi == 0.f) continue;  // relu(.) * 0 contributes nothing
          }
          const float* wt = w + ((g * 27 + (dz * 3 + dy) * 3 + dx) * MAXC) * MAXC;
          for (int ci = 0; ci < cin; ++ci) {
            float a = to_f(xg[nv + ci]);
            if (sc != nullptr) {
              a = round_to<T>(
                  affine_relu_mask(a, sc[ci], sc[MAXC + ci], mi));
            }
            axpy<CPAD>(acc, a, wt + ci * MAXC);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPAD; ++c) {
    T r = from_f<T>(acc[c] * m);
    if (resid != nullptr) r = from_f<T>(to_f(r) + to_f(resid[idx * CPAD + c]));
    o[c] = r;
  }
}

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    conv_site_q_kernel(Groups xs, const T* __restrict__ mask,
                       const T* __restrict__ resid,
                       const int4* __restrict__ wq,    // [G, 27, MAXC] x 16
                       const float* __restrict__ ws,   // [G, MAXC]
                       const float* __restrict__ aff,  // [G, 2, MAXC] or null
                       const float* __restrict__ amax,  // [B, nz, ny, G]
                       T* __restrict__ out, int B, int Zp, int Yp, int Xs,
                       int tz, int ty, int nz, int ny) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zp * Yp * Xs) return;
  const Voxel v = decode(idx, Zp, Yp, Xs);
  T* o = out + idx * CPAD;
  const bool ring = v.z == 0 || v.z == Zp - 1 || v.y == 0 || v.y == Yp - 1;
  const float m = ring ? 0.f : to_f(mask[idx * CPAD]);
  if (m == 0.f) {
    if (resid != nullptr && !ring) {
#pragma unroll
      for (int c = 0; c < CPAD; ++c) o[c] = resid[idx * CPAD + c];
    } else {
      store_zero<T, CPAD>(o);
    }
    return;
  }
  const float* am =
      amax + ((static_cast<long long>(v.b) * nz + (v.z - 1) / tz) * ny +
              (v.y - 1) / ty) * xs.n;
  float acc[CPAD];
#pragma unroll
  for (int c = 0; c < CPAD; ++c) acc[c] = 0.f;
  for (int g = 0; g < xs.n; ++g) {
    const T* __restrict__ xg = static_cast<const T*>(xs.p[g]);
    const int cin = xs.cin[g];
    const float* sc = aff != nullptr ? aff + g * 2 * MAXC : nullptr;
    const float s = tile_scale(am[g]);
    const float inv = 1.0f / s;
    int iacc[CPAD];
#pragma unroll
    for (int c = 0; c < CPAD; ++c) iacc[c] = 0;
    for (int dz = 0; dz < 3; ++dz) {
      for (int dy = 0; dy < 3; ++dy) {
        const long long row =
            voxel_index(v.b, v.z + dz - 1, v.y + dy - 1, 0, Zp, Yp, Xs);
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = v.x + dx - 1;
          if (xx < 0 || xx >= Xs) continue;
          const long long nv = (row + xx) * CPAD;
          float mi = 1.f;
          if (sc != nullptr) {
            mi = to_f(mask[nv]);
            if (mi == 0.f) continue;  // relu(.) * 0 quantizes to 0
          }
          int words[CPAD / 4];
          if (!quantize_voxel<T, CPAD>(xg + nv, cin, sc, mi, inv, words))
            continue;
          dp4a_voxel<CPAD, CPAD>(
              iacc, words, wq + (g * 27 + (dz * 3 + dy) * 3 + dx) * MAXC);
        }
      }
    }
    dequant_add<CPAD>(acc, iacc, s, ws + g * MAXC);
  }
#pragma unroll
  for (int c = 0; c < CPAD; ++c) {
    T r = from_f<T>(acc[c] * m);
    if (resid != nullptr) r = from_f<T>(to_f(r) + to_f(resid[idx * CPAD + c]));
    o[c] = r;
  }
}

template <typename T, int CPAD>
static int launch_conv_site_q(const Groups& g, const void* mask,
                              const void* resid, const void* wq,
                              const float* ws, const float* aff,
                              const float* amax, void* out, int B, int Zp,
                              int Yp, int xq, int tz, int ty, int nz, int ny,
                              cudaStream_t stream) {
  const int Xs = xq * (LANES / CPAD);
  const long long n = static_cast<long long>(B) * Zp * Yp * Xs;
  conv_site_q_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), static_cast<const T*>(resid),
      static_cast<const int4*>(wq), ws, aff, amax, static_cast<T*>(out), B,
      Zp, Yp, Xs, tz, ty, nz, ny);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPAD>
static int launch_conv_site(const Groups& g, const void* mask,
                            const void* resid, const float* w,
                            const float* aff, void* out, int B,
                            int Zp, int Yp, int xq, cudaStream_t stream) {
  const int Xs = xq * (LANES / CPAD);
  const long long n = static_cast<long long>(B) * Zp * Yp * Xs;
  conv_site_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), static_cast<const T*>(resid), w, aff,
      static_cast<T*>(out), B, Zp, Yp, Xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// xs / cins: host arrays of G device pointers and input widths.
// resid, aff: null when absent. bf16: 1 for bfloat16 grids, 0 for float32.
extern "C" int sgnn_conv_site(const void* const* xs, const int* cins, int G,
                              const void* mask, const void* resid,
                              const float* w, const float* aff,
                              void* out, int B, int Zp, int Yp, int xq,
                              int cpad, int bf16, void* stream) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  Groups g{};
  for (int i = 0; i < G; ++i) {
    g.p[i] = xs[i];
    g.cin[i] = cins[i];
  }
  g.n = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_conv_site<__nv_bfloat16, 8>(g, mask, resid, w, aff,
                                                     out, B, Zp, Yp, xq, s)
                : launch_conv_site<float, 8>(g, mask, resid, w, aff,
                                             out, B, Zp, Yp, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_conv_site<__nv_bfloat16, 16>(
                      g, mask, resid, w, aff, out, B, Zp, Yp, xq, s)
                : launch_conv_site<float, 16>(g, mask, resid, w, aff,
                                              out, B, Zp, Yp, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 mode: wq int8 [G, 27, 16, 16] (co, ci), ws [G, 16], amax
// [B, nz, ny, G] from sgnn_tile_amax, (tz, ty) the TPU tile.
extern "C" int sgnn_conv_site_q(const void* const* xs, const int* cins,
                                int G, const void* mask, const void* resid,
                                const void* wq, const float* ws,
                                const float* aff, const float* amax,
                                void* out, int B, int Zp, int Yp, int xq,
                                int cpad, int tz, int ty, int nz, int ny,
                                int bf16, void* stream) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  Groups g{};
  for (int i = 0; i < G; ++i) {
    g.p[i] = xs[i];
    g.cin[i] = cins[i];
  }
  g.n = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_conv_site_q<__nv_bfloat16, 8>(
                      g, mask, resid, wq, ws, aff, amax, out, B, Zp, Yp, xq,
                      tz, ty, nz, ny, s)
                : launch_conv_site_q<float, 8>(g, mask, resid, wq, ws, aff,
                                               amax, out, B, Zp, Yp, xq, tz,
                                               ty, nz, ny, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_conv_site_q<__nv_bfloat16, 16>(
                      g, mask, resid, wq, ws, aff, amax, out, B, Zp, Yp, xq,
                      tz, ty, nz, ny, s)
                : launch_conv_site_q<float, 16>(g, mask, resid, wq, ws, aff,
                                                amax, out, B, Zp, Yp, xq, tz,
                                                ty, nz, ny, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
