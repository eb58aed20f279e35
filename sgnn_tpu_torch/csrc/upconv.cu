// K3, the fused generative upsample-conv site.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_upconv_folded
// (:1055), body _kernel_upconv (:771); called by ops/folded.py upconv_fused
// (:691).
//
//   out[f] = round(fmask[f] * sum_g conv3(nn_up2(in_g'))[f])
//   in_g'  = round(relu(in_g * scale_g + bias_g) * cmask)   (affine)
//
// computed straight from the coarse grids: along each axis fine f = 2q + p
// reads coarse q + p - 1 + e (e in {0, 1}), so a fine voxel has 8 coarse
// taps whose weights are the parity's sums of the 27 original taps
// (summed in f32, then rounded: the prepared [G, 8 parity, 8 tap] array,
// the same combination as _fold_upsample_weights:732). Taps that fall on
// the coarse z/y ring read its zeros; x taps outside [0, Xsc) are skipped.
// The fine mask is read from fmask, or expanded from the coarse mask when
// fmask is null (the serving case: no fine mask exists in memory).
//
// What bounds it on Hopper: 8 * G * cin * cout MACs per active fine voxel
// and one write of the fine grid (8x the coarse bytes); the coarse inputs
// are small and stay in L2. Design: one thread per fine voxel with all
// output channels in registers; inactive fine voxels (one mask read)
// write zeros and stop.
//
// K3q, the int8 mode (quantize=True, _kernel_upconv :868-923), in the same
// design: the fine voxel reads its TPU tile's amax per group (tile
// (iz, iy) holds fine interior rows [iz tz, (iz + 1) tz) x [iy ty,
// (iy + 1) ty); its window is the coarse halo'd rows under them),
// quantizes each coarse tap's f32 input on the fly, sums int8 products in
// int32 with __dp4a against int8 weights [G, 8 parity, 8 tap, co, ci],
// and dequantizes per group with the scale of its fine x parity px,
// acc += f32(iacc) * (s * ws[g, px, co]), before the fine mask.
#include "common.cuh"

namespace sgnn {

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    upconv_kernel(Groups xs, const T* __restrict__ cmask,
                  const T* __restrict__ fmask,  // null: expand cmask
                  const float* __restrict__ w,  // [G, 8, 8, MAXC, MAXC]
                  const float* __restrict__ aff,  // [G, 2, MAXC] or null
                  T* __restrict__ out, int B, int Zfp, int Yfp,
                  int Xsf, int Zcp, int Ycp, int Xsc) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zfp * Yfp * Xsf) return;
  const Voxel v = decode(idx, Zfp, Yfp, Xsf);
  T* o = out + idx * CPAD;
  if (v.z == 0 || v.z == Zfp - 1 || v.y == 0 || v.y == Yfp - 1) {
    store_zero<T, CPAD>(o);
    return;
  }
  const int qz = v.z - 1, qy = v.y - 1;  // fine interior coordinates
  float m;
  if (fmask != nullptr) {
    m = to_f(fmask[idx * CPAD]);
  } else {
    const int cx = v.x >> 1;
    m = cx < Xsc ? to_f(cmask[voxel_index(v.b, (qz >> 1) + 1, (qy >> 1) + 1,
                                          cx, Zcp, Ycp, Xsc) * CPAD])
                 : 0.f;
  }
  if (m == 0.f) {
    store_zero<T, CPAD>(o);
    return;
  }
  const int pz = qz & 1, py = qy & 1, px = v.x & 1;
  const int par = (pz * 2 + py) * 2 + px;
  float acc[CPAD];
#pragma unroll
  for (int c = 0; c < CPAD; ++c) acc[c] = 0.f;
  for (int g = 0; g < xs.n; ++g) {
    const T* __restrict__ xg = static_cast<const T*>(xs.p[g]);
    const int cin = xs.cin[g];
    const float* sc = aff != nullptr ? aff + g * 2 * MAXC : nullptr;
    for (int e = 0; e < 8; ++e) {  // e = (ez * 2 + ey) * 2 + ex
      const int ez = e >> 2, ey = (e >> 1) & 1, ex = e & 1;
      const int cx = (v.x >> 1) + px - 1 + ex;
      if (cx < 0 || cx >= Xsc) continue;
      // coarse halo index of interior (q >> 1) + p - 1 + e
      const long long nv = voxel_index(v.b, (qz >> 1) + pz + ez,
                                       (qy >> 1) + py + ey, cx, Zcp, Ycp,
                                       Xsc) * CPAD;
      float mi = 1.f;
      if (sc != nullptr) {
        mi = to_f(cmask[nv]);
        if (mi == 0.f) continue;
      }
      const float* wt = w + (((g * 8 + par) * 8 + e) * MAXC) * MAXC;
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
#pragma unroll
  for (int c = 0; c < CPAD; ++c) o[c] = from_f<T>(acc[c] * m);
}

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    upconv_q_kernel(Groups xs, const T* __restrict__ cmask,
                    const T* __restrict__ fmask,  // null: expand cmask
                    const int4* __restrict__ wq,  // [G, 8, 8, MAXC] x 16
                    const float* __restrict__ ws,   // [G, 2, MAXC]
                    const float* __restrict__ aff,  // [G, 2, MAXC] or null
                    const float* __restrict__ amax,  // [B, nz, ny, G]
                    T* __restrict__ out, int B, int Zfp, int Yfp, int Xsf,
                    int Zcp, int Ycp, int Xsc, int tz, int ty, int nz,
                    int ny) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zfp * Yfp * Xsf) return;
  const Voxel v = decode(idx, Zfp, Yfp, Xsf);
  T* o = out + idx * CPAD;
  if (v.z == 0 || v.z == Zfp - 1 || v.y == 0 || v.y == Yfp - 1) {
    store_zero<T, CPAD>(o);
    return;
  }
  const int qz = v.z - 1, qy = v.y - 1;  // fine interior coordinates
  float m;
  if (fmask != nullptr) {
    m = to_f(fmask[idx * CPAD]);
  } else {
    const int cx = v.x >> 1;
    m = cx < Xsc ? to_f(cmask[voxel_index(v.b, (qz >> 1) + 1, (qy >> 1) + 1,
                                          cx, Zcp, Ycp, Xsc) * CPAD])
                 : 0.f;
  }
  if (m == 0.f) {
    store_zero<T, CPAD>(o);
    return;
  }
  const int pz = qz & 1, py = qy & 1, px = v.x & 1;
  const int par = (pz * 2 + py) * 2 + px;
  const float* am = amax + ((static_cast<long long>(v.b) * nz + qz / tz) *
                                ny + qy / ty) * xs.n;
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
    for (int e = 0; e < 8; ++e) {  // e = (ez * 2 + ey) * 2 + ex
      const int ez = e >> 2, ey = (e >> 1) & 1, ex = e & 1;
      const int cx = (v.x >> 1) + px - 1 + ex;
      if (cx < 0 || cx >= Xsc) continue;
      const long long nv = voxel_index(v.b, (qz >> 1) + pz + ez,
                                       (qy >> 1) + py + ey, cx, Zcp, Ycp,
                                       Xsc) * CPAD;
      float mi = 1.f;
      if (sc != nullptr) {
        mi = to_f(cmask[nv]);
        if (mi == 0.f) continue;
      }
      int words[CPAD / 4];
      if (!quantize_voxel<T, CPAD>(xg + nv, cin, sc, mi, inv, words))
        continue;
      dp4a_voxel<CPAD, CPAD>(iacc, words,
                             wq + ((g * 8 + par) * 8 + e) * MAXC);
    }
    dequant_add<CPAD>(acc, iacc, s, ws + (g * 2 + px) * MAXC);
  }
#pragma unroll
  for (int c = 0; c < CPAD; ++c) o[c] = from_f<T>(acc[c] * m);
}

template <typename T, int CPAD>
static int launch_upconv_q(const Groups& g, const void* cmask,
                           const void* fmask, const void* wq,
                           const float* ws, const float* aff,
                           const float* amax, void* out, int B, int Zcp,
                           int Ycp, int xqc, int xqf, int tz, int ty, int nz,
                           int ny, cudaStream_t stream) {
  const int F = LANES / CPAD;
  const int Zfp = 2 * (Zcp - 2) + 2;
  const int Yfp = 2 * (Ycp - 2) + 2;
  const int Xsf = xqf * F;
  const long long n = static_cast<long long>(B) * Zfp * Yfp * Xsf;
  upconv_q_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(cmask), static_cast<const T*>(fmask),
      static_cast<const int4*>(wq), ws, aff, amax, static_cast<T*>(out), B,
      Zfp, Yfp, Xsf, Zcp, Ycp, xqc * F, tz, ty, nz, ny);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPAD>
static int launch_upconv(const Groups& g, const void* cmask,
                         const void* fmask, const float* w, const float* aff,
                         void* out, int B, int Zcp, int Ycp,
                         int xqc, int xqf, cudaStream_t stream) {
  const int F = LANES / CPAD;
  const int Zfp = 2 * (Zcp - 2) + 2;
  const int Yfp = 2 * (Ycp - 2) + 2;
  const int Xsf = xqf * F;
  const long long n = static_cast<long long>(B) * Zfp * Yfp * Xsf;
  upconv_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(cmask), static_cast<const T*>(fmask), w, aff,
      static_cast<T*>(out), B, Zfp, Yfp, Xsf, Zcp, Ycp, xqc * F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// xs / cins: host arrays of G coarse device pointers and input widths.
// fmask, aff: null when absent.
extern "C" int sgnn_upconv(const void* const* xs, const int* cins, int G,
                           const void* cmask, const void* fmask,
                           const float* w, const float* aff,
                           void* out, int B, int Zcp, int Ycp, int xqc,
                           int xqf, int cpad, int bf16, void* stream) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  Groups g{};
  for (int i = 0; i < G; ++i) {
    g.p[i] = xs[i];
    g.cin[i] = cins[i];
  }
  g.n = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_upconv<__nv_bfloat16, 8>(g, cmask, fmask, w, aff,
                                                  out, B, Zcp, Ycp,
                                                  xqc, xqf, s)
                : launch_upconv<float, 8>(g, cmask, fmask, w, aff, out,
                                          B, Zcp, Ycp, xqc, xqf, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_upconv<__nv_bfloat16, 16>(g, cmask, fmask, w, aff,
                                                   out, B, Zcp, Ycp,
                                                   xqc, xqf, s)
                : launch_upconv<float, 16>(g, cmask, fmask, w, aff,
                                           out, B, Zcp, Ycp, xqc, xqf, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 mode: wq int8 [G, 8, 8, 16, 16] (co, ci), ws [G, 2, 16], amax
// [B, nz, ny, G] from sgnn_tile_amax, (tz, ty) the TPU tile in fine rows.
extern "C" int sgnn_upconv_q(const void* const* xs, const int* cins, int G,
                             const void* cmask, const void* fmask,
                             const void* wq, const float* ws,
                             const float* aff, const float* amax, void* out,
                             int B, int Zcp, int Ycp, int xqc, int xqf,
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
    return bf16 ? launch_upconv_q<__nv_bfloat16, 8>(
                      g, cmask, fmask, wq, ws, aff, amax, out, B, Zcp, Ycp,
                      xqc, xqf, tz, ty, nz, ny, s)
                : launch_upconv_q<float, 8>(g, cmask, fmask, wq, ws, aff,
                                            amax, out, B, Zcp, Ycp, xqc, xqf,
                                            tz, ty, nz, ny, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_upconv_q<__nv_bfloat16, 16>(
                      g, cmask, fmask, wq, ws, aff, amax, out, B, Zcp, Ycp,
                      xqc, xqf, tz, ty, nz, ny, s)
                : launch_upconv_q<float, 16>(g, cmask, fmask, wq, ws, aff,
                                             amax, out, B, Zcp, Ycp, xqc,
                                             xqf, tz, ty, nz, ny, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
