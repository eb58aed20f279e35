// K2, the fused stride-2 down site.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_downconv_folded
// (:1375), body _kernel_downconv (:1158); called by ops/folded.py
// downconv_fused (:758).
//
//   coarse mask[c] = any(fine mask over the 2^3 children of c)
//   out[c]         = round(coarse mask[c] * sum_taps sum_ci in'[2c + tap][ci]
//                          * W[tap][ci][:])
//   in'            = round(relu(in * scale + bias) * fine mask)  (affine)
//
// with both outputs halo'd and zero on the ring. Cross mode reads a cpad-8
// fine grid and writes cpad-16 coarse grids (the encoder's level-0 exit).
//
// What bounds it on Hopper: every fine voxel's mask is read once (8 per
// coarse voxel) and 8 * cin * cout MACs run per active coarse voxel; the
// fine grid is read once and the two coarse grids (1/8 its voxels) are
// written once, so it is a bandwidth-bound pass. Design: one thread per
// coarse voxel with all output channels in registers; the 8 mask reads
// come first and an inactive coarse voxel writes zeros and stops.
//
// K2q, the int8 mode (quantize=True, _kernel_downconv :1228-1264), in the
// same design: the coarse voxel reads its TPU tile's amax (tile (iz, iy)
// holds coarse interior rows [iz tz, (iz + 1) tz) x [iy ty, (iy + 1) ty);
// its window is their fine children, no halo), quantizes each fine
// child's f32 input on the fly, sums int8 products in int32 with __dp4a
// against int8 weights [8, co, ci], and writes f32(iacc) * (s * ws[co])
// times the coarse mask; the coarse mask is the exact mode's.
#include "common.cuh"

namespace sgnn {

template <typename T, int CI, int CO>
__global__ void __launch_bounds__(THREADS)
    downconv_kernel(const T* __restrict__ x, const T* __restrict__ fmask,
                    const float* __restrict__ w,    // [8, MAXC, MAXC]
                    const float* __restrict__ aff,  // [2, MAXC] or null
                    int cin, T* __restrict__ out,
                    T* __restrict__ mout, int B, int Zcp, int Ycp, int Xsc,
                    int Zfp, int Yfp, int Xsf) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zcp * Ycp * Xsc) return;
  const Voxel v = decode(idx, Zcp, Ycp, Xsc);
  T* o = out + idx * CO;
  T* mo = mout + idx * CO;
  if (v.z == 0 || v.z == Zcp - 1 || v.y == 0 || v.y == Ycp - 1) {
    store_zero<T, CO>(o);
    store_zero<T, CO>(mo);
    return;
  }
  // fine halo index of child (d) of coarse halo index c: 2 (c - 1) + d + 1
  float mc = 0.f;
  for (int t = 0; t < 8; ++t) {
    const int xf = 2 * v.x + (t & 1);
    if (xf >= Xsf) continue;
    const long long nv = voxel_index(v.b, 2 * v.z - 1 + (t >> 2),
                                     2 * v.y - 1 + ((t >> 1) & 1), xf, Zfp,
                                     Yfp, Xsf);
    mc = fmaxf(mc, to_f(fmask[nv * CI]));
  }
  if (mc == 0.f) {
    store_zero<T, CO>(o);
    store_zero<T, CO>(mo);
    return;
  }
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
  for (int t = 0; t < 8; ++t) {  // tap = dz * 4 + dy * 2 + dx
    const int xf = 2 * v.x + (t & 1);
    if (xf >= Xsf) continue;
    const long long nv = voxel_index(v.b, 2 * v.z - 1 + (t >> 2),
                                     2 * v.y - 1 + ((t >> 1) & 1), xf, Zfp,
                                     Yfp, Xsf) * CI;
    float mi = 1.f;
    if (aff != nullptr) {
      mi = to_f(fmask[nv]);
      if (mi == 0.f) continue;
    }
    const float* wt = w + t * MAXC * MAXC;
    for (int ci = 0; ci < cin; ++ci) {
      float a = to_f(x[nv + ci]);
      if (aff != nullptr) {
        a = round_to<T>(affine_relu_mask(a, aff[ci], aff[MAXC + ci], mi));
      }
      axpy<CO>(acc, a, wt + ci * MAXC);
    }
  }
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    o[c] = from_f<T>(acc[c]);
    mo[c] = from_f<T>(1.f);
  }
}

template <typename T, int CI, int CO>
__global__ void __launch_bounds__(THREADS)
    downconv_q_kernel(const T* __restrict__ x, const T* __restrict__ fmask,
                      const int4* __restrict__ wq,    // [8, MAXC] x 16
                      const float* __restrict__ ws,   // [MAXC]
                      const float* __restrict__ aff,  // [2, MAXC] or null
                      const float* __restrict__ amax,  // [B, nz, ny]
                      int cin, T* __restrict__ out, T* __restrict__ mout,
                      int B, int Zcp, int Ycp, int Xsc, int Zfp, int Yfp,
                      int Xsf, int tz, int ty, int nz, int ny) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zcp * Ycp * Xsc) return;
  const Voxel v = decode(idx, Zcp, Ycp, Xsc);
  T* o = out + idx * CO;
  T* mo = mout + idx * CO;
  if (v.z == 0 || v.z == Zcp - 1 || v.y == 0 || v.y == Ycp - 1) {
    store_zero<T, CO>(o);
    store_zero<T, CO>(mo);
    return;
  }
  float mc = 0.f;
  for (int t = 0; t < 8; ++t) {
    const int xf = 2 * v.x + (t & 1);
    if (xf >= Xsf) continue;
    const long long nv = voxel_index(v.b, 2 * v.z - 1 + (t >> 2),
                                     2 * v.y - 1 + ((t >> 1) & 1), xf, Zfp,
                                     Yfp, Xsf);
    mc = fmaxf(mc, to_f(fmask[nv * CI]));
  }
  if (mc == 0.f) {
    store_zero<T, CO>(o);
    store_zero<T, CO>(mo);
    return;
  }
  const float s = tile_scale(
      amax[(static_cast<long long>(v.b) * nz + (v.z - 1) / tz) * ny +
           (v.y - 1) / ty]);
  const float inv = 1.0f / s;
  int iacc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) iacc[c] = 0;
  for (int t = 0; t < 8; ++t) {  // tap = dz * 4 + dy * 2 + dx
    const int xf = 2 * v.x + (t & 1);
    if (xf >= Xsf) continue;
    const long long nv = voxel_index(v.b, 2 * v.z - 1 + (t >> 2),
                                     2 * v.y - 1 + ((t >> 1) & 1), xf, Zfp,
                                     Yfp, Xsf) * CI;
    float mi = 1.f;
    if (aff != nullptr) {
      mi = to_f(fmask[nv]);
      if (mi == 0.f) continue;
    }
    int words[CI / 4];
    if (!quantize_voxel<T, CI>(x + nv, cin, aff, mi, inv, words)) continue;
    dp4a_voxel<CI, CO>(iacc, words, wq + t * MAXC);
  }
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    const float a = __fmul_rn(static_cast<float>(iacc[c]),
                              __fmul_rn(s, __ldg(ws + c)));
    o[c] = from_f<T>(a * mc);
    mo[c] = from_f<T>(1.f);
  }
}

template <typename T, int CI, int CO>
static int launch_downconv_q(const void* x, const void* fmask,
                             const void* wq, const float* ws,
                             const float* aff, const float* amax, int cin,
                             void* out, void* mout, int B, int Zfp, int Yfp,
                             int xqf, int xqc, int tz, int ty, int nz, int ny,
                             cudaStream_t stream) {
  const int Zcp = (Zfp - 2) / 2 + 2;
  const int Ycp = (Yfp - 2) / 2 + 2;
  const int Xsf = xqf * (LANES / CI);
  const int Xsc = xqc * (LANES / CO);
  const long long n = static_cast<long long>(B) * Zcp * Ycp * Xsc;
  downconv_q_kernel<T, CI, CO><<<blocks_for(n), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(fmask),
      static_cast<const int4*>(wq), ws, aff, amax, cin, static_cast<T*>(out),
      static_cast<T*>(mout), B, Zcp, Ycp, Xsc, Zfp, Yfp, Xsf, tz, ty, nz,
      ny);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_downconv_q(int cpad, int cpad_out, const void* x,
                               const void* fmask, const void* wq,
                               const float* ws, const float* aff,
                               const float* amax, int cin, void* out,
                               void* mout, int B, int Zfp, int Yfp, int xqf,
                               int xqc, int tz, int ty, int nz, int ny,
                               cudaStream_t s) {
  if (cpad == 8 && cpad_out == 8)
    return launch_downconv_q<T, 8, 8>(x, fmask, wq, ws, aff, amax, cin, out,
                                      mout, B, Zfp, Yfp, xqf, xqc, tz, ty,
                                      nz, ny, s);
  if (cpad == 8 && cpad_out == 16)
    return launch_downconv_q<T, 8, 16>(x, fmask, wq, ws, aff, amax, cin, out,
                                       mout, B, Zfp, Yfp, xqf, xqc, tz, ty,
                                       nz, ny, s);
  if (cpad == 16 && cpad_out == 16)
    return launch_downconv_q<T, 16, 16>(x, fmask, wq, ws, aff, amax, cin,
                                        out, mout, B, Zfp, Yfp, xqf, xqc, tz,
                                        ty, nz, ny, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int CI, int CO>
static int launch_downconv(const void* x, const void* fmask, const float* w,
                           const float* aff, int cin, void* out,
                           void* mout, int B, int Zfp, int Yfp, int xqf,
                           int xqc, cudaStream_t stream) {
  const int Zcp = (Zfp - 2) / 2 + 2;
  const int Ycp = (Yfp - 2) / 2 + 2;
  const int Xsf = xqf * (LANES / CI);
  const int Xsc = xqc * (LANES / CO);
  const long long n = static_cast<long long>(B) * Zcp * Ycp * Xsc;
  downconv_kernel<T, CI, CO><<<blocks_for(n), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(fmask), w, aff,
      cin, static_cast<T*>(out), static_cast<T*>(mout), B, Zcp, Ycp, Xsc,
      Zfp, Yfp, Xsf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_downconv(int cpad, int cpad_out, const void* x,
                             const void* fmask, const float* w,
                             const float* aff, int cin, void* out,
                             void* mout, int B, int Zfp, int Yfp, int xqf,
                             int xqc, cudaStream_t s) {
  if (cpad == 8 && cpad_out == 8)
    return launch_downconv<T, 8, 8>(x, fmask, w, aff, cin, out, mout,
                                    B, Zfp, Yfp, xqf, xqc, s);
  if (cpad == 8 && cpad_out == 16)
    return launch_downconv<T, 8, 16>(x, fmask, w, aff, cin, out, mout,
                                     B, Zfp, Yfp, xqf, xqc, s);
  if (cpad == 16 && cpad_out == 16)
    return launch_downconv<T, 16, 16>(x, fmask, w, aff, cin, out, mout,
                                      B, Zfp, Yfp, xqf, xqc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sgnn

using namespace sgnn;

// aff: null when absent. xqc: coarse x-block count, chosen by the wrapper.
extern "C" int sgnn_downconv(const void* x, const void* fmask, const float* w,
                             const float* aff, int cin, void* out,
                             void* mout, int B, int Zfp, int Yfp, int xqf,
                             int xqc, int cpad, int cpad_out, int bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_downconv<__nv_bfloat16>(cpad, cpad_out, x, fmask, w,
                                                 aff, cin, out, mout, B,
                                                 Zfp, Yfp, xqf, xqc, s)
              : dispatch_downconv<float>(cpad, cpad_out, x, fmask, w, aff,
                                         cin, out, mout, B, Zfp, Yfp,
                                         xqf, xqc, s);
}

// The int8 mode: wq int8 [8, 16, 16] (co, ci), ws [16], amax [B, nz, ny]
// from sgnn_tile_amax, (tz, ty) the TPU tile in coarse rows.
extern "C" int sgnn_downconv_q(const void* x, const void* fmask,
                               const void* wq, const float* ws,
                               const float* aff, const float* amax, int cin,
                               void* out, void* mout, int B, int Zfp,
                               int Yfp, int xqf, int xqc, int cpad,
                               int cpad_out, int tz, int ty, int nz, int ny,
                               int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_downconv_q<__nv_bfloat16>(
                    cpad, cpad_out, x, fmask, wq, ws, aff, amax, cin, out,
                    mout, B, Zfp, Yfp, xqf, xqc, tz, ty, nz, ny, s)
              : dispatch_downconv_q<float>(cpad, cpad_out, x, fmask, wq, ws,
                                           aff, amax, cin, out, mout, B, Zfp,
                                           Yfp, xqf, xqc, tz, ty, nz, ny, s);
}
