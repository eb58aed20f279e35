// K4, the fused per-voxel head site, in its two modes.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_head_folded (:1687),
// body _kernel_head (:1487); called by ops/folded.py head_site_fused
// (:914, gate mode) and surf_head_fused (:977, summed mode).
//
// Gate mode (a refinement level's tail):
//   lhs  = round(relu(in * scale + bias) * m)            m: the level mask
//   out2 = lhs @ W + b                                   (f32; occ = ch 0)
//   g    = m if out2[0] > 0 else 0                        (strict gate)
//   upm  = round(lhs * g), o2m = round(round(out2) * g), mask = g
// with mask_scale 2 expanding m from the coarse level's grid in place
// (z, y, x each halved), so the fine mask never exists in memory. With a
// raw output (emit_raw=True, the training path: the loss reads every
// level's heads) out2 is also written as an f32 grid at every interior
// slot, before the gate (b where the lhs is masked); its z/y ring is
// unspecified by contract and is written zero here. Serving passes no raw
// grid and writes exactly what it did before.
// Summed mode (the surface head): out = sum_g lhs_g @ W_g + b in f32, not
// masked; the z/y ring of this output is unspecified by contract and is
// written zero here.
//
// What bounds it on Hopper: a per-voxel 16x16 GEMV, so the pass is
// bandwidth bound: read the input grid(s) and the mask, write three grids
// (gate; and the f32 raw grid when asked) or one f32 grid (summed).
// Design: one thread per voxel holding its cpad channels in registers;
// inactive voxels skip the arithmetic.
#include "common.cuh"

namespace sgnn {

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    head_gate_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                     const float* __restrict__ w,     // [MAXC, MAXC]
                     const float* __restrict__ bias,  // [MAXC]
                     const float* __restrict__ aff,   // [2, MAXC]
                     int mask_scale, T* __restrict__ upm,
                     T* __restrict__ o2m, T* __restrict__ fmn,
                     float* __restrict__ raw,  // null: no raw output
                     int B, int Zp, int Yp, int Xs, int Zmp, int Ymp,
                     int Xms) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zp * Yp * Xs) return;
  const Voxel v = decode(idx, Zp, Yp, Xs);
  T* ou = upm + idx * CPAD;
  T* oo = o2m + idx * CPAD;
  T* om = fmn + idx * CPAD;
  float m = 0.f;
  const bool ring = v.z == 0 || v.z == Zp - 1 || v.y == 0 || v.y == Yp - 1;
  if (!ring) {
    if (mask_scale == 1) {
      m = to_f(mask[idx * CPAD]);
    } else {
      const int cx = v.x >> 1;
      if (cx < Xms) {
        m = to_f(mask[voxel_index(v.b, ((v.z - 1) >> 1) + 1,
                                  ((v.y - 1) >> 1) + 1, cx, Zmp, Ymp, Xms) *
                      CPAD]);
      }
    }
  }
  if (m == 0.f) {
    store_zero<T, CPAD>(ou);
    store_zero<T, CPAD>(oo);
    store_zero<T, CPAD>(om);
    if (raw != nullptr) {  // a masked lhs is zero: out2 is the bias alone
      float b[CPAD];
#pragma unroll
      for (int c = 0; c < CPAD; ++c) b[c] = ring ? 0.f : bias[c];
      store_voxel<float, CPAD>(raw + idx * CPAD, b);
    }
    return;
  }
  const T* xv = x + idx * CPAD;
  float lhs[CPAD], out2[CPAD];
#pragma unroll
  for (int c = 0; c < CPAD; ++c) {
    lhs[c] = round_to<T>(
        affine_relu_mask(to_f(xv[c]), aff[c], aff[MAXC + c], m));
    out2[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < CPAD; ++c) axpy<CPAD>(out2, lhs[c], w + c * MAXC);
#pragma unroll
  for (int c = 0; c < CPAD; ++c) out2[c] += bias[c];
  const float g = out2[0] > 0.f ? m : 0.f;
  if (raw != nullptr) store_voxel<float, CPAD>(raw + idx * CPAD, out2);
#pragma unroll
  for (int c = 0; c < CPAD; ++c) {
    ou[c] = from_f<T>(lhs[c] * g);
    oo[c] = from_f<T>(round_to<T>(out2[c]) * g);
    om[c] = from_f<T>(g);
  }
}

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    head_sum_kernel(Groups xs, const T* __restrict__ mask,
                    const float* __restrict__ w,     // [G, MAXC, MAXC]
                    const float* __restrict__ bias,  // [MAXC]
                    const float* __restrict__ aff,   // [G, 2, MAXC]
                    float* __restrict__ out, int B, int Zp, int Yp,
                    int Xs) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zp * Yp * Xs) return;
  const Voxel v = decode(idx, Zp, Yp, Xs);
  float* o = out + idx * CPAD;
  if (v.z == 0 || v.z == Zp - 1 || v.y == 0 || v.y == Yp - 1) {
    store_zero<float, CPAD>(o);
    return;
  }
  const float m = to_f(mask[idx * CPAD]);
  float acc[CPAD];
#pragma unroll
  for (int c = 0; c < CPAD; ++c) acc[c] = 0.f;
  if (m != 0.f) {  // a masked lhs is zero: the output is the bias alone
    for (int g = 0; g < xs.n; ++g) {
      const T* xv = static_cast<const T*>(xs.p[g]) + idx * CPAD;
      const float* sc = aff + g * 2 * MAXC;
      const float* wg = w + g * MAXC * MAXC;
      for (int c = 0; c < xs.cin[g]; ++c) {
        const float a = round_to<T>(
            affine_relu_mask(to_f(xv[c]), sc[c], sc[MAXC + c], m));
        axpy<CPAD>(acc, a, wg + c * MAXC);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPAD; ++c) o[c] = acc[c] + bias[c];
}

template <typename T, int CPAD>
static int launch_head_gate(const void* x, const void* mask, const float* w,
                            const float* bias, const float* aff,
                            int mask_scale, void* upm, void* o2m, void* fmn,
                            float* raw, int B, int Zp, int Yp, int xq,
                            int Zmp, int Ymp, int xqm, cudaStream_t stream) {
  const int F = LANES / CPAD;
  const long long n = static_cast<long long>(B) * Zp * Yp * xq * F;
  head_gate_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), w, bias, aff,
      mask_scale, static_cast<T*>(upm), static_cast<T*>(o2m),
      static_cast<T*>(fmn), raw, B, Zp, Yp, xq * F, Zmp, Ymp, xqm * F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPAD>
static int launch_head_sum(const Groups& g, const void* mask, const float* w,
                           const float* bias, const float* aff,
                           float* out, int B, int Zp, int Yp, int xq,
                           cudaStream_t stream) {
  const int Xs = xq * (LANES / CPAD);
  const long long n = static_cast<long long>(B) * Zp * Yp * Xs;
  head_sum_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), w, bias, aff, out, B, Zp, Yp, Xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// mask: the level mask at this resolution (mask_scale 1) or the coarse
// level's mask grid [B, Zmp, Ymp, xqm, 128] (mask_scale 2), same cpad.
// raw: a float32 grid of x's shape, or null for no raw output.
extern "C" int sgnn_head_gate(const void* x, const void* mask, const float* w,
                              const float* bias, const float* aff,
                              int mask_scale, void* upm, void* o2m, void* fmn,
                              float* raw, int B, int Zp, int Yp, int xq,
                              int Zmp, int Ymp, int xqm, int cpad, int bf16,
                              void* stream) {
  if (mask_scale != 1 && mask_scale != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_head_gate<__nv_bfloat16, 8>(
                      x, mask, w, bias, aff, mask_scale, upm, o2m, fmn,
                      raw, B, Zp, Yp, xq, Zmp, Ymp, xqm, s)
                : launch_head_gate<float, 8>(x, mask, w, bias, aff,
                                             mask_scale, upm, o2m, fmn, raw,
                                             B, Zp, Yp, xq, Zmp, Ymp, xqm, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_head_gate<__nv_bfloat16, 16>(
                      x, mask, w, bias, aff, mask_scale, upm, o2m, fmn,
                      raw, B, Zp, Yp, xq, Zmp, Ymp, xqm, s)
                : launch_head_gate<float, 16>(x, mask, w, bias, aff,
                                              mask_scale, upm, o2m, fmn, raw,
                                              B, Zp, Yp, xq, Zmp, Ymp, xqm, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// xs / cins: host arrays of G device pointers and input widths; out is a
// float32 grid of the inputs' shape.
extern "C" int sgnn_head_sum(const void* const* xs, const int* cins, int G,
                             const void* mask, const float* w,
                             const float* bias, const float* aff,
                             float* out, int B, int Zp, int Yp, int xq,
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
    return bf16 ? launch_head_sum<__nv_bfloat16, 8>(g, mask, w, bias, aff,
                                                    out, B, Zp, Yp, xq, s)
                : launch_head_sum<float, 8>(g, mask, w, bias, aff, out,
                                            B, Zp, Yp, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_head_sum<__nv_bfloat16, 16>(
                      g, mask, w, bias, aff, out, B, Zp, Yp, xq, s)
                : launch_head_sum<float, 16>(g, mask, w, bias, aff, out,
                                             B, Zp, Yp, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
