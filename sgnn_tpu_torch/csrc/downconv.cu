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
// What bounds it on Hopper: bytes. The fine mask is read in full, the fine
// input only where the function needs it, and the two coarse grids (1/8 of
// the voxels) are written once. At 8 * cin * 16 MACs per active coarse
// voxel it does a few operations per byte moved, far below the ~295 a byte
// at which an H100's bf16 tensor cores would be the limit, so tensor cores
// cannot help: the products stay f32 FMAs on the CUDA cores, the weights
// broadcast from shared memory. What it needs is bytes in flight.
//
// Design: one thread per coarse voxel, x fastest, so lane i of a warp owns
// coarse x = i and its two fine x-children in each of the 4 (dz, dy) fine
// rows are 2 * cpad contiguous values (a warp reads one contiguous run per
// row). The 8 children's mask loads issue together before any arithmetic;
// an inactive coarse voxel writes zeros as 16-byte vectors at once, and a
// block with no active one ends without staging the weights. An active
// coarse voxel reads its children's inputs as 16-byte vectors (with the
// affine only the children whose mask is set, without it the whole 2^3
// block), the 4 children of one fine z-row pair with their loads in flight
// together, and writes both coarse outputs as 16-byte vector stores.
//
// K2q, the int8 mode (quantize=True, _kernel_downconv :1228-1264), keeps
// a body of its own, one thread per coarse voxel: it reads its TPU
// tile's amax (tile (iz, iy) holds coarse interior rows [iz tz, (iz + 1)
// tz) x [iy ty, (iy + 1) ty); its window is their fine children, no halo),
// quantizes each fine child's f32 input on the fly, sums int8 products in
// int32 with __dp4a against int8 weights [8, co, ci], and writes f32(iacc)
// * (s * ws[co]) times the coarse mask; the coarse mask is the exact
// mode's.
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
  constexpr int VEC = CI * static_cast<int>(sizeof(T)) / 16;  // per child
  __shared__ __align__(16) float sw[8 * CI * CO];  // [tap][ci][co]
  __shared__ float sa[2 * CI];
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool inside = idx < static_cast<long long>(B) * Zcp * Ycp * Xsc;
  const Voxel v = decode(inside ? idx : 0, Zcp, Ycp, Xsc);
  // fine halo index of child d of coarse halo index c: 2 (c - 1) + d + 1;
  // Xsf is even, so the x-children 2 x and 2 x + 1 exist together
  const bool live = inside && v.z != 0 && v.z != Zcp - 1 && v.y != 0 &&
                    v.y != Ycp - 1 && 2 * v.x < Xsf;
  long long row[4];  // fine (dz, dy) rows' first child, dz * 2 + dy
  float mk[8];       // tap t = dz * 4 + dy * 2 + dx
  float mc = 0.f;
  if (live) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      row[r] = voxel_index(v.b, 2 * v.z - 1 + r / 2, 2 * v.y - 1 + r % 2,
                           2 * v.x, Zfp, Yfp, Xsf);
#pragma unroll
    for (int t = 0; t < 8; ++t) mk[t] = to_f(fmask[(row[t / 2] + t % 2) * CI]);
#pragma unroll
    for (int t = 0; t < 8; ++t) mc = fmaxf(mc, mk[t]);
  }
  T* o = out + idx * CO;
  T* mo = mout + idx * CO;
  if (inside && mc == 0.f) {  // inactive: zero, whatever the block does
    store_zero<T, CO>(o);
    store_zero<T, CO>(mo);
  }
  if (!__syncthreads_or(mc != 0.f)) return;
  for (int i = threadIdx.x; i < 8 * CI * CO; i += THREADS)
    sw[i] = w[(i / (CI * CO) * MAXC + i / CO % CI) * MAXC + i % CO];
  if (aff != nullptr && threadIdx.x < 2 * CI)
    sa[threadIdx.x] = aff[threadIdx.x / CI * MAXC + threadIdx.x % CI];
  __syncthreads();
  if (mc == 0.f) return;
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    uint4 raw[4][VEC];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = dz * 4 + q;
      if (aff == nullptr || mk[t] != 0.f) {
        const uint4* p =
            reinterpret_cast<const uint4*>(x + (row[t / 2] + t % 2) * CI);
#pragma unroll
        for (int k = 0; k < VEC; ++k) raw[q][k] = __ldg(p + k);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = dz * 4 + q;
      if (aff != nullptr && mk[t] == 0.f) continue;  // relu(.) * 0 adds 0
      const T* in = reinterpret_cast<const T*>(raw[q]);
#pragma unroll
      for (int ci = 0; ci < CI; ++ci) {  // constant indices: raw stays in
        if (ci >= cin) break;            // registers
        float a = to_f(in[ci]);
        if (aff != nullptr)
          a = round_to<T>(affine_relu_mask(a, sa[ci], sa[CI + ci], mk[t]));
        const float4* wr =
            reinterpret_cast<const float4*>(sw + (t * CI + ci) * CO);
#pragma unroll
        for (int c4 = 0; c4 < CO / 4; ++c4) {
          const float4 wv = wr[c4];
          acc[4 * c4 + 0] = fmaf(a, wv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(a, wv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(a, wv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(a, wv.w, acc[4 * c4 + 3]);
        }
      }
    }
  }
  store_voxel<T, CO>(o, acc);
  float ones[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) ones[c] = 1.f;
  store_voxel<T, CO>(mo, ones);
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
