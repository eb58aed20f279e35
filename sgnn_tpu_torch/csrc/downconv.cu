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
// K2q, the int8 mode. Replaces: the same fused_downconv_folded with
// quantize=True, int8 body of _kernel_downconv (:1228-1264). Each fine
// child's f32 site input (the affine's value before any rounding, relu(x
// s + b) m_child, else x) is quantized with the scale s of the TPU tile
// that holds the coarse output voxel (tile (iz, iy) holds coarse interior
// rows [iz tz, (iz + 1) tz) x [iy ty, (iy + 1) ty); its window is their
// fine children, no halo); the int8 products of the 8 taps sum exactly in
// int32 against int8 weights [8, co, ci], and the output is f32(iacc) *
// (s * ws[co]) times the coarse mask, each product rounded on its own;
// the coarse mask is the exact mode's.
// What bounds it: the same bytes as K2. Its 8 * cin * cout s8 MACs per
// active coarse voxel are a few per byte moved, far below the ~590 a byte
// at which the s8 tensor cores (1,979 TOP/s) would be the limit, so the
// products stay __dp4a on the CUDA cores (4 MACs an instruction).
// Design: K2's kernel body with the mode as a template parameter, one
// skeleton for both: the mask loads, the skip, the 16-byte loads of the
// children (with the affine only those whose mask is set) and the 16-byte
// stores are K2's; the int8 weights (2 KB at 16 x 16) are staged once a
// block in shared memory, where each output channel's __dp4a reads one
// broadcast 16-byte word, and the scale is one lookup a thread, its
// coarse row's tile.
#include "common.cuh"

namespace sgnn {

// The int8 mode's arguments (K2q); null pointers in the exact mode.
struct DownQ {
  const int4* wq;     // int8 [8, MAXC co, MAXC ci]: a word a (tap, co)
  const float* ws;    // [MAXC]
  const float* amax;  // [B, nz, ny] from sgnn_tile_amax
  int tz, ty, nz, ny;  // the TPU tile in coarse rows, tiles per z and y
};

// The body of both modes; downconv_kernel (exact) and downconv_q_kernel
// (int8) below, two names for the profiles.
template <typename T, int CI, int CO, bool QUANT>
__device__ __forceinline__ void downconv_site(
    const T* __restrict__ x, const T* __restrict__ fmask,
    const float* __restrict__ w,  // exact: [8, MAXC, MAXC]
    const DownQ& qa, const float* __restrict__ aff,  // [2, MAXC] or null
    int cin, T* __restrict__ out, T* __restrict__ mout, int B, int Zcp,
    int Ycp, int Xsc, int Zfp, int Yfp, int Xsf) {
  constexpr int VEC = CI * static_cast<int>(sizeof(T)) / 16;  // per child
  // the weights: exact f32 [tap][ci][co]; int8 a 16-byte word a [tap][co]
  constexpr int WBYTES = QUANT ? 8 * CO * 16 : 8 * CI * CO * 4;
  __shared__ __align__(16) unsigned char swb[WBYTES];
  __shared__ float sa[2 * MAXC];
  __shared__ float sws[CO];
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
  if constexpr (QUANT) {
    int4* sq = reinterpret_cast<int4*>(swb);
    for (int i = threadIdx.x; i < 8 * CO; i += THREADS)
      sq[i] = qa.wq[i / CO * MAXC + i % CO];
    if (threadIdx.x < CO) sws[threadIdx.x] = qa.ws[threadIdx.x];
  } else {
    float* sw = reinterpret_cast<float*>(swb);
    for (int i = threadIdx.x; i < 8 * CI * CO; i += THREADS)
      sw[i] = w[(i / (CI * CO) * MAXC + i / CO % CI) * MAXC + i % CO];
  }
  if (aff != nullptr && threadIdx.x < 2 * MAXC)
    sa[threadIdx.x] = aff[threadIdx.x];
  __syncthreads();
  if (mc == 0.f) return;
  float acc[CO];
  [[maybe_unused]] int iacc[CO];
  [[maybe_unused]] float s = 0.f, inv = 0.f;  // the int8 mode's scale, 1 / s
  if constexpr (QUANT) {
    s = tile_scale(qa.amax[(static_cast<long long>(v.b) * qa.nz +
                            (v.z - 1) / qa.tz) * qa.ny + (v.y - 1) / qa.ty]);
    inv = 1.0f / s;
  }
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    acc[c] = 0.f;
    iacc[c] = 0;
  }
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
      if constexpr (QUANT) {
        float vals[CI];
#pragma unroll
        for (int ci = 0; ci < CI; ++ci) vals[ci] = to_f(in[ci]);
        int words[CI / 4];
        if (quantize_values<CI>(vals, cin, aff != nullptr ? sa : nullptr,
                                mk[t], inv, words))
          dp4a_voxel<CI, CO>(iacc, words,
                             reinterpret_cast<const int4*>(swb) + t * CO);
      } else {
        const float* sw = reinterpret_cast<const float*>(swb);
#pragma unroll
        for (int ci = 0; ci < CI; ++ci) {  // constant indices: raw stays in
          if (ci >= cin) break;            // registers
          float a = to_f(in[ci]);
          if (aff != nullptr)
            a = round_to<T>(
                affine_relu_mask(a, sa[ci], sa[MAXC + ci], mk[t]));
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
  }
  if constexpr (QUANT) {
    // f32(iacc) * (s * ws[co]) * mc, each product rounded on its own
#pragma unroll
    for (int c = 0; c < CO; ++c)
      acc[c] = __fmul_rn(__fmul_rn(static_cast<float>(iacc[c]),
                                   __fmul_rn(s, sws[c])),
                         mc);
  }
  store_voxel<T, CO>(o, acc);
  float ones[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) ones[c] = 1.f;
  store_voxel<T, CO>(mo, ones);
}

template <typename T, int CI, int CO>
__global__ void __launch_bounds__(THREADS)
    downconv_kernel(const T* __restrict__ x, const T* __restrict__ fmask,
                    const float* __restrict__ w, DownQ qa,
                    const float* __restrict__ aff, int cin,
                    T* __restrict__ out, T* __restrict__ mout, int B, int Zcp,
                    int Ycp, int Xsc, int Zfp, int Yfp, int Xsf) {
  downconv_site<T, CI, CO, false>(x, fmask, w, qa, aff, cin, out, mout, B,
                                  Zcp, Ycp, Xsc, Zfp, Yfp, Xsf);
}

template <typename T, int CI, int CO>
__global__ void __launch_bounds__(THREADS)
    downconv_q_kernel(const T* __restrict__ x, const T* __restrict__ fmask,
                      const float* __restrict__ w, DownQ qa,
                      const float* __restrict__ aff, int cin,
                      T* __restrict__ out, T* __restrict__ mout, int B,
                      int Zcp, int Ycp, int Xsc, int Zfp, int Yfp, int Xsf) {
  downconv_site<T, CI, CO, true>(x, fmask, w, qa, aff, cin, out, mout, B,
                                 Zcp, Ycp, Xsc, Zfp, Yfp, Xsf);
}

template <typename T, int CI, int CO, bool QUANT>
static int launch_downconv(const void* x, const void* fmask, const float* w,
                           const DownQ& qa, const float* aff, int cin,
                           void* out, void* mout, int B, int Zfp, int Yfp,
                           int xqf, int xqc, cudaStream_t stream) {
  const int Zcp = (Zfp - 2) / 2 + 2;
  const int Ycp = (Yfp - 2) / 2 + 2;
  const int Xsf = xqf * (LANES / CI);
  const int Xsc = xqc * (LANES / CO);
  const long long n = static_cast<long long>(B) * Zcp * Ycp * Xsc;
  auto kernel = QUANT ? downconv_q_kernel<T, CI, CO>
                      : downconv_kernel<T, CI, CO>;
  kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(fmask), w, qa, aff,
      cin, static_cast<T*>(out), static_cast<T*>(mout), B, Zcp, Ycp, Xsc,
      Zfp, Yfp, Xsf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool QUANT>
static int dispatch_downconv(int cpad, int cpad_out, const void* x,
                             const void* fmask, const float* w,
                             const DownQ& qa, const float* aff, int cin,
                             void* out, void* mout, int B, int Zfp, int Yfp,
                             int xqf, int xqc, cudaStream_t s) {
  if (cpad == 8 && cpad_out == 8)
    return launch_downconv<T, 8, 8, QUANT>(x, fmask, w, qa, aff, cin, out,
                                           mout, B, Zfp, Yfp, xqf, xqc, s);
  if (cpad == 8 && cpad_out == 16)
    return launch_downconv<T, 8, 16, QUANT>(x, fmask, w, qa, aff, cin, out,
                                            mout, B, Zfp, Yfp, xqf, xqc, s);
  if (cpad == 16 && cpad_out == 16)
    return launch_downconv<T, 16, 16, QUANT>(x, fmask, w, qa, aff, cin,
                                             out, mout, B, Zfp, Yfp, xqf,
                                             xqc, s);
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
  const DownQ none{};
  return bf16 ? dispatch_downconv<__nv_bfloat16, false>(
                    cpad, cpad_out, x, fmask, w, none, aff, cin, out, mout,
                    B, Zfp, Yfp, xqf, xqc, s)
              : dispatch_downconv<float, false>(cpad, cpad_out, x, fmask, w,
                                                none, aff, cin, out, mout, B,
                                                Zfp, Yfp, xqf, xqc, s);
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
  const DownQ qa{static_cast<const int4*>(wq), ws, amax, tz, ty, nz, ny};
  return bf16 ? dispatch_downconv<__nv_bfloat16, true>(
                    cpad, cpad_out, x, fmask, nullptr, qa, aff, cin, out,
                    mout, B, Zfp, Yfp, xqf, xqc, s)
              : dispatch_downconv<float, true>(cpad, cpad_out, x, fmask,
                                               nullptr, qa, aff, cin, out,
                                               mout, B, Zfp, Yfp, xqf, xqc,
                                               s);
}
