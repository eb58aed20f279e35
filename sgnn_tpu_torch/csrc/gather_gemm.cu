// K10, the fused neighbour gather and tap GEMM of the coordinate-list
// sparse convolution.
//
// Replaces: sgnn_tpu/ops/pallas/gather_gemm.py gather_gemm_pallas (:62),
// body _kernel (:48); the XLA form it stands in for is
// sgnn_tpu/ops/conv.py gather_gemm (:80), called by every submanifold
// and strided sparse conv of the coordinate-list execution.
//
//   out[n] = round(sum_k feats[nbr[n, k] - 1] @ W[k])    f32 sums
//
// nbr [n, K] int32 holds row + 1 of each tap's neighbour, 0 for a
// missing one (a value outside [1, n] is read as missing too); feats
// [n, cin] and out [n, cout] are in the compute type; W arrives as
// f32 [K, cin, coutp] rounded to that type (common.cuh, row kernels).
//
// What bounds it on Hopper: the gathered bytes and the FMAs. Each output
// row reads up to K neighbour rows of cin values (at the widest site of
// the serving path, the refinement n1, 27 rows of 48 bf16) and writes
// cout values; the table and the weights (at most 27 * 48 * 16 f32 =
// 83 KB) stay in L2/L1. Design: one thread per output row and chunk of
// CO outputs holds the CO f32 sums in registers, walks its K taps,
// skips missing neighbours and zero values, reads a neighbour row as
// 16-byte vectors where its width allows, and reads the weights with
// uniform float4 loads (every thread of a warp at one (tap, channel)
// reads the same address: a broadcast). The TPU design's VMEM-resident
// table and take_along_axis gather were Mosaic workarounds and are not
// carried over; shared-memory weight tiles and tensor-core GEMMs over
// gathered row tiles are left to a later version.
#include <cstdint>

#include "common.cuh"

namespace sgnn {

template <typename T, int CO>
__global__ void __launch_bounds__(THREADS)
    gather_gemm_kernel(const T* __restrict__ feats,
                       const int* __restrict__ nbr,
                       const float* __restrict__ w, T* __restrict__ out,
                       int n, int K, int cin, int cout, int coutp,
                       bool vec_in, bool vec_out) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int c0 = blockIdx.y * CO;
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
  const int* nb = nbr + r * K;
  for (int k = 0; k < K; ++k) {
    const int j = __ldg(nb + k);
    if (j <= 0 || j > n) continue;
    accumulate_row<T, CO>(acc, feats + static_cast<long long>(j - 1) * cin,
                          cin, w + static_cast<long long>(k) * cin * coutp +
                                   c0,
                          coutp, vec_in);
  }
  store_row<T, CO>(out + r * cout + c0, acc, min(CO, cout - c0), vec_out);
}

template <typename T, int CO>
static int launch_gather_gemm(const void* feats, const int* nbr,
                              const float* w, void* out, int n, int K,
                              int cin, int cout, int coutp, int vec_in,
                              cudaStream_t stream) {
  const dim3 grid(blocks_for(n), coutp / CO);
  // 16-byte output runs: whole chunks of a row that starts aligned
  const bool vec_out =
      (cout * sizeof(T)) % 16 == 0 && coutp == cout &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gather_gemm_kernel<T, CO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), nbr, w, static_cast<T*>(out), n, K, cin,
      cout, coutp, vec_in != 0, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_gather_gemm(const void* feats, const int* nbr,
                                const float* w, void* out, int n, int K,
                                int cin, int cout, int coutp, int co,
                                int vec_in, cudaStream_t s) {
  switch (co) {
    case 4:
      return launch_gather_gemm<T, 4>(feats, nbr, w, out, n, K, cin, cout,
                                      coutp, vec_in, s);
    case 8:
      return launch_gather_gemm<T, 8>(feats, nbr, w, out, n, K, cin, cout,
                                      coutp, vec_in, s);
    case 16:
      return launch_gather_gemm<T, 16>(feats, nbr, w, out, n, K, cin, cout,
                                       coutp, vec_in, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sgnn

using namespace sgnn;

// feats [n, cin], out [n, cout] (bf16: 1 for bfloat16, 0 for float32);
// nbr [n, K] int32; w f32 [K, cin, coutp], coutp a multiple of co (4, 8
// or 16) and >= cout. vec_in: feats rows may be read as 16-byte vectors.
extern "C" int sgnn_gather_gemm(const void* feats, const int* nbr,
                                const float* w, void* out, int n, int K,
                                int cin, int cout, int coutp, int co,
                                int vec_in, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || K < 1 || cin < 1 || cout < 1 || co < 1 || coutp % co ||
      coutp < cout || coutp - cout >= co) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? dispatch_gather_gemm<__nv_bfloat16>(feats, nbr, w, out, n, K,
                                                    cin, cout, coutp, co,
                                                    vec_in, s)
              : dispatch_gather_gemm<float>(feats, nbr, w, out, n, K, cin,
                                            cout, coutp, co, vec_in, s);
}
