// K6, the input scatter: sparse TSDF rows -> the level-0 feature and mask
// grids.
//
// Replaces: sgnn_tpu/ops/pallas/scatter_folded.py scatter_slots_folded
// (:92), body _kernel (:48), with the encode and decode around it in
// ops/folded.py scatter_sparse (:248-295).
//
//   e       = feat + K              (f32; K a power of two above |feat|)
//   data[v] = round(e > 0 ? e - K : e)    on the voxel's channel-0 lane
//   mask[v] = (e > 0)                     on all cpad lanes of the voxel
//
// with every other lane of both grids zero (the wrapper allocates them
// zeroed). Input voxels are unique, so the TPU kernel's sum-scatter is one
// store per row; rows outside the grid are dropped.
//
// What bounds it on Hopper: writing the two output grids, almost all of it
// the zero fill (3.5M voxel slots of cpad lanes each at 96x192x192); the
// ~68k rows are one scattered store each. Design: one thread per row
// computes its voxel, encodes and decodes its value in registers and
// writes its voxel's lanes. The TPU kernel's slot buffer, sort and
// per-plane row offsets exist to batch rows into MXU contractions; a GPU
// thread stores to any address, so none of them is needed.
#include "common.cuh"

namespace sgnn {

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    scatter_kernel(const long long* __restrict__ locs,  // [n, 4] z, y, x, b
                   const float* __restrict__ feats,     // [n]
                   int n, float K, T* __restrict__ data, T* __restrict__ mask,
                   int B, int Z, int Y, int X, int Xs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long z = locs[4 * i], y = locs[4 * i + 1], x = locs[4 * i + 2],
                  b = locs[4 * i + 3];
  if (z < 0 || z >= Z || y < 0 || y >= Y || x < 0 || x >= X || b < 0 ||
      b >= B)
    return;
  const long long v =
      voxel_index(static_cast<int>(b), static_cast<int>(z) + 1,
                  static_cast<int>(y) + 1, static_cast<int>(x), Z + 2, Y + 2,
                  Xs) *
      CPAD;
  const float e = __fadd_rn(feats[i], K);
  const bool occupied = e > 0.f;
  data[v] = from_f<T>(occupied ? __fsub_rn(e, K) : e);
  if (occupied) {
#pragma unroll
    for (int c = 0; c < CPAD; ++c) mask[v + c] = from_f<T>(1.f);
  }
}

template <typename T, int CPAD>
static int launch_scatter(const long long* locs, const float* feats, int n,
                          float K, void* data, void* mask, int B, int Z,
                          int Y, int X, int xq, cudaStream_t stream) {
  scatter_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      locs, feats, n, K, static_cast<T*>(data), static_cast<T*>(mask), B, Z,
      Y, X, xq * (LANES / CPAD));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// locs [n, 4] int64 and feats [n] f32 on the device, n >= 1; data and mask
// are zeroed grids [B, Z+2, Y+2, xq, 128] of the compute type.
extern "C" int sgnn_scatter(const long long* locs, const float* feats, int n,
                            float K, void* data, void* mask, int B, int Z,
                            int Y, int X, int xq, int cpad, int bf16,
                            void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_scatter<__nv_bfloat16, 8>(locs, feats, n, K, data,
                                                   mask, B, Z, Y, X, xq, s)
                : launch_scatter<float, 8>(locs, feats, n, K, data, mask, B,
                                           Z, Y, X, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_scatter<__nv_bfloat16, 16>(locs, feats, n, K, data,
                                                    mask, B, Z, Y, X, xq, s)
                : launch_scatter<float, 16>(locs, feats, n, K, data, mask, B,
                                            Z, Y, X, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
