// K7, the plain folded 3^3 convolution of the training path.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py conv_folded_raw (:213),
// body _kernel (:71), weights _fold_weights (:150); called by
// ops/folded.py _conv_train_impl (:1148) for conv_folded_train's forward
// and by _conv_dx (:1181) with flipped, in/out-transposed taps for the
// input gradient of every conv site's backward.
//
//   out[b, z, y, x] = round(sum_taps sum_ci
//                     in[b, z + dz, y + dy, x + dx - 1][ci] * W[tap][ci][:])
//
// The input is a halo'd FGrid [B, Z+2, Y+2, xq, 128] read as Xs = xq * F
// voxel slots of cpad channels (the x neighbours of a slot are slots +-1,
// across the 128-lane blocks: the TPU kernel's "carry" terms; slots
// outside [0, Xs) are zero). The output is UNPADDED [B, Z, Y, xq, 128] in
// the input's type, summed in f32: every slot is written and nothing is
// masked (the input gradient needs every voxel), dead lanes are zero
// (zero weight columns). Unlike K1 there is no affine, no mask and no
// halo ring.
//
// What bounds it on Hopper: the bytes. At the training shapes (B = 8,
// 128x64x64, cpad 16, bf16) the call reads a 141 MB grid and writes a
// 134 MB one; the MACs, 27 * cin * cout per voxel with a non-zero
// neighbour, are a fraction of that time at the tensor-core rate. Design:
// one thread per output slot holding its cpad f32 sums in registers; a
// neighbour voxel is read as 16-byte vectors and each of its zero values
// skips its row of FMAs (the grids are masked, so most neighbours are
// zero); weights are uniform float4 loads; the output row is written as
// 16-byte vectors. Neighbour reads of a warp are 32 consecutive slots, so
// they coalesce. Shared-memory tiles, tensor cores and TMA are left to a
// later version.
#include "common.cuh"

namespace sgnn {

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    conv_raw_kernel(const T* __restrict__ x,
                    const float* __restrict__ w,  // [27, MAXC, MAXC]
                    int cin, T* __restrict__ out, int B, int Z, int Y,
                    int Xs) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Z * Y * Xs) return;
  const Voxel v = decode(idx, Z, Y, Xs);  // output (unpadded) coordinates
  float acc[CPAD];
#pragma unroll
  for (int c = 0; c < CPAD; ++c) acc[c] = 0.f;
  for (int dz = 0; dz < 3; ++dz) {
    for (int dy = 0; dy < 3; ++dy) {
      // input row (b, z + dz, y + dy) of the halo'd grid
      const long long row =
          voxel_index(v.b, v.z + dz, v.y + dy, 0, Z + 2, Y + 2, Xs);
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = v.x + dx - 1;
        if (xx < 0 || xx >= Xs) continue;
        float a[CPAD];
        load_voxel<T, CPAD>(x + (row + xx) * CPAD, a);
        const float* wt = w + ((dz * 3 + dy) * 3 + dx) * MAXC * MAXC;
#pragma unroll
        for (int ci = 0; ci < CPAD; ++ci) {
          if (ci < cin && a[ci] != 0.f) {
            axpy<CPAD>(acc, a[ci], wt + ci * MAXC);
          }
        }
      }
    }
  }
  store_voxel<T, CPAD>(out + idx * CPAD, acc);
}

template <typename T, int CPAD>
static int launch_conv_raw(const void* x, const float* w, int cin, void* out,
                           int B, int Z, int Y, int xq,
                           cudaStream_t stream) {
  const int Xs = xq * (LANES / CPAD);
  const long long n = static_cast<long long>(B) * Z * Y * Xs;
  conv_raw_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, cin, static_cast<T*>(out), B, Z, Y, Xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// x: halo'd [B, Z+2, Y+2, xq, 128]; out: [B, Z, Y, xq, 128], same type.
// cin: input channels read (weight rows >= cin are zero). bf16: 1 for
// bfloat16 grids, 0 for float32.
extern "C" int sgnn_conv_raw(const void* x, const float* w, int cin,
                             void* out, int B, int Z, int Y, int xq,
                             int cpad, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cin > cpad) return static_cast<int>(cudaErrorInvalidValue);
  if (cpad == 8) {
    return bf16 ? launch_conv_raw<__nv_bfloat16, 8>(x, w, cin, out, B, Z, Y,
                                                    xq, s)
                : launch_conv_raw<float, 8>(x, w, cin, out, B, Z, Y, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_conv_raw<__nv_bfloat16, 16>(x, w, cin, out, B, Z, Y,
                                                     xq, s)
                : launch_conv_raw<float, 16>(x, w, cin, out, B, Z, Y, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
