// K8 and K9, the zero-padded 3^3 convolution over a channels-last grid.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py _conv_impl (:178, the
// pallas_call at :191) behind conv3d_3x3x3_folded (:268, custom VJP
// :279-300), K8, which models/dense_flow.py:_conv_one routes every
// eligible 3^3 conv of the dense-flow execution through under
// cfg.use_pallas_conv (C in {8, 16, 32}, Cout <= C); and
// sgnn_tpu/ops/pallas/conv3d.py conv3d_3x3x3_pallas (:77, the
// pallas_call at :103), K9, the experimental form for any Cin and
// Cout, which no entry point of the JAX package reaches.
// Both compute one function, so one kernel serves both entry points:
//
//   out[b, z, y, x] = round(sum_taps sum_ci
//                     in[b, z + dz - 1, y + dy - 1, x + dx - 1][ci]
//                     * W[tap][ci][:])                    f32 sums
//
// x [B, Z, Y, X, cin] and out [B, Z, Y, X, cout] in the compute type;
// neighbours outside the volume are zero (bounds-checked, no padded
// copy); W arrives as f32 [27, cin, coutp] rounded to the compute type,
// taps in C order over (dz, dy, dx) (common.cuh, row kernels).
//
// What bounds it on Hopper: the bytes. At the dense-flow execution's
// full resolution (96x192x192, C = 16, bf16) the call reads and writes
// 113 MB each; the MACs of the masked grid's non-zero neighbours are a
// fraction of that time at the tensor-core rate. Design: one thread per
// output voxel and chunk of CO outputs holds the CO f32 sums in
// registers; a neighbour voxel's channels are read as 16-byte vectors
// (C = 8, 16, 32 in bf16 and f32) and each zero value skips its row of
// FMAs (dense-flow grids are masked: most neighbours are zero); weights
// are uniform float4 loads; 32 threads of a warp read 32 consecutive
// voxels, so their loads coalesce. The TPU kernel's lane folding
// (_fold_weights, the carry GEMM) existed for Mosaic's (8, 128) tiling
// and is not carried over; shared-memory halo tiles and tensor-core
// GEMMs are left to a later version.
#include <cstdint>

#include "common.cuh"

namespace sgnn {

template <typename T, int CO>
__global__ void __launch_bounds__(THREADS)
    conv3d_cl_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ out, int B, int Z, int Y, int X,
                     int cin, int cout, int coutp, bool vec_in,
                     bool vec_out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Z * Y * X) return;
  const Voxel v = decode(idx, Z, Y, X);
  const int c0 = blockIdx.y * CO;
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
  for (int dz = 0; dz < 3; ++dz) {
    const int zz = v.z + dz - 1;
    if (zz < 0 || zz >= Z) continue;
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = v.y + dy - 1;
      if (yy < 0 || yy >= Y) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = v.x + dx - 1;
        if (xx < 0 || xx >= X) continue;
        const int tap = (dz * 3 + dy) * 3 + dx;
        accumulate_row<T, CO>(
            acc, x + voxel_index(v.b, zz, yy, xx, Z, Y, X) * cin, cin,
            w + static_cast<long long>(tap) * cin * coutp + c0, coutp,
            vec_in);
      }
    }
  }
  store_row<T, CO>(out + idx * cout + c0, acc, min(CO, cout - c0), vec_out);
}

template <typename T, int CO>
static int launch_conv3d_cl(const void* x, const float* w, void* out, int B,
                            int Z, int Y, int X, int cin, int cout,
                            int coutp, int vec_in, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * Z * Y * X;
  const dim3 grid(blocks_for(n), coutp / CO);
  const bool vec_out =
      (cout * sizeof(T)) % 16 == 0 && coutp == cout &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  conv3d_cl_kernel<T, CO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), B, Z, Y, X, cin,
      cout, coutp, vec_in != 0, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_conv3d_cl(const void* x, const float* w, void* out,
                              int B, int Z, int Y, int X, int cin, int cout,
                              int coutp, int co, int vec_in,
                              cudaStream_t s) {
  switch (co) {
    case 4:
      return launch_conv3d_cl<T, 4>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                    vec_in, s);
    case 8:
      return launch_conv3d_cl<T, 8>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                    vec_in, s);
    case 16:
      return launch_conv3d_cl<T, 16>(x, w, out, B, Z, Y, X, cin, cout,
                                     coutp, vec_in, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

static int conv3d_cl(const void* x, const float* w, void* out, int B, int Z,
                     int Y, int X, int cin, int cout, int coutp, int co,
                     int vec_in, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || cin < 1 || cout < 1 || co < 1 ||
      coutp % co || coutp < cout || coutp - cout >= co) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? dispatch_conv3d_cl<__nv_bfloat16>(x, w, out, B, Z, Y, X, cin,
                                                  cout, coutp, co, vec_in, s)
              : dispatch_conv3d_cl<float>(x, w, out, B, Z, Y, X, cin, cout,
                                          coutp, co, vec_in, s);
}

}  // namespace sgnn

// x [B, Z, Y, X, cin], out [B, Z, Y, X, cout] (bf16: 1 for bfloat16, 0 for
// float32); w f32 [27, cin, coutp], coutp a multiple of co (4, 8 or 16)
// and >= cout; vec_in: x rows may be read as 16-byte vectors.
// K8's entry point (the wrapper admits only conv3d_folded's shapes):
extern "C" int sgnn_conv3d_folded(const void* x, const float* w, void* out,
                                  int B, int Z, int Y, int X, int cin,
                                  int cout, int coutp, int co, int vec_in,
                                  int bf16, void* stream) {
  return sgnn::conv3d_cl(x, w, out, B, Z, Y, X, cin, cout, coutp, co, vec_in,
                         bf16, stream);
}

// K9's entry point (any cin, cout):
extern "C" int sgnn_conv3d(const void* x, const float* w, void* out, int B,
                           int Z, int Y, int X, int cin, int cout, int coutp,
                           int co, int vec_in, int bf16, void* stream) {
  return sgnn::conv3d_cl(x, w, out, B, Z, Y, X, cin, cout, coutp, co, vec_in,
                         bf16, stream);
}
