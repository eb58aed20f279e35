// K5, the multi-scale surface head.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_surf_head_ms
// (:1975), body _kernel_surfpack (:1855); called by ops/folded.py
// surf_head_packed (:1011).
//
// The surface level's U-Net hands over G groups at their native
// resolutions: group g at scale s_g covers the fine voxel (z, y, x) with
// its coarse voxel (z / s, y / s, x / s). Per fine voxel:
//
//   h_g  = sum_c round(relu(in_g[c] * scale_g[c] + bias_g[c])) * W_g[c]
//   out  = (h_0 + h_1 + ... + h_{G-1}) * m + b        (f32, group order)
//
// with m the fine mask (0/1, read from lane 0 of the voxel's cpad lanes).
// As in the TPU kernel, the mask multiplies the sum, so a voxel outside
// the mask holds exactly b. The output is the dense [B, Z, Y, X] f32 sdf
// that surf_head_packed returns: the TPU kernel's halo'd 128-lane f32
// grid existed only to feed unfold.
//
// What bounds it on Hopper: bytes. Every fine voxel's mask is read (one
// 32-byte sector a voxel at cpad 16 in bf16, most of the bytes) and every
// output written (4 bytes a voxel); the groups are read only at the few
// voxels whose mask is set (~3% on a scene's surface band), and the
// arithmetic is a 16-wide dot product a group there.
// Design: a thread takes a run of RUN = 4 consecutive x voxels of one
// output row (b, z, y), issues the run's four mask reads together and
// writes the run as one 16-byte float4, so a warp stores 512 contiguous
// bytes and consecutive warps walk the output rows in order. One run a
// thread: a pass that only streams the mask runs near the memory rate in
// any of several read patterns, and what holds this one back is the
// latency of the few active runs' group reads, so the more threads carry
// them the better (2, 4 and 8 runs a thread, batching a group's reads of
// a run and an L2 prefetch hint on the mask reads were all slower or
// level). Only a run
// with a voxel whose mask is set computes (every other voxel is 0 * m +
// b): per group it reads the coarse voxel of each active fine voxel as
// 16-byte vectors and computes its h_g once, then reuses it for the run's
// next active voxels that share the coarse voxel (a run covers 4, 2 and 1
// coarse voxels at scales 1, 2 and 4), so a coarse voxel is read only
// where a voxel it covers is active. Only real voxels (x < X) are read, so the coarse
// grids' x tail-pad blocks may hold anything. The head column, affines
// and bias are staged once a block in shared memory, and the group and
// channel loops are unrolled (G and cpad are template parameters). Each
// output is the FMA chain of the one-thread-per-voxel kernel this design
// replaced (h from +0 over channels ascending, acc from +0 over groups
// ascending, then * m + b, each rounded on its own), so its bits are
// that kernel's. A row whose X is not a multiple of 4 (possible without a
// scale-4 group) is not 16-byte aligned and is written element by
// element.
#include <cstdint>

#include "common.cuh"

namespace sgnn {

// Input groups of the surface head, passed by value to the kernel.
struct ScaledGroups {
  const void* p[MAXG];
  int cin[MAXG];
  int scale[MAXG];
  int xs[MAXG];  // voxel slots per row of the group's grid (xq_g * F)
  int n;
};

constexpr int RUN = 4;  // x voxels a thread writes as one float4

// h = sum_c round(relu(v[c] * sc[c] + sb[c])) * sw[c] over c < cin, the
// FMA chain from +0 in channel order, for the voxel row at xv.
template <typename T, int CPAD>
__device__ __forceinline__ float head_value(const T* __restrict__ xv,
                                            int cin, const float* sw,
                                            const float* sc,
                                            const float* sb) {
  float t[CPAD];
  load_voxel<T, CPAD>(xv, t);
  float h = 0.f;
#pragma unroll
  for (int c = 0; c < CPAD; ++c) {
    if (c >= cin) break;
    const float a = round_to<T>(
        fmaxf(__fadd_rn(__fmul_rn(t[c], sc[c]), sb[c]), 0.f));
    h = fmaf(a, sw[c], h);
  }
  return h;
}

template <typename T, int CPAD, int G>
__global__ void __launch_bounds__(THREADS)
    surf_head_kernel(ScaledGroups gs, const T* __restrict__ mask,
                     const float* __restrict__ w,     // [G, MAXC, MAXC]
                     const float* __restrict__ bias,  // [MAXC]
                     const float* __restrict__ aff,   // [G, 2, MAXC]
                     float* __restrict__ out, int Z, int Y, int X, int Xs,
                     int runs_row, int nruns) {
  // column 0 of each group's head rows, and its affine
  __shared__ __align__(16) float sw[G][CPAD], sc[G][CPAD], sb[G][CPAD];
  for (int i = threadIdx.x; i < G * CPAD; i += THREADS) {
    const int g = i / CPAD, c = i % CPAD;
    sw[g][c] = w[(g * MAXC + c) * MAXC];
    sc[g][c] = aff[g * 2 * MAXC + c];
    sb[g][c] = aff[g * 2 * MAXC + MAXC + c];
  }
  const float b0 = bias[0];
  __syncthreads();
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= nruns) return;
  const int r = q / runs_row, x0 = (q - r * runs_row) * RUN;
  const int y = r % Y, bz = r / Y;  // bz = b Z + z
  const int z = bz % Z, b = bz / Z;
  const T* mv =
      mask + voxel_index(b, z + 1, y + 1, x0, Z + 2, Y + 2, Xs) * CPAD;
  float m[RUN];  // the run's mask values, read together
#pragma unroll
  for (int i = 0; i < RUN; ++i)
    m[i] = x0 + i < X ? to_f(mv[i * CPAD]) : 0.f;
  float acc[RUN];
  bool any = false;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    acc[i] = 0.f;
    any |= m[i] != 0.f;
  }
  if (any) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = gs.scale[g];
      const T* row = static_cast<const T*>(gs.p[g]) +
                     voxel_index(b, z / s + 1, y / s + 1, 0, Z / s + 2,
                                 Y / s + 2, gs.xs[g]) *
                         CPAD;
      float h = 0.f;
      int last = -1;  // the coarse x whose h_g is held
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        if (m[i] == 0.f) continue;
        const int xc = (x0 + i) / s;
        if (xc != last) {
          h = head_value<T, CPAD>(row + static_cast<long long>(xc) * CPAD,
                                  gs.cin[g], sw[g], sc[g], sb[g]);
          last = xc;
        }
        acc[i] = __fadd_rn(acc[i], h);
      }
    }
  }
  float o[RUN];
#pragma unroll
  for (int i = 0; i < RUN; ++i)
    o[i] = __fadd_rn(__fmul_rn(acc[i], m[i]), b0);
  float* orow = out + static_cast<long long>(r) * X + x0;
  if (X % RUN == 0) {
    *reinterpret_cast<float4*>(orow) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (x0 + i < X) orow[i] = o[i];
  }
}

template <typename T, int CPAD, int G>
static int launch_surf_head(const ScaledGroups& g, const void* mask,
                            const float* w, const float* bias,
                            const float* aff, float* out, int B, int Z,
                            int Y, int X, int xq, cudaStream_t stream) {
  const int runs_row = (X + RUN - 1) / RUN;
  const long long nruns = static_cast<long long>(B) * Z * Y * runs_row;
  if (nruns > 0x7fffffffLL - THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  surf_head_kernel<T, CPAD, G><<<blocks_for(nruns), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), w, bias, aff, out, Z, Y, X,
      xq * (LANES / CPAD), runs_row, static_cast<int>(nruns));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPAD>
static int dispatch_surf_head(const ScaledGroups& g, const void* mask,
                              const float* w, const float* bias,
                              const float* aff, float* out, int B, int Z,
                              int Y, int X, int xq, cudaStream_t s) {
  switch (g.n) {
    case 1:
      return launch_surf_head<T, CPAD, 1>(g, mask, w, bias, aff, out, B, Z,
                                          Y, X, xq, s);
    case 2:
      return launch_surf_head<T, CPAD, 2>(g, mask, w, bias, aff, out, B, Z,
                                          Y, X, xq, s);
    case 3:
      return launch_surf_head<T, CPAD, 3>(g, mask, w, bias, aff, out, B, Z,
                                          Y, X, xq, s);
    case 4:
      return launch_surf_head<T, CPAD, 4>(g, mask, w, bias, aff, out, B, Z,
                                          Y, X, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sgnn

using namespace sgnn;

// xs / cins / scales / xqs: host arrays of G device pointers, input widths,
// NN-upsample factors and x-block counts; group g is a [B, Z/s+2, Y/s+2,
// xqs[g], 128] grid, 16-byte aligned. mask: the fine mask [B, Z+2, Y+2,
// xq, 128]; out: a float32 [B, Z, Y, X] array, 16-byte aligned.
extern "C" int sgnn_surf_head(const void* const* xs, const int* cins,
                              const int* scales, const int* xqs, int G,
                              const void* mask, const float* w,
                              const float* bias, const float* aff,
                              float* out, int B, int Z, int Y, int X, int xq,
                              int cpad, int bf16, void* stream) {
  if (G < 1 || G > MAXG || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  ScaledGroups g{};
  for (int i = 0; i < G; ++i) {
    const int s = scales[i];
    if (s < 1 || Z % s || Y % s || X % s ||
        reinterpret_cast<uintptr_t>(xs[i]) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    g.p[i] = xs[i];
    g.cin[i] = cins[i];
    g.scale[i] = s;
    g.xs[i] = xqs[i] * (LANES / cpad);
  }
  g.n = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? dispatch_surf_head<__nv_bfloat16, 8>(
                      g, mask, w, bias, aff, out, B, Z, Y, X, xq, s)
                : dispatch_surf_head<float, 8>(g, mask, w, bias, aff, out,
                                               B, Z, Y, X, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? dispatch_surf_head<__nv_bfloat16, 16>(
                      g, mask, w, bias, aff, out, B, Z, Y, X, xq, s)
                : dispatch_surf_head<float, 16>(g, mask, w, bias, aff, out,
                                                B, Z, Y, X, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
