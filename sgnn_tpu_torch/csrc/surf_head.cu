// K5, the multi-scale surface head.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_surf_head_ms
// (:1975), body _kernel_surfpack (:1855); called by ops/folded.py
// surf_head_packed (:1011).
//
// The surface level's U-Net hands over G groups at their native
// resolutions: group g at scale s_g (1, 2, 4) covers the fine voxel
// (z, y, x) with its coarse voxel (z / s, y / s, x / s). Per fine voxel:
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
// What bounds it on Hopper: memory. Per fine voxel one mask read and one
// 4-byte store (14 MB at 96x192x192); active voxels add a 16-channel read
// of the scale-1 group and of the coarse groups, which are 1/8 and 1/64
// the size and stay in L2. Design: one thread per fine voxel, x fastest,
// so the stores coalesce and neighbouring threads share their coarse
// voxels; the NN expansion is integer division of the coordinates (the
// TPU kernel's one-hot lane-duplication GEMMs and sublane repeats have no
// counterpart); inactive voxels skip every group read. Only real voxels
// (x < X) are read, so the coarse grids' x tail-pad blocks may hold
// anything.
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

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    surf_head_kernel(ScaledGroups gs, const T* __restrict__ mask,
                     const float* __restrict__ w,     // [G, MAXC, MAXC]
                     const float* __restrict__ bias,  // [MAXC]
                     const float* __restrict__ aff,   // [G, 2, MAXC]
                     float* __restrict__ out, int B, int Z, int Y, int X,
                     int Xs) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Z * Y * X) return;
  const Voxel v = decode(idx, Z, Y, X);  // interior coordinates
  const float m =
      to_f(mask[voxel_index(v.b, v.z + 1, v.y + 1, v.x, Z + 2, Y + 2, Xs) *
                CPAD]);
  float acc = 0.f;
  if (m != 0.f) {
    for (int g = 0; g < gs.n; ++g) {
      const int s = gs.scale[g];
      const T* xv =
          static_cast<const T*>(gs.p[g]) +
          voxel_index(v.b, v.z / s + 1, v.y / s + 1, v.x / s, Z / s + 2,
                      Y / s + 2, gs.xs[g]) *
              CPAD;
      const float* sc = aff + g * 2 * MAXC;
      const float* wg = w + g * MAXC * MAXC;  // column 0: the sdf head
      float h = 0.f;
      for (int c = 0; c < gs.cin[g]; ++c) {
        const float a = round_to<T>(
            fmaxf(__fadd_rn(__fmul_rn(to_f(xv[c]), sc[c]), sc[MAXC + c]),
                  0.f));
        h = fmaf(a, __ldg(wg + c * MAXC), h);
      }
      acc = __fadd_rn(acc, h);
    }
  }
  out[idx] = __fadd_rn(__fmul_rn(acc, m), bias[0]);
}

template <typename T, int CPAD>
static int launch_surf_head(const ScaledGroups& g, const void* mask,
                            const float* w, const float* bias,
                            const float* aff, float* out, int B, int Z,
                            int Y, int X, int xq, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * Z * Y * X;
  surf_head_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), w, bias, aff, out, B, Z, Y, X,
      xq * (LANES / CPAD));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// xs / cins / scales / xqs: host arrays of G device pointers, input widths,
// NN-upsample factors and x-block counts; group g is a [B, Z/s+2, Y/s+2,
// xqs[g], 128] grid. mask: the fine mask [B, Z+2, Y+2, xq, 128]; out: a
// float32 [B, Z, Y, X] array.
extern "C" int sgnn_surf_head(const void* const* xs, const int* cins,
                              const int* scales, const int* xqs, int G,
                              const void* mask, const float* w,
                              const float* bias, const float* aff,
                              float* out, int B, int Z, int Y, int X, int xq,
                              int cpad, int bf16, void* stream) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  ScaledGroups g{};
  for (int i = 0; i < G; ++i) {
    const int s = scales[i];
    if (s < 1 || Z % s || Y % s || X % s)
      return static_cast<int>(cudaErrorInvalidValue);
    g.p[i] = xs[i];
    g.cin[i] = cins[i];
    g.scale[i] = s;
    g.xs[i] = xqs[i] * (LANES / cpad);
  }
  g.n = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_surf_head<__nv_bfloat16, 8>(g, mask, w, bias, aff,
                                                     out, B, Z, Y, X, xq, s)
                : launch_surf_head<float, 8>(g, mask, w, bias, aff, out, B,
                                             Z, Y, X, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_surf_head<__nv_bfloat16, 16>(
                      g, mask, w, bias, aff, out, B, Z, Y, X, xq, s)
                : launch_surf_head<float, 16>(g, mask, w, bias, aff, out, B,
                                              Z, Y, X, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
