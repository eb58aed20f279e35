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
// What bounds it on Hopper: bytes. The work is a 16x16 GEMV on the 3-25%
// of voxels whose mask is set; every voxel's mask is read and every output
// grid is written in full (three grids in gate mode, and the f32 raw grid
// when asked; one f32 grid in summed mode), so the writes are most of the
// bytes and the store instructions that carry them set the pace.
// Design: a thread writes one 16-byte chunk of a voxel's output row (CH
// channels: 4 of an f32 row, 8 of a bf16 row), so a voxel's row is K =
// cpad / CH neighbouring threads and a warp stores 512 contiguous bytes
// per output grid. Warps walk rows (b, z, y) of the grid; a z/y ring row
// is written zero without a mask read. A thread takes UNROLL chunks of a
// row at a time and issues their mask reads together, so more reads are in
// flight while the stores drain. Only where a voxel's mask is set does a
// thread read the voxel's whole input row as 16-byte vectors, apply the
// affine to every channel and run the FMA chains of its own CH outputs
// (in gate mode also out2[0]'s chain, so the K threads of a voxel reach
// the same gate with no shuffle). Weights, affines and bias are staged
// once a block in shared memory, and the channel and group loops are
// unrolled. Every output is the FMA chain of
// the kernel this design replaced (channels ascending within a group,
// groups ascending, then + bias), so the outputs keep its bits.
#include "common.cuh"

namespace sgnn {

// One row (b, z, y) of a [B, Zp, Yp, Xs] grid of voxel slots.
struct Row {
  int b, z, y;
  bool ring;  // z or y on the halo ring
};

__device__ __forceinline__ Row row_at(int r, int Zp, int Yp) {
  Row w;
  w.y = r % Yp;
  w.z = r / Yp % Zp;
  w.b = r / (Yp * Zp);
  w.ring = w.z == 0 || w.z == Zp - 1 || w.y == 0 || w.y == Yp - 1;
  return w;
}

// Copies n floats from global to shared memory, block-wide (no barrier).
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) s[i] = g[i];
}

// Chunks a thread takes at a time: their mask reads are issued together.
constexpr int UNROLL = 4;

// Gate mode, one chunk: channels [kk CH, kk CH + CH) of the voxel whose
// input row is xv and mask value m, written at element o of each output.
// sw, sa, sb: the staged weights [MAXC, MAXC], affine [2, MAXC], bias.
template <typename T, int CPAD>
__device__ __forceinline__ void gate_chunk(
    const T* __restrict__ xv, float m, bool ring, int kk, const float* sw,
    const float* sa, const float* sb, long long o, T* __restrict__ upm,
    T* __restrict__ o2m, T* __restrict__ fmn, float* __restrict__ raw) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int K = CPAD / CH;
  const int j0 = kk * CH;
  if (m == 0.f) {
    store_zero<T, CH>(upm + o);
    store_zero<T, CH>(o2m + o);
    store_zero<T, CH>(fmn + o);
    if (raw != nullptr) {  // a masked lhs is zero: out2 is the bias alone
      float b[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) b[j] = ring ? 0.f : sb[j0 + j];
      store_voxel<float, CH>(raw + o, b);
    }
    return;
  }
  float lhs[CPAD];
  load_voxel<T, CPAD>(xv, lhs);
#pragma unroll
  for (int i = 0; i < CPAD; ++i)
    lhs[i] = round_to<T>(affine_relu_mask(lhs[i], sa[i], sa[MAXC + i], m));
  float acc[CH], occ = 0.f;  // acc: out2[j0 ..); occ: out2[0]
#pragma unroll
  for (int j = 0; j < CH; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < CPAD; ++i) {
    const float* wi = sw + i * MAXC;
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[j] = fmaf(lhs[i], wi[j0 + j], acc[j]);
    occ = fmaf(lhs[i], wi[0], occ);
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) acc[j] += sb[j0 + j];
  occ += sb[0];
  const float g = occ > 0.f ? m : 0.f;
  if (raw != nullptr) store_voxel<float, CH>(raw + o, acc);
  float u[CH], h[CH], n[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    float mine = 0.f;  // lhs[j0 + j], selected without a dynamic index
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (q == kk) mine = lhs[q * CH + j];
    u[j] = mine * g;
    h[j] = round_to<T>(acc[j]) * g;
    n[j] = g;
  }
  store_voxel<T, CH>(upm + o, u);
  store_voxel<T, CH>(o2m + o, h);
  store_voxel<T, CH>(fmn + o, n);
}

// Summed mode, one chunk: output channels [j0, j0 + 4) of the voxel at
// element e of the groups' grids, mask value m, written at out.
template <typename T, int CPAD>
__device__ __forceinline__ void sum_chunk(const Groups xs, long long e,
                                          float m, int j0, const float* sw,
                                          const float* sa, const float* sb,
                                          float* __restrict__ out) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (m != 0.f) {  // a masked lhs is zero: the output is the bias alone
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= xs.n) break;
      float t[CPAD];
      load_voxel<T, CPAD>(static_cast<const T*>(xs.p[g]) + e, t);
      const float* sc = sa + g * 2 * MAXC;
      const float* wg = sw + g * MAXC * MAXC;
      const int cin = xs.cin[g];
#pragma unroll
      for (int i = 0; i < CPAD; ++i) {
        if (i >= cin) break;
        const float a =
            round_to<T>(affine_relu_mask(t[i], sc[i], sc[MAXC + i], m));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(a, wg[i * MAXC + j0 + j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = acc[j] + sb[j0 + j];
  store_voxel<float, 4>(out, acc);
}

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    head_gate_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                     const float* __restrict__ w,     // [MAXC, MAXC]
                     const float* __restrict__ bias,  // [MAXC]
                     const float* __restrict__ aff,   // [2, MAXC]
                     int mask_scale, T* __restrict__ upm,
                     T* __restrict__ o2m, T* __restrict__ fmn,
                     float* __restrict__ raw,  // null: no raw output
                     int rows, int Zp, int Yp, int Xs, int Zmp, int Ymp,
                     int Xms) {
  constexpr int CH = 16 / sizeof(T);  // channels of a 16-byte chunk
  constexpr int K = CPAD / CH;        // chunks of a voxel's row
  static_assert(K >= 1 && 32 % K == 0, "a voxel's chunks in one warp");
  __shared__ __align__(16) float sw[MAXC * MAXC];
  __shared__ float sa[2 * MAXC], sb[MAXC];
  stage(sw, w, MAXC * MAXC);
  stage(sa, aff, 2 * MAXC);
  stage(sb, bias, MAXC);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int kk = lane % K, j0 = kk * CH;  // this thread's output channels
  const int len = Xs * K;                 // chunks of a row
  for (int r = blockIdx.x * WARPS + threadIdx.x / 32; r < rows;
       r += gridDim.x * WARPS) {
    const Row row = row_at(r, Zp, Yp);
    const long long v0 = static_cast<long long>(r) * Xs;  // first voxel
    const long long m0 =
        mask_scale == 1 ? v0
                        : voxel_index(row.b, ((row.z - 1) >> 1) + 1,
                                      ((row.y - 1) >> 1) + 1, 0, Zmp, Ymp,
                                      Xms);
    for (int c0 = lane; c0 < len; c0 += 32 * UNROLL) {
      float ms[UNROLL];  // the mask reads of this thread's next chunks
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int vx = (c0 + 32 * u) / K;
        ms[u] = 0.f;
        if (c0 + 32 * u >= len || row.ring) continue;
        if (mask_scale == 1) {
          ms[u] = to_f(mask[(m0 + vx) * CPAD]);
        } else if ((vx >> 1) < Xms) {
          ms[u] = to_f(mask[(m0 + (vx >> 1)) * CPAD]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (c0 + 32 * u >= len) break;
        const long long v = v0 + (c0 + 32 * u) / K;
        gate_chunk<T, CPAD>(x + v * CPAD, ms[u], row.ring, kk, sw, sa, sb,
                            v * CPAD + j0, upm, o2m, fmn, raw);
      }
    }
  }
}

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    head_sum_kernel(Groups xs, const T* __restrict__ mask,
                    const float* __restrict__ w,     // [G, MAXC, MAXC]
                    const float* __restrict__ bias,  // [MAXC]
                    const float* __restrict__ aff,   // [G, 2, MAXC]
                    float* __restrict__ out, int rows, int Zp, int Yp,
                    int Xs) {
  constexpr int CH = 4;         // f32 outputs of a 16-byte chunk
  constexpr int K = CPAD / CH;  // chunks of a voxel's row
  __shared__ __align__(16) float sw[MAXG * MAXC * MAXC];
  __shared__ float sa[MAXG * 2 * MAXC], sb[MAXC];
  stage(sw, w, xs.n * MAXC * MAXC);
  stage(sa, aff, xs.n * 2 * MAXC);
  stage(sb, bias, MAXC);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int j0 = lane % K * CH;  // this thread's output channels
  const int len = Xs * K;
  for (int r = blockIdx.x * WARPS + threadIdx.x / 32; r < rows;
       r += gridDim.x * WARPS) {
    const Row row = row_at(r, Zp, Yp);
    const long long v0 = static_cast<long long>(r) * Xs;
    if (row.ring) {
      for (int c = lane; c < len; c += 32)
        store_zero<float, CH>(out + (v0 + c / K) * CPAD + j0);
      continue;
    }
    for (int c0 = lane; c0 < len; c0 += 32 * UNROLL) {
      float ms[UNROLL];  // the mask reads of this thread's next chunks
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ms[u] = c0 + 32 * u < len
                    ? to_f(mask[(v0 + (c0 + 32 * u) / K) * CPAD])
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (c0 + 32 * u >= len) break;
        const long long v = v0 + (c0 + 32 * u) / K;
        sum_chunk<T, CPAD>(xs, v * CPAD, ms[u], j0, sw, sa, sb,
                           out + v * CPAD + j0);
      }
    }
  }
}

// Blocks for a row walk: one row a warp.
inline unsigned row_blocks(int rows) {
  return static_cast<unsigned>((rows + WARPS - 1) / WARPS);
}

template <typename T, int CPAD>
static int launch_head_gate(const void* x, const void* mask, const float* w,
                            const float* bias, const float* aff,
                            int mask_scale, void* upm, void* o2m, void* fmn,
                            float* raw, int B, int Zp, int Yp, int xq,
                            int Zmp, int Ymp, int xqm, cudaStream_t stream) {
  const int F = LANES / CPAD;
  const int rows = B * Zp * Yp;
  head_gate_kernel<T, CPAD><<<row_blocks(rows), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), w, bias, aff,
      mask_scale, static_cast<T*>(upm), static_cast<T*>(o2m),
      static_cast<T*>(fmn), raw, rows, Zp, Yp, xq * F, Zmp, Ymp, xqm * F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPAD>
static int launch_head_sum(const Groups& g, const void* mask, const float* w,
                           const float* bias, const float* aff,
                           float* out, int B, int Zp, int Yp, int xq,
                           cudaStream_t stream) {
  const int rows = B * Zp * Yp;
  head_sum_kernel<T, CPAD><<<row_blocks(rows), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), w, bias, aff, out, rows, Zp, Yp,
      xq * (LANES / CPAD));
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
