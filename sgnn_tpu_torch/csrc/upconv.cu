// K3, the fused generative upsample-conv site.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_upconv_folded
// (:1055), body _kernel_upconv (:771); called by ops/folded.py upconv_fused
// (:691).
//
//   out[f] = round(fmask[f] * sum_g conv3(nn_up2(in_g'))[f])
//   in_g'  = round(relu(in_g * scale_g + bias_g) * cmask)   (affine)
//
// computed straight from the coarse grids: along each axis fine f = 2q + p
// reads coarse q + p - 1 + e (e in {0, 1}), so a fine voxel has 8 coarse
// taps whose weights are the parity's sums of the 27 original taps
// (summed in f32, then rounded: the prepared [G, 8 parity, 8 tap] array,
// the same combination as _fold_upsample_weights:732). Taps that fall on
// the coarse z/y ring read its zeros; x taps outside [0, Xsc) are skipped.
// The fine mask is read from fmask, or expanded from the coarse mask when
// fmask is null (the serving case: no fine mask exists in memory).
//
// What bounds it on Hopper: the bytes. Every fine voxel is written (8x the
// coarse grid's bytes) and its mask read, whatever the mask; the coarse
// groups are needed only around active voxels, and the 8 * G * cin * cout
// MACs of an active fine voxel take less than the bytes' time even as f32
// FMAs on the CUDA cores (phase 3's G3 case: 0.04 ms of bytes).
//
// Design of the exact modes, K1's (conv_site.cu) carried to the upsample:
// one block of 256 threads per fine output brick of 2 x 4 x 32 voxels
// (below), one voxel a thread.
// - Skip: each thread reads its fine voxel's mask (the coarse parent's
//   when fmask is null); a masked voxel and every halo-ring row write +0 at
//   once as 16-byte vectors, so a brick with no active fine voxel (most of
//   a scene) ends at its one barrier and stages nothing.
// - Stage: an active brick copies each group's coarse window (3 x 4 x 18
//   halo'd coarse voxels, x outside [0, Xsc) zero) into shared memory by
//   cp.async, two buffers deep across groups (group g + 1's copies fly
//   while group g computes), and with the affine the window's coarse mask
//   once; each staged coarse value is then transformed once, in place,
//   round(relu(x s + b) m_coarse) in the compute type (the replaced kernel
//   did so once per fine tap that read it, 64 times a value).
// - Rows: the brick's active fine voxels compacted into a list grouped by
//   parity (pz, py, px), so a warp's rows share one parity and its weight
//   loads one address per group of output channels.
// - Sums, both modes: f32 FMAs on the CUDA cores in the replaced kernel's
//   order (group, coarse tap e = (ez * 2 + ey) * 2 + ex, channel), a row's
//   output channels split 4 to a thread, a tap's weights of those channels
//   loaded into registers before its FMAs (the time goes to the weight
//   loads: this ran faster than 8 channels a thread loading as they went,
//   than two rows a thread sharing each load, and than a warp a parity
//   with each channel's weights in registers). A skipped masked coarse tap, a
//   zero-filled x tap and a channel >= cin add exactly nothing (the sums
//   start at +0 and never become -0), so every output is the replaced
//   kernel's bit for bit: the serving forward's bf16 surface is a draw of
//   its occupancy gates from exactly these sums (PERF.md, Findings; K1
//   keeps its order for the same reason). No tensor cores.
//
// K3q, the int8 mode (quantize=True, _kernel_upconv :868-923), keeps the
// first port's design: one thread per fine voxel with all output channels
// in registers (inactive voxels write zeros and stop). The fine voxel
// reads its TPU tile's amax per group (tile (iz, iy) holds fine interior
// rows [iz tz, (iz + 1) tz) x [iy ty, (iy + 1) ty); its window is the
// coarse halo'd rows under them), quantizes each coarse tap's f32 input
// on the fly, sums int8 products in int32 with __dp4a against int8
// weights [G, 8 parity, 8 tap, co, ci], and dequantizes per group with
// the scale of its fine x parity px, acc += f32(iacc) * (s * ws[g, px,
// co]), before the fine mask.
#include "common.cuh"

namespace sgnn {

// K3's fine output brick (common.cuh: BZ x BY x BX = 2 x 4 x 32 voxels of
// the padded fine grid, x fastest, warp w = brick row w) starts at padded
// fine row zb = 2 kz - 1, yb = 4 ky - 1 and slot x0 = 32 kx: its first
// interior z and y are even, and the bricks also cover the z/y halo ring
// (row -1 or Zfp of a ring brick lies outside the grid). Its fine voxels'
// taps read a window of UZ x UY x UX coarse halo'd voxels with origin
// (kz - 1, 2 ky - 1, 16 kx - 1); fine voxel (vz, vy, vx) of the brick, of
// parity (vz, vy & 1, vx & 1), reads window voxel (vz + ez, (vy + 1) / 2 +
// ey, (vx + 1) / 2 + ex) for its coarse tap e = (ez * 2 + ey) * 2 + ex.
constexpr int UZ = BZ / 2 + 2, UY = BY / 2 + 2, UX = BX / 2 + 2;
constexpr int NU = UZ * UY * UX;  // staged coarse voxels

// Shared memory of a K3 block, byte offsets.
template <typename T, int CPAD>
struct UpSmem {
  static constexpr int SLOT = CPAD * static_cast<int>(sizeof(T));
  static constexpr int BUF = NU * SLOT;       // a staged group's window
  static constexpr int IN = 0;                // group g in buffer g % 2
  static constexpr int HM = IN + 2 * BUF;     // float [NU] coarse mask
  static constexpr int M = HM + NU * 4;       // float [NV] fine mask
  static constexpr int AFF = M + NV * 4;      // float [G][2][MAXC]
  static constexpr int LIST = AFF + MAXG * 2 * MAXC * 4;  // ushort [NV]
  static constexpr int CNT = LIST + NV * 2;   // int [WARPS][2]
  static constexpr int BYTES = CNT + WARPS * 2 * 4;
};

// parity (pz, py, px) of the brick's fine voxel v, as (pz * 2 + py) * 2 + px
__device__ __forceinline__ int parity_of(int v) {
  return ((v / (BY * BX) * 2 + (v / BX & 1)) * 2) + (v & 1);
}

// After the barrier that follows cnt[w][px] (the active voxels of brick
// row w with x parity px): list[0, rows) = the brick's active voxels
// grouped by parity, in brick order within a parity (visible after the
// next barrier); returns rows.
__device__ __forceinline__ int list_by_parity(bool active, const int* cnt,
                                              unsigned short* list) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned ball = __ballot_sync(0xffffffffu, active);
  const int mine = parity_of(tid);
  int off = 0, rows = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    // parity p's voxels: brick rows w0 and w0 + 2, x parity p & 1
    const int w0 = (p >> 2) * BY + (p >> 1 & 1), px = p & 1;
    const int n0 = cnt[w0 * 2 + px];
    if (p == mine) off = rows + (warp == w0 + 2 ? n0 : 0);
    rows += n0 + cnt[(w0 + 2) * 2 + px];
  }
  const unsigned same = lane & 1 ? 0xaaaaaaaau : 0x55555555u;
  if (active) list[off + __popc(ball & same & ((1u << lane) - 1u))] = tid;
  return rows;
}

// bf16: 3 blocks of 256 threads an SM, f32 2, as K1 (shared memory at
// cpad 16: ~17 KB bf16, ~31 KB f32; 4 bf16 blocks ran no faster)
template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 2)
    upconv_kernel(Groups xs, const T* __restrict__ cmask,
                  const T* __restrict__ fmask,  // null: expand cmask
                  const float* __restrict__ w,  // [G, 8, 8, MAXC, MAXC]
                  const float* __restrict__ aff,  // [G, 2, MAXC] or null
                  T* __restrict__ out, int Zfp, int Yfp, int Xsf, int Zcp,
                  int Ycp, int Xsc, int nbz) {
  using S = UpSmem<T, CPAD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.z / nbz, kz = blockIdx.z % nbz, ky = blockIdx.y;
  const int zb = 2 * kz - 1, yb = 4 * ky - 1, x0 = blockIdx.x * BX;
  // this thread's fine voxel: its mask (the coarse parent's when fmask is
  // null; 0 on the halo ring); a masked voxel and the ring write +0 at once
  const int z = zb + tid / (BY * BX), y = yb + tid / BX % BY,
            x = x0 + tid % BX;
  const bool inside = z >= 0 && z < Zfp && y >= 0 && y < Yfp && x < Xsf;
  const bool ring = z == 0 || z == Zfp - 1 || y == 0 || y == Yfp - 1;
  const long long idx = inside ? voxel_index(b, z, y, x, Zfp, Yfp, Xsf) : 0;
  float m = 0.f;
  if (inside && !ring) {
    if (fmask != nullptr) {
      m = to_f(fmask[idx * CPAD]);
    } else {
      const int cx = x >> 1;
      m = cx < Xsc ? to_f(cmask[voxel_index(b, ((z - 1) >> 1) + 1,
                                            ((y - 1) >> 1) + 1, cx, Zcp,
                                            Ycp, Xsc) * CPAD])
                   : 0.f;
    }
  }
  if (inside && m == 0.f) store_zero<T, CPAD>(out + idx * CPAD);
  if (!__syncthreads_or(m != 0.f)) return;

  // an active brick: group 0's copies first, then the masks, affines and
  // row list
  const int cz0 = kz - 1, cy0 = 2 * ky - 1, cx0 = x0 / 2 - 1;
  unsigned char* bufs[2] = {smem + S::IN, smem + S::IN + S::BUF};
  copy_window<T, CPAD, UZ, UY, UX>(smem_addr(bufs[0]),
                                   static_cast<const T*>(xs.p[0]), b, cz0,
                                   cy0, cx0, Zcp, Ycp, Xsc);
  float* hm = reinterpret_cast<float*>(smem + S::HM);
  float* sm = reinterpret_cast<float*>(smem + S::M);
  float* sa = reinterpret_cast<float*>(smem + S::AFF);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + S::LIST);
  int* cnt = reinterpret_cast<int*>(smem + S::CNT);
  sm[tid] = m;
  const unsigned ball = __ballot_sync(0xffffffffu, m != 0.f);
  if (tid % 32 < 2) {
    cnt[tid / 32 * 2 + tid % 32] =
        __popc(ball & (tid % 2 ? 0xaaaaaaaau : 0x55555555u));
  }
  if (aff != nullptr) {
    for (int i = tid; i < xs.n * 2 * MAXC; i += THREADS) sa[i] = aff[i];
    for (int i = tid; i < NU; i += THREADS) {
      const int cz = cz0 + i / (UY * UX), cy = cy0 + i / UX % UY,
                cx = cx0 + i % UX;
      hm[i] = cz >= 0 && cz < Zcp && cy >= 0 && cy < Ycp && cx >= 0 &&
                      cx < Xsc
                  ? to_f(cmask[voxel_index(b, cz, cy, cx, Zcp, Ycp, Xsc) *
                               CPAD])
                  : 0.f;
    }
  }
  __syncthreads();
  const int rows = list_by_parity(m != 0.f, cnt, list);

  // each row's fine voxel is summed over the staged groups in f32 FMAs, in
  // the order of the one-thread-per-voxel kernel this design replaced
  // (group, coarse tap e, channel; with the affine a masked coarse tap
  // skipped), so its outputs are that kernel's bit for bit. A row's CPAD
  // output channels are split over TPV threads, CPT each: thread t takes
  // row j RPP + t / TPV (j < NP) and channels CPT (t % TPV) ..
  constexpr int CPT = 4;  // output channels a thread
  constexpr int TPV = CPAD / CPT, RPP = THREADS / TPV, NP = NV / RPP;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int co0 = tid % TPV * CPT;
  float acc[NP][CPT];
  int vr[NP], s0[NP], par[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    vr[j] = -1;
    s0[j] = par[j] = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[j][c] = 0.f;
  }
  for (int g = 0; g < xs.n; ++g) {
    const int cin = xs.cin[g];
    unsigned char* buf = bufs[g % 2];
    if (g + 1 < xs.n) {
      copy_window<T, CPAD, UZ, UY, UX>(
          smem_addr(bufs[(g + 1) % 2]), static_cast<const T*>(xs.p[g + 1]),
          b, cz0, cy0, cx0, Zcp, Ycp, Xsc);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (g == 0) {  // the list is visible from here on
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int r = j * RPP + tid / TPV;
        if (r < rows) {
          const int v = list[r];
          const int vz = v / (BY * BX), vy = v / BX % BY, vx = v % BX;
          vr[j] = v;
          par[j] = parity_of(v);
          s0[j] = (vz * UY + (vy + 1) / 2) * UX + (vx + 1) / 2;
        }
      }
    }
    if (aff != nullptr) {
      affine_window<T, CPAD, NU>(buf, cin, sa + g * 2 * MAXC, hm);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (vr[j] < 0) continue;
      const float* wg = w + ((g * 8 + par[j]) * 8) * MAXC * MAXC + co0;
#pragma unroll 1
      for (int e = 0; e < 8; ++e) {  // e = (ez * 2 + ey) * 2 + ex
        const int slot =
            s0[j] + ((e >> 2) * UY + (e >> 1 & 1)) * UX + (e & 1);
        if (aff != nullptr && hm[slot] == 0.f) continue;
        // the tap's weights of this thread's CPT channels, all loads in
        // flight before the first FMA
        const float4* wt =
            reinterpret_cast<const float4*>(wg + e * MAXC * MAXC);
        float4 wr[CPAD];
#pragma unroll
        for (int ci = 0; ci < CPAD; ++ci) {
          wr[ci] = ci < cin ? __ldg(wt + ci * (MAXC / 4))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        uint4 u[S::SLOT / 16];
#pragma unroll
        for (int q = 0; q < S::SLOT / 16; ++q)
          u[q] = *reinterpret_cast<const uint4*>(buf + slot * S::SLOT + q * 16);
#pragma unroll
        for (int q = 0; q < S::SLOT / 16; ++q) {
          const T* t = reinterpret_cast<const T*>(&u[q]);
#pragma unroll
          for (int k = 0; k < E; ++k) {
            if (q * E + k < cin) {
              const float a = to_f(t[k]);
              const float4 wv = wr[q * E + k];
              acc[j][0] = fmaf(a, wv.x, acc[j][0]);
              acc[j][1] = fmaf(a, wv.y, acc[j][1]);
              acc[j][2] = fmaf(a, wv.z, acc[j][2]);
              acc[j][3] = fmaf(a, wv.w, acc[j][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (vr[j] < 0) continue;
    const int v = vr[j];
    const float mv = sm[v];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[j][c] = __fmul_rn(acc[j][c], mv);
    T* o = out + voxel_index(b, zb + v / (BY * BX), yb + v / BX % BY,
                             x0 + v % BX, Zfp, Yfp, Xsf) * CPAD + co0;
    if constexpr (CPT * sizeof(T) % 16 == 0) {
      store_voxel<T, CPT>(o, acc[j]);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[c] = from_f<T>(acc[j][c]);
    }
  }
}

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    upconv_q_kernel(Groups xs, const T* __restrict__ cmask,
                    const T* __restrict__ fmask,  // null: expand cmask
                    const int4* __restrict__ wq,  // [G, 8, 8, MAXC] x 16
                    const float* __restrict__ ws,   // [G, 2, MAXC]
                    const float* __restrict__ aff,  // [G, 2, MAXC] or null
                    const float* __restrict__ amax,  // [B, nz, ny, G]
                    T* __restrict__ out, int B, int Zfp, int Yfp, int Xsf,
                    int Zcp, int Ycp, int Xsc, int tz, int ty, int nz,
                    int ny) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zfp * Yfp * Xsf) return;
  const Voxel v = decode(idx, Zfp, Yfp, Xsf);
  T* o = out + idx * CPAD;
  if (v.z == 0 || v.z == Zfp - 1 || v.y == 0 || v.y == Yfp - 1) {
    store_zero<T, CPAD>(o);
    return;
  }
  const int qz = v.z - 1, qy = v.y - 1;  // fine interior coordinates
  float m;
  if (fmask != nullptr) {
    m = to_f(fmask[idx * CPAD]);
  } else {
    const int cx = v.x >> 1;
    m = cx < Xsc ? to_f(cmask[voxel_index(v.b, (qz >> 1) + 1, (qy >> 1) + 1,
                                          cx, Zcp, Ycp, Xsc) * CPAD])
                 : 0.f;
  }
  if (m == 0.f) {
    store_zero<T, CPAD>(o);
    return;
  }
  const int pz = qz & 1, py = qy & 1, px = v.x & 1;
  const int par = (pz * 2 + py) * 2 + px;
  const float* am = amax + ((static_cast<long long>(v.b) * nz + qz / tz) *
                                ny + qy / ty) * xs.n;
  float acc[CPAD];
#pragma unroll
  for (int c = 0; c < CPAD; ++c) acc[c] = 0.f;
  for (int g = 0; g < xs.n; ++g) {
    const T* __restrict__ xg = static_cast<const T*>(xs.p[g]);
    const int cin = xs.cin[g];
    const float* sc = aff != nullptr ? aff + g * 2 * MAXC : nullptr;
    const float s = tile_scale(am[g]);
    const float inv = 1.0f / s;
    int iacc[CPAD];
#pragma unroll
    for (int c = 0; c < CPAD; ++c) iacc[c] = 0;
    for (int e = 0; e < 8; ++e) {  // e = (ez * 2 + ey) * 2 + ex
      const int ez = e >> 2, ey = (e >> 1) & 1, ex = e & 1;
      const int cx = (v.x >> 1) + px - 1 + ex;
      if (cx < 0 || cx >= Xsc) continue;
      const long long nv = voxel_index(v.b, (qz >> 1) + pz + ez,
                                       (qy >> 1) + py + ey, cx, Zcp, Ycp,
                                       Xsc) * CPAD;
      float mi = 1.f;
      if (sc != nullptr) {
        mi = to_f(cmask[nv]);
        if (mi == 0.f) continue;
      }
      int words[CPAD / 4];
      if (!quantize_voxel<T, CPAD>(xg + nv, cin, sc, mi, inv, words))
        continue;
      dp4a_voxel<CPAD, CPAD>(iacc, words,
                             wq + ((g * 8 + par) * 8 + e) * MAXC);
    }
    dequant_add<CPAD>(acc, iacc, s, ws + (g * 2 + px) * MAXC);
  }
#pragma unroll
  for (int c = 0; c < CPAD; ++c) o[c] = from_f<T>(acc[c] * m);
}

template <typename T, int CPAD>
static int launch_upconv_q(const Groups& g, const void* cmask,
                           const void* fmask, const void* wq,
                           const float* ws, const float* aff,
                           const float* amax, void* out, int B, int Zcp,
                           int Ycp, int xqc, int xqf, int tz, int ty, int nz,
                           int ny, cudaStream_t stream) {
  const int F = LANES / CPAD;
  const int Zfp = 2 * (Zcp - 2) + 2;
  const int Yfp = 2 * (Ycp - 2) + 2;
  const int Xsf = xqf * F;
  const long long n = static_cast<long long>(B) * Zfp * Yfp * Xsf;
  upconv_q_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(cmask), static_cast<const T*>(fmask),
      static_cast<const int4*>(wq), ws, aff, amax, static_cast<T*>(out), B,
      Zfp, Yfp, Xsf, Zcp, Ycp, xqc * F, tz, ty, nz, ny);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPAD>
static int launch_upconv(const Groups& g, const void* cmask,
                         const void* fmask, const float* w, const float* aff,
                         void* out, int B, int Zcp, int Ycp,
                         int xqc, int xqf, cudaStream_t stream) {
  const int F = LANES / CPAD;
  const int Zfp = 2 * (Zcp - 2) + 2;
  const int Yfp = 2 * (Ycp - 2) + 2;
  const int Xsf = xqf * F;
  // bricks over padded fine rows -1 .. Zfp - 1 and -1 .. Yfp - 1 (the
  // ring too)
  const int nbz = (Zfp + 1 + BZ - 1) / BZ, nby = (Yfp + 1 + BY - 1) / BY;
  const long long nz = static_cast<long long>(B) * nbz;
  if (nz > 65535 || nby > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Xsf + BX - 1) / BX, nby, static_cast<unsigned>(nz));
  upconv_kernel<T, CPAD><<<grid, THREADS, UpSmem<T, CPAD>::BYTES, stream>>>(
      g, static_cast<const T*>(cmask), static_cast<const T*>(fmask), w, aff,
      static_cast<T*>(out), Zfp, Yfp, Xsf, Zcp, Ycp, xqc * F, nbz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// xs / cins: host arrays of G coarse device pointers and input widths.
// fmask, aff: null when absent.
extern "C" int sgnn_upconv(const void* const* xs, const int* cins, int G,
                           const void* cmask, const void* fmask,
                           const float* w, const float* aff,
                           void* out, int B, int Zcp, int Ycp, int xqc,
                           int xqf, int cpad, int bf16, void* stream) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  Groups g{};
  for (int i = 0; i < G; ++i) {
    g.p[i] = xs[i];
    g.cin[i] = cins[i];
  }
  g.n = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_upconv<__nv_bfloat16, 8>(g, cmask, fmask, w, aff,
                                                  out, B, Zcp, Ycp,
                                                  xqc, xqf, s)
                : launch_upconv<float, 8>(g, cmask, fmask, w, aff, out,
                                          B, Zcp, Ycp, xqc, xqf, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_upconv<__nv_bfloat16, 16>(g, cmask, fmask, w, aff,
                                                   out, B, Zcp, Ycp,
                                                   xqc, xqf, s)
                : launch_upconv<float, 16>(g, cmask, fmask, w, aff,
                                           out, B, Zcp, Ycp, xqc, xqf, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 mode: wq int8 [G, 8, 8, 16, 16] (co, ci), ws [G, 2, 16], amax
// [B, nz, ny, G] from sgnn_tile_amax, (tz, ty) the TPU tile in fine rows.
extern "C" int sgnn_upconv_q(const void* const* xs, const int* cins, int G,
                             const void* cmask, const void* fmask,
                             const void* wq, const float* ws,
                             const float* aff, const float* amax, void* out,
                             int B, int Zcp, int Ycp, int xqc, int xqf,
                             int cpad, int tz, int ty, int nz, int ny,
                             int bf16, void* stream) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  Groups g{};
  for (int i = 0; i < G; ++i) {
    g.p[i] = xs[i];
    g.cin[i] = cins[i];
  }
  g.n = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpad == 8) {
    return bf16 ? launch_upconv_q<__nv_bfloat16, 8>(
                      g, cmask, fmask, wq, ws, aff, amax, out, B, Zcp, Ycp,
                      xqc, xqf, tz, ty, nz, ny, s)
                : launch_upconv_q<float, 8>(g, cmask, fmask, wq, ws, aff,
                                            amax, out, B, Zcp, Ycp, xqc, xqf,
                                            tz, ty, nz, ny, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_upconv_q<__nv_bfloat16, 16>(
                      g, cmask, fmask, wq, ws, aff, amax, out, B, Zcp, Ycp,
                      xqc, xqf, tz, ty, nz, ny, s)
                : launch_upconv_q<float, 16>(g, cmask, fmask, wq, ws, aff,
                                             amax, out, B, Zcp, Ycp, xqc,
                                             xqf, tz, ty, nz, ny, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
