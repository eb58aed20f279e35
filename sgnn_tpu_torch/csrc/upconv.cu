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
// K3q, the int8 mode. Replaces: the same fused_upconv_folded with
// quantize=True, int8 body of _kernel_upconv (:868-923). Each coarse value
// of group g is quantized, q = clip(rint(tf / s), -127, 127) with tf the f32
// site input (the affine's value before any rounding to the compute type,
// relu(x s + b) m_coarse, else x) and s the scale of the TPU tile that
// holds the FINE output row (tile (iz, iy) holds fine interior rows
// [iz tz, (iz + 1) tz) x [iy ty, (iy + 1) ty)); the int8 products sum
// exactly in int32 and each group dequantizes as acc += f32(iacc) * (s *
// ws[g, px, co]), px the fine x parity, before the fine mask. What bounds
// it: the bytes, as K3; its 8 * G * cin * cout MACs per active fine voxel
// are s8 products (1,979 TOP/s on the tensor cores).
// Design: K3's bricks, skip, staging and parity-grouped rows, with the
// int8 products on the tensor cores, as K1q (conv_site.cu) does in K1's.
// - Skip and stage as K3: masked voxels and the ring written +0 at once, a
//   brick with no active voxel ends at its one barrier, each group's coarse
//   window staged by cp.async two buffers deep, but kept raw (no in-place
//   affine: the int8 value comes from the f32 affine value, and rounding
//   it to T first would move some values one step).
// - Quantize once per staged value and distinct tile: tz is even, so a
//   brick's 2 z rows lie in one z tile, but its 4 y rows can straddle two y
//   tiles (always at ty = 2). For each group and each distinct tile among
//   the brick's active rows, the staged window is quantized once into an
//   int8 window (quantize_window, common.cuh); zero-filled x taps and
//   masked coarse taps quantize to 0 and add exactly nothing.
// - Sums on mma.sync m16n8k32 s8 x s8 -> s32. The rows are cut into MMA
//   tiles of 16 rows of ONE parity (a parity's up to 32 rows make one or
//   two tiles, a partial tile padded with rows that read slot 0 and are
//   dropped; at most 16 tiles, two a warp), so a tile's B fragments are
//   the int8 weights wq[g, parity] (k-contiguous per output channel, read
//   through L1) and its ws row is one x parity's. A is 16 rows x 32 int8
//   values, read from the int8 window as one 32-bit word a lane and row:
//   at cpad 16 two taps of 16 bytes (4 k-steps over the 8 taps), at cpad 8
//   four 8-byte taps (2 k-steps), each lane's word half of one tap (lanes
//   tig 0-1 the first tap of the pair, 2-3 the second). Integer sums are
//   exact in any order; each row keeps its own tile's sums.
// - Epilogue: per row, in group order, acc += f32(iacc) * (s * ws) with
//   every product and sum rounded on its own (from +0), times the fine
//   mask, rounded once to T into shared memory, then out as 16-byte
//   vectors: the plain version's values bit for bit.
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

// Fine voxel (b, z, y, x)'s mask: fmask's, or the coarse parent's when
// fmask is null; 0 on the halo ring and outside the grid. A masked voxel
// inside the grid is written +0 at once as 16-byte vectors, whatever its
// brick does.
template <typename T, int CPAD>
__device__ __forceinline__ float fine_mask(const T* __restrict__ cmask,
                                           const T* __restrict__ fmask,
                                           T* __restrict__ out, int b, int z,
                                           int y, int x, int Zfp, int Yfp,
                                           int Xsf, int Zcp, int Ycp,
                                           int Xsc) {
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
  return m;
}

// An active brick's masks, before a barrier: sm[v] each fine voxel's,
// cnt[w][px] the active voxels of brick row w with x parity px; with an
// affine aff ([G, 2, MAXC]) also sa = aff and hm[i] the coarse window's
// mask (0 outside the grid), window origin (cz0, cy0, cx0).
template <typename T, int CPAD>
__device__ __forceinline__ void stage_up_masks(
    float m, const T* __restrict__ cmask, const float* __restrict__ aff,
    int G, int b, int cz0, int cy0, int cx0, int Zcp, int Ycp, int Xsc,
    float* sm, int* cnt, float* sa, float* hm) {
  const int tid = threadIdx.x;
  sm[tid] = m;
  const unsigned ball = __ballot_sync(0xffffffffu, m != 0.f);
  if (tid % 32 < 2) {
    cnt[tid / 32 * 2 + tid % 32] =
        __popc(ball & (tid % 2 ? 0xaaaaaaaau : 0x55555555u));
  }
  if (aff != nullptr) {
    for (int i = tid; i < G * 2 * MAXC; i += THREADS) sa[i] = aff[i];
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
}

// staged window slot of the brick's fine voxel v (its coarse tap e = 0)
__device__ __forceinline__ int window_slot(int v) {
  const int vz = v / (BY * BX), vy = v / BX % BY, vx = v % BX;
  return (vz * UY + (vy + 1) / 2) * UX + (vx + 1) / 2;
}

// offset between window slots of coarse taps e and 0, e = (ez * 2 + ey) *
// 2 + ex
__device__ __forceinline__ int window_tap(int e) {
  return ((e >> 2) * UY + (e >> 1 & 1)) * UX + (e & 1);
}

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
  const float m = fine_mask<T, CPAD>(
      cmask, fmask, out, b, zb + tid / (BY * BX), yb + tid / BX % BY,
      x0 + tid % BX, Zfp, Yfp, Xsf, Zcp, Ycp, Xsc);
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
  stage_up_masks<T, CPAD>(m, cmask, aff, xs.n, b, cz0, cy0, cx0, Zcp, Ycp,
                          Xsc, sm, cnt, sa, hm);
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
          vr[j] = list[r];
          par[j] = parity_of(vr[j]);
          s0[j] = window_slot(vr[j]);
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
        const int slot = s0[j] + window_tap(e);
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

// Shared memory of a K3q block, byte offsets.
template <typename T, int CPAD>
struct UpQSmem {
  static constexpr int SLOT = CPAD * static_cast<int>(sizeof(T));
  static constexpr int BUF = NU * SLOT;       // a staged group's window
  static constexpr int NT = CPAD / 8;         // 8-wide N tiles
  static constexpr int IN = 0;   // group g in buffer g % 2; then the outputs
  static constexpr int Q = IN + 2 * BUF;      // int8 [NU][CPAD]
  static constexpr int HM = Q + NU * CPAD;    // float [NU] coarse mask
  static constexpr int M = HM + NU * 4;       // float [NV] fine mask
  static constexpr int AFF = M + NV * 4;      // float [G][2][MAXC]
  static constexpr int LIST = AFF + MAXG * 2 * MAXC * 4;  // ushort [NV]
  static constexpr int CNT = LIST + NV * 2;   // int [WARPS][2]
  static constexpr int KEY = CNT + WARPS * 2 * 4;  // int [WARPS]
  static constexpr int BYTES = KEY + WARPS * 4;
  static_assert(NV * SLOT <= 2 * BUF, "the outputs fit the two buffers");
  static_assert(BYTES <= 48 * 1024, "no opt-in shared memory needed");
};

// MMA tile t of a brick's parity-grouped rows (list_by_parity's order,
// cnt as it counts): parity p's rows make tiles of 16, the last one
// partial. Sets (parity, first row, rows) of tile t; parity -1 when the
// brick has fewer tiles.
__device__ __forceinline__ void parity_tile(int t, const int* cnt, int& par,
                                            int& r0, int& n) {
  par = -1;
  r0 = n = 0;
  int first = 0, off = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int w0 = (p >> 2) * BY + (p >> 1 & 1), px = p & 1;
    const int np = cnt[w0 * 2 + px] + cnt[(w0 + 2) * 2 + px];
    const int nt = (np + 15) / 16;
    if (par < 0 && t < first + nt) {
      par = p;
      r0 = off + 16 * (t - first);
      n = min(16, np - 16 * (t - first));
    }
    first += nt;
    off += np;
  }
}

// int8 products of one MMA tile (this lane's rows gid and gid + 8 at
// window slots s0, s1) with one (group, parity)'s int8 weights wp [8 tap,
// co, ci] over the int8 window q: ia[nt] = the C fragment of N tile nt.
// k = 32 j + 16 h + 4 tig .. + 3 is tap TPK j + k / CPAD, channels
// k % CPAD ..: a lane's A word of a row is one 32-bit load (at cpad 8 half
// of an 8-byte tap).
template <int CPAD>
__device__ __forceinline__ void mma_tile_s8(const unsigned char* q, int s0,
                                            int s1,
                                            const int* __restrict__ wp,
                                            int (*ia)[4]) {
  constexpr int TPK = 32 / CPAD, KSTEPS = 8 / TPK, NT = CPAD / 8;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ia[nt][e] = 0;
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    unsigned a[4], b[NT][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * h + 4 * tig;
      const int tap = TPK * j + k / CPAD, ci = k % CPAD;
      const int off = window_tap(tap) * CPAD + ci;
      a[2 * h] = *reinterpret_cast<const unsigned*>(q + s0 * CPAD + off);
      a[2 * h + 1] = *reinterpret_cast<const unsigned*>(q + s1 * CPAD + off);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        b[nt][h] = static_cast<unsigned>(
            __ldg(wp + ((tap * MAXC + nt * 8 + gid) * MAXC + ci) / 4));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_s8(ia[nt], a, b[nt]);
  }
}

// bf16: 3 blocks of 256 threads an SM, f32 2, as K3 (shared memory at
// cpad 16: ~20 KB bf16, ~34 KB f32)
template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 2)
    upconv_q_kernel(Groups xs, const T* __restrict__ cmask,
                    const T* __restrict__ fmask,  // null: expand cmask
                    const int* __restrict__ wq,   // int8 [G, 8, 8, co, ci]
                    const float* __restrict__ ws,   // [G, 2, MAXC]
                    const float* __restrict__ aff,  // [G, 2, MAXC] or null
                    const float* __restrict__ amax,  // [B, nz, ny, G]
                    T* __restrict__ out, int Zfp, int Yfp, int Xsf, int Zcp,
                    int Ycp, int Xsc, int nbz, int tz, int ty, int nz,
                    int ny) {
  using S = UpQSmem<T, CPAD>;
  constexpr int NT = S::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int b = blockIdx.z / nbz, kz = blockIdx.z % nbz, ky = blockIdx.y;
  const int zb = 2 * kz - 1, yb = 4 * ky - 1, x0 = blockIdx.x * BX;
  const float m = fine_mask<T, CPAD>(
      cmask, fmask, out, b, zb + tid / (BY * BX), yb + tid / BX % BY,
      x0 + tid % BX, Zfp, Yfp, Xsf, Zcp, Ycp, Xsc);
  if (!__syncthreads_or(m != 0.f)) return;

  // an active brick: group 0's copies first, then the masks, affines, each
  // brick row's TPU tile (key iz * ny + iy; -1 for a row with no active
  // voxel, as every ring row) and the row list
  const int cz0 = kz - 1, cy0 = 2 * ky - 1, cx0 = x0 / 2 - 1;
  unsigned char* bufs[2] = {smem + S::IN, smem + S::IN + S::BUF};
  unsigned char* qw = smem + S::Q;
  copy_window<T, CPAD, UZ, UY, UX>(smem_addr(bufs[0]),
                                   static_cast<const T*>(xs.p[0]), b, cz0,
                                   cy0, cx0, Zcp, Ycp, Xsc);
  float* hm = reinterpret_cast<float*>(smem + S::HM);
  float* sm = reinterpret_cast<float*>(smem + S::M);
  float* sa = reinterpret_cast<float*>(smem + S::AFF);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + S::LIST);
  int* cnt = reinterpret_cast<int*>(smem + S::CNT);
  int* key = reinterpret_cast<int*>(smem + S::KEY);
  stage_up_masks<T, CPAD>(m, cmask, aff, xs.n, b, cz0, cy0, cx0, Zcp, Ycp,
                          Xsc, sm, cnt, sa, hm);
  {
    const bool row_active = __any_sync(0xffffffffu, m != 0.f);
    const int z = zb + warp / BY, y = yb + warp % BY;
    if (lane == 0)
      key[warp] = row_active ? (z - 1) / tz * ny + (y - 1) / ty : -1;
  }
  __syncthreads();
  const int rows = list_by_parity(m != 0.f, cnt, list);

  // warp w takes MMA tiles w and w + WARPS; this lane holds rows gid and
  // gid + 8 of each (its A rows and C rows): list row lr (-1: padding),
  // window slot, tile key
  int par[2], lr[2][2], slot[2][2], rkey[2][2];
  float acc[2][NT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
  }
  for (int g = 0; g < xs.n; ++g) {
    const int cin = xs.cin[g];
    const unsigned char* buf = bufs[g % 2];
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
      for (int j = 0; j < 2; ++j) {
        int r0, n;
        parity_tile(warp + j * WARPS, cnt, par[j], r0, n);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = gid + 8 * hi;
          const bool ok = i < n;
          const int v = ok ? list[r0 + i] : 0;
          lr[j][hi] = ok ? r0 + i : -1;
          slot[j][hi] = ok ? window_slot(v) : 0;
          rkey[j][hi] = ok ? key[v / BX] : -1;
        }
      }
    }
    const float* sag = aff != nullptr ? sa + g * 2 * MAXC : nullptr;
    // one pass per distinct tile among the brick rows, in row order
    for (int wr = 0; wr < WARPS; ++wr) {
      const int k = key[wr];
      bool seen = k < 0;
      for (int p = 0; p < wr; ++p) seen = seen || key[p] == k;
      if (seen) continue;
      const float s = tile_scale(
          amax[(static_cast<long long>(b) * nz * ny + k) * xs.n + g]);
      quantize_window<T, CPAD, NU>(buf, qw, cin, sag, hm, 1.0f / s);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool mine = rkey[j][0] == k || rkey[j][1] == k;
        if (!__any_sync(0xffffffffu, mine)) continue;
        const int* wp = wq + (g * 8 + par[j]) * 8 * MAXC * MAXC / 4;
        const float* wsg = ws + (g * 2 + (par[j] & 1)) * MAXC;
        int ia[NT][4];
        mma_tile_s8<CPAD>(qw, slot[j][0], slot[j][1], wp, ia);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (rkey[j][e / 2] != k) continue;
            const int co = nt * 8 + 2 * tig + e % 2;
            acc[j][nt][e] = __fadd_rn(
                acc[j][nt][e],
                __fmul_rn(static_cast<float>(ia[nt][e]),
                          __fmul_rn(s, __ldg(wsg + co))));
          }
        }
      }
      __syncthreads();  // before the int8 window or a buffer is rewritten
    }
  }

  // the active voxels' outputs: round(acc m) into the buffers by list row,
  // then each list row's voxel out as 16-byte vectors
  T* ot = reinterpret_cast<T*>(smem + S::IN);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = lr[j][e / 2];
      if (r < 0) continue;
      const float mv = sm[list[r]];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ot[r * CPAD + nt * 8 + 2 * tig + e % 2] =
            from_f<T>(__fmul_rn(acc[j][nt][e], mv));
    }
  }
  __syncthreads();
  if (tid < rows) {
    const int v = list[tid];
    uint4* o = reinterpret_cast<uint4*>(
        out + voxel_index(b, zb + v / (BY * BX), yb + v / BX % BY,
                          x0 + v % BX, Zfp, Yfp, Xsf) * CPAD);
    const uint4* src = reinterpret_cast<const uint4*>(ot + tid * CPAD);
#pragma unroll
    for (int c = 0; c < S::SLOT / 16; ++c) o[c] = src[c];
  }
}

// bricks over padded fine rows -1 .. Zfp - 1 and -1 .. Yfp - 1 (the ring
// too); false when the grid is too tall for the launch
static bool fine_bricks(int B, int Zfp, int Yfp, int Xsf, dim3& grid,
                        int& nbz) {
  nbz = (Zfp + 1 + BZ - 1) / BZ;
  const int nby = (Yfp + 1 + BY - 1) / BY;
  const long long nz = static_cast<long long>(B) * nbz;
  if (nz > 65535 || nby > 65535) return false;
  grid = dim3((Xsf + BX - 1) / BX, nby, static_cast<unsigned>(nz));
  return true;
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
  dim3 grid;
  int nbz;
  if (!fine_bricks(B, Zfp, Yfp, Xsf, grid, nbz))
    return static_cast<int>(cudaErrorInvalidValue);
  upconv_q_kernel<T, CPAD>
      <<<grid, THREADS, UpQSmem<T, CPAD>::BYTES, stream>>>(
          g, static_cast<const T*>(cmask), static_cast<const T*>(fmask),
          static_cast<const int*>(wq), ws, aff, amax, static_cast<T*>(out),
          Zfp, Yfp, Xsf, Zcp, Ycp, xqc * F, nbz, tz, ty, nz, ny);
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
  dim3 grid;
  int nbz;
  if (!fine_bricks(B, Zfp, Yfp, Xsf, grid, nbz))
    return static_cast<int>(cudaErrorInvalidValue);
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
