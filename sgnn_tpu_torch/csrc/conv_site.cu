// K1, the fused 3^3 submanifold conv site.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_conv_folded (:593),
// body _kernel_fused (:319); called by ops/folded.py subm_conv_fused (:631).
//
//   out[v] = round(mask[v] * sum_g sum_taps sum_ci in_g'[v + tap][ci] *
//                  W_g[tap][ci][:]) (+ residual[v], in the compute type)
//   in_g'  = round(relu(in_g * scale_g + bias_g) * mask)   (with an affine)
//
// What bounds it on Hopper: bytes. Every voxel's mask is read and every
// output voxel written (the residual read) whatever the mask, and the
// groups are needed only around active voxels; most voxels of a scene are
// inactive. The 27 * cin * cout MACs per active voxel are a few per byte
// moved: even as f32 FMAs on the CUDA cores they take less than the bytes'
// time.
//
// Design of the exact modes: one block of 256 threads per output brick of
// BZ x BY x BX = 2 x 4 x 32 voxels, one voxel a thread, x fastest (a
// warp's mask reads and stores are one brick row of contiguous slots).
// - Skip: each thread reads its voxel's mask; a masked voxel's output (the
//   residual, loaded with the mask, or zero) is written at once as 16-byte
//   vectors, so a brick with no active voxel (most of a scene) is a copy
//   and ends at its one barrier.
// - Stage: an active brick copies each group's halo'd input brick (4 x 6
//   x 34 voxels, zero outside the grid) into shared memory with cp.async,
//   two buffers deep: group g + 1's copies fly while group g computes. With
//   the affine, each staged voxel is transformed in place once,
//   round(relu(x s + b) m_neighbour) in the compute type, channels >= cin
//   zero (rather than once per tap that reads it).
// - Rows: the brick's active voxels, compacted into a list in order.
// - Sums, both modes: each row's voxel is summed over the staged groups in
//   f32 FMAs on the CUDA cores, in the order of the one-thread-per-voxel
//   kernel this design replaced (group, tap, channel; a masked neighbour
//   skipped), so its outputs are that kernel's bit for bit; a row's output
//   channels are split 8 to a thread (each channel's sum is a chain of its
//   own), 16-byte reads of 8 (bf16) or 4 (f32) staged channels, the weights
//   as uniform float4 loads. No TF32: f32 outputs are held to 1e-4 of their
//   scale. The bf16 mode stays off the tensor cores: their sums, in another
//   order, draw another serving surface from the bf16 occupancy gates
//   (PERF.md, Findings).
//
// K1q, the int8 mode (quantize=True, _kernel_fused :413-451), runs in the
// same bricks: masked voxels written at once (a brick with no active voxel
// is a copy), each group's halo'd input brick staged by cp.async two
// buffers deep, the brick's active voxels as rows. The scale of a product
// is that of the TPU tile holding the OUTPUT voxel (tile (iz, iy) holds
// interior rows [iz tz, (iz + 1) tz) x [iy ty, (iy + 1) ty), whole x rows),
// so it is set per brick row; a brick's 8 rows can span several tiles.
// For each group and each distinct tile among the brick's active rows (one
// or two at the serving shapes), the staged group is quantized once per
// staged voxel into an int8 brick: the f32 input (the affine's value before
// any rounding to the compute type, relu(x s + b) m_neighbour, else x)
// times 1 / s, rintf, clipped (quantize_values, common.cuh). Warps then take
// 16 rows at a time through mma.sync m16n8k32 s8 x s8 -> s32: A is 16 rows
// by 32 int8 values (two taps at cpad 16, four at cpad 8; a 28th tap of
// zero weights pads the last step), B the int8 weights [G, 27, co, ci]
// (k-contiguous per output channel, read through L1), N cpad. Integer sums
// are exact in any order, and each row keeps its own tile's sums,
// dequantized per group in group order, acc += f32(iacc) * (s * ws[g, co]),
// then the mask, the rounding and the residual: the plain version's values
// bit for bit. The outputs go through shared memory and out as 16-byte
// vectors. Bound: the same bytes as K1, and 27 * cin * cout int8 MACs per
// active voxel (int8 tensor-core rate).
#include "common.cuh"

namespace sgnn {

// Dynamic shared memory of one brick, byte offsets.
template <typename T, int CPAD>
struct SiteSmem {
  static constexpr int SLOT = CPAD * static_cast<int>(sizeof(T));
  static constexpr int BUF = NH * SLOT;       // a staged group
  static constexpr int IN = 0;                // group g in buffer g % 2
  static constexpr int HM = IN + 2 * BUF;     // float [NH]
  static constexpr int M = HM + NH * 4;       // float [NV]
  static constexpr int AFF = M + NV * 4;      // float [G][2][MAXC]
  static constexpr int LIST = AFF + MAXG * 2 * MAXC * 4;  // ushort [NV]
  static constexpr int CNT = LIST + NV * 2;   // int [WARPS]
  static constexpr int BYTES = CNT + WARPS * 4;

  // byte offset of 16-byte word v of staged slot i
  static __device__ __forceinline__ int word(int i, int v) {
    return i * SLOT + v * 16;
  }
};

// Voxel (b, z, y, x)'s mask, 0 on the halo ring and outside the grid. A
// masked voxel's output is the residual (inside the ring) or zero whatever
// its brick does: it is written at once as 16-byte vectors, its residual
// load issued with the mask's, so a skipped brick is a copy with no
// barrier between its loads and stores.
template <typename T, int CPAD>
__device__ __forceinline__ float site_mask(const T* __restrict__ mask,
                                           const T* __restrict__ resid,
                                           T* __restrict__ out, int b, int z,
                                           int y, int x, int Zp, int Yp,
                                           int Xs) {
  constexpr int W = CPAD * static_cast<int>(sizeof(T)) / 16;
  const bool inside = z < Zp && y < Yp && x < Xs;
  const bool ring = z == 0 || z == Zp - 1 || y == 0 || y == Yp - 1;
  const long long idx = voxel_index(b, z, y, x, Zp, Yp, Xs);
  T* o = out + idx * CPAD;
  const bool copy = inside && !ring && resid != nullptr;
  uint4 rv[W];
  if (copy) {
#pragma unroll
    for (int v = 0; v < W; ++v)
      rv[v] = __ldg(reinterpret_cast<const uint4*>(resid + idx * CPAD) + v);
  }
  const float m = inside && !ring ? to_f(mask[idx * CPAD]) : 0.f;
  if (inside && m == 0.f) {
    if (copy) {
#pragma unroll
      for (int v = 0; v < W; ++v) reinterpret_cast<uint4*>(o)[v] = rv[v];
    } else {
      store_zero<T, CPAD>(o);
    }
  }
  return m;
}

// An active brick's masks, before a barrier: sm[v] each voxel's, cnt[w]
// the active voxels of brick row w; with an affine aff ([G, 2, MAXC]) also
// sa = aff and hm[i] the halo'd brick's (0 outside the grid).
template <typename T>
__device__ __forceinline__ void stage_masks(float m,
                                            const T* __restrict__ mask,
                                            const float* __restrict__ aff,
                                            int G, int b, int z0, int y0,
                                            int x0, int Zp, int Yp, int Xs,
                                            int cpad, float* sm, int* cnt,
                                            float* sa, float* hm) {
  const int tid = threadIdx.x;
  sm[tid] = m;
  const unsigned ball = __ballot_sync(0xffffffffu, m != 0.f);
  if (tid % 32 == 0) cnt[tid / 32] = __popc(ball);
  if (aff != nullptr) {
    for (int i = tid; i < G * 2 * MAXC; i += THREADS) sa[i] = aff[i];
#pragma unroll 4
    for (int i = tid; i < NH; i += THREADS) {
      const int hz = z0 - 1 + i / (HY * HX), hy = y0 - 1 + i / HX % HY,
                hx = x0 - 1 + i % HX;
      hm[i] = hz >= 0 && hz < Zp && hy >= 0 && hy < Yp && hx >= 0 && hx < Xs
                  ? to_f(mask[voxel_index(b, hz, hy, hx, Zp, Yp, Xs) * cpad])
                  : 0.f;
    }
  }
}

// After stage_masks' barrier: list[0, rows) = the brick's active voxels in
// order (visible after the next barrier); returns rows.
__device__ __forceinline__ int list_rows(bool active, const int* cnt,
                                         unsigned short* list) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned ball = __ballot_sync(0xffffffffu, active);
  int off = 0, rows = 0;
  for (int wi = 0; wi < WARPS; ++wi) {
    off += wi < warp ? cnt[wi] : 0;
    rows += cnt[wi];
  }
  if (active) list[off + __popc(ball & ((1u << lane) - 1u))] = tid;
  return rows;
}

// bf16: 3 blocks of 256 threads an SM (80 registers a thread, ~57 KB of
// shared memory at cpad 16); f32: 2 (~110 KB at cpad 16)
template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 2)
    conv_site_kernel(Groups xs, const T* __restrict__ mask,
                     const T* __restrict__ resid,
                     const float* __restrict__ w,    // [G, 27, MAXC, MAXC]
                     const float* __restrict__ aff,  // [G, 2, MAXC] or null
                     T* __restrict__ out, int Zp, int Yp, int Xs, int nbz) {
  using S = SiteSmem<T, CPAD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.z / nbz;
  const int z0 = blockIdx.z % nbz * BZ, y0 = blockIdx.y * BY,
            x0 = blockIdx.x * BX;
  const float m = site_mask<T, CPAD>(mask, resid, out, b,
                                     z0 + tid / (BY * BX), y0 + tid / BX % BY,
                                     x0 + tid % BX, Zp, Yp, Xs);
  if (!__syncthreads_or(m != 0.f)) return;

  // an active brick: group 0's copies first, then its masks, affines and
  // row list
  unsigned char* bufs[2] = {smem + S::IN, smem + S::IN + S::BUF};
  copy_window<T, CPAD, HZ, HY, HX>(
      smem_addr(bufs[0]), static_cast<const T*>(xs.p[0]), b, z0 - 1,
      y0 - 1, x0 - 1, Zp, Yp, Xs);
  float* hm = reinterpret_cast<float*>(smem + S::HM);
  float* sm = reinterpret_cast<float*>(smem + S::M);
  float* sa = reinterpret_cast<float*>(smem + S::AFF);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + S::LIST);
  int* cnt = reinterpret_cast<int*>(smem + S::CNT);
  stage_masks<T>(m, mask, aff, xs.n, b, z0, y0, x0, Zp, Yp, Xs, CPAD, sm,
                 cnt, sa, hm);
  __syncthreads();
  const int rows = list_rows(m != 0.f, cnt, list);

  // each row's voxel is summed over the staged groups in f32 FMAs, in the
  // order of the kernel this design replaced (group, tap (dz, dy, dx),
  // channel; a masked neighbour skipped), so its outputs are that kernel's
  // bit for bit. Every output channel's sum is a chain of its
  // own, so a row's CPAD channels are split over CPAD / 8 threads, 8 each:
  // thread t takes row j RPP + t / TPV (j < NP) and channels 8 (t % TPV)..
  constexpr int TPV = CPAD / 8, RPP = THREADS / TPV, NP = NV / RPP;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int co0 = tid % TPV * 8;
  float acc[NP][8];
  int vr[NP], s0[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    vr[j] = -1;
    s0[j] = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;
  }
  for (int g = 0; g < xs.n; ++g) {
    const int cin = xs.cin[g];
    unsigned char* buf = bufs[g % 2];
    if (g + 1 < xs.n) {
      copy_window<T, CPAD, HZ, HY, HX>(
          smem_addr(bufs[(g + 1) % 2]), static_cast<const T*>(xs.p[g + 1]),
          b, z0 - 1, y0 - 1, x0 - 1, Zp, Yp, Xs);
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
          s0[j] = center_slot(vr[j]);
        }
      }
    }
    if (aff != nullptr) {
      affine_window<T, CPAD, NH>(buf, cin, sa + g * 2 * MAXC, hm);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (vr[j] < 0) continue;
      for (int tap = 0; tap < 27; ++tap) {
        const int slot = s0[j] + tap_offset(tap);
        if (aff != nullptr && hm[slot] == 0.f) continue;
        const float* wt = w + (g * 27 + tap) * MAXC * MAXC + co0;
#pragma unroll
        for (int q = 0; q < S::SLOT / 16; ++q) {
          if (q * E >= cin) break;
          const uint4 u =
              *reinterpret_cast<const uint4*>(buf + S::word(slot, q));
          const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (q * E + e < cin)
              axpy<8>(acc[j], to_f(t[e]), wt + (q * E + e) * MAXC);
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
    const long long iv =
        voxel_index(b, z0 + v / (BY * BX), y0 + v / BX % BY, x0 + v % BX,
                    Zp, Yp, Xs) * CPAD + co0;
    const float mv = sm[v];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[j][c] = round_to<T>(__fmul_rn(acc[j][c], mv));
    if (resid != nullptr) {
      float rr[8];
      load_voxel<T, 8>(resid + iv, rr);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][c] = __fadd_rn(acc[j][c], rr[c]);
    }
    store_voxel<T, 8>(out + iv, acc[j]);
  }
}

// Dynamic shared memory of one K1q brick, byte offsets.
template <typename T, int CPAD>
struct SiteQSmem {
  static constexpr int SLOT = CPAD * static_cast<int>(sizeof(T));
  static constexpr int BUF = NH * SLOT;        // a staged group
  static constexpr int NT = CPAD / 8;          // 8-wide N tiles
  static constexpr int IN = 0;   // group g in buffer g % 2; then the outputs
  static constexpr int Q = IN + 2 * BUF;       // int8 [NH][CPAD]
  static constexpr int HM = Q + NH * CPAD;     // float [NH]
  static constexpr int M = HM + NH * 4;        // float [NV]
  static constexpr int AFF = M + NV * 4;       // float [G][2][MAXC]
  static constexpr int LIST = AFF + MAXG * 2 * MAXC * 4;  // ushort [NV]
  static constexpr int CNT = LIST + NV * 2;    // int [WARPS]
  static constexpr int KEY = CNT + WARPS * 4;  // int [WARPS]
  static constexpr int BYTES = KEY + WARPS * 4;
  static_assert(NV * SLOT <= BUF, "the outputs fit buffer 0");
};

// int8 products of 16 rows (this lane's rows gid and gid + 8 at staged
// slots s0, s1) with group wg's int8 weights [27, co, ci] over the
// quantized brick q: ia[nt] = the C fragment of N tile nt.
template <int CPAD>
__device__ __forceinline__ void mma_rows_s8(const unsigned char* q, int s0,
                                            int s1,
                                            const int* __restrict__ wg,
                                            int (*ia)[4]) {
  constexpr int TPK = 32 / CPAD, KSTEPS = (27 + TPK - 1) / TPK;
  constexpr int NT = CPAD / 8;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ia[nt][e] = 0;
#pragma unroll  // the taps' offsets become constants
  for (int j = 0; j < KSTEPS; ++j) {
    // k values 4 tig .. (a0, a1; b0) and 16 + 4 tig .. (a2, a3; b1): tap
    // TPK j + k / CPAD, channels k % CPAD ..
    unsigned a[4], b[NT][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * h + 4 * tig;
      const int tap = TPK * j + k / CPAD, ci = k % CPAD;
      if (tap < 27) {
        const int off = tap_offset(tap) * CPAD + ci;
        a[2 * h] = *reinterpret_cast<const unsigned*>(q + s0 * CPAD + off);
        a[2 * h + 1] = *reinterpret_cast<const unsigned*>(q + s1 * CPAD + off);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          b[nt][h] = static_cast<unsigned>(
              __ldg(wg + ((tap * MAXC + nt * 8 + gid) * MAXC + ci) / 4));
      } else {
        a[2 * h] = a[2 * h + 1] = 0u;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[nt][h] = 0u;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_s8(ia[nt], a, b[nt]);
  }
}

// bf16: 3 blocks of 256 threads an SM (~69 KB of shared memory at cpad
// 16); f32: 1 (~120 KB)
template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 1)
    conv_site_q_kernel(Groups xs, const T* __restrict__ mask,
                       const T* __restrict__ resid,
                       const int* __restrict__ wq,     // int8 [G, 27, co, ci]
                       const float* __restrict__ ws,   // [G, MAXC]
                       const float* __restrict__ aff,  // [G, 2, MAXC] or null
                       const float* __restrict__ amax,  // [B, nz, ny, G]
                       T* __restrict__ out, int Zp, int Yp, int Xs, int nbz,
                       int tz, int ty, int nz, int ny) {
  using S = SiteQSmem<T, CPAD>;
  constexpr int NT = S::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int b = blockIdx.z / nbz;
  const int z0 = blockIdx.z % nbz * BZ, y0 = blockIdx.y * BY,
            x0 = blockIdx.x * BX;
  const float m = site_mask<T, CPAD>(mask, resid, out, b,
                                     z0 + tid / (BY * BX), y0 + tid / BX % BY,
                                     x0 + tid % BX, Zp, Yp, Xs);
  if (!__syncthreads_or(m != 0.f)) return;

  // an active brick: group 0's copies first, then its masks, affines, each
  // brick row's TPU tile (key iz * ny + iy; -1 for a row with no active
  // voxel, as every ring row) and the row list
  unsigned char* bufs[2] = {smem + S::IN, smem + S::IN + S::BUF};
  unsigned char* qb = smem + S::Q;
  copy_window<T, CPAD, HZ, HY, HX>(
      smem_addr(bufs[0]), static_cast<const T*>(xs.p[0]), b, z0 - 1,
      y0 - 1, x0 - 1, Zp, Yp, Xs);
  float* hm = reinterpret_cast<float*>(smem + S::HM);
  float* sm = reinterpret_cast<float*>(smem + S::M);
  float* sa = reinterpret_cast<float*>(smem + S::AFF);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + S::LIST);
  int* cnt = reinterpret_cast<int*>(smem + S::CNT);
  int* key = reinterpret_cast<int*>(smem + S::KEY);
  stage_masks<T>(m, mask, aff, xs.n, b, z0, y0, x0, Zp, Yp, Xs, CPAD, sm,
                 cnt, sa, hm);
  {
    const bool row_active = __any_sync(0xffffffffu, m != 0.f);
    const int z = z0 + warp / BY, y = y0 + warp % BY;
    if (lane == 0)
      key[warp] = row_active ? (z - 1) / tz * ny + (y - 1) / ty : -1;
  }
  __syncthreads();
  const int rows = list_rows(m != 0.f, cnt, list);

  // warp w takes the 16-row chunks w and w + WARPS of the list; this lane
  // holds rows gid and gid + 8 of each (its A rows and C rows)
  int slot[2][2], rkey[2][2];
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
      copy_window<T, CPAD, HZ, HY, HX>(
          smem_addr(bufs[(g + 1) % 2]), static_cast<const T*>(xs.p[g + 1]),
          b, z0 - 1, y0 - 1, x0 - 1, Zp, Yp, Xs);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (g == 0) {  // the list is visible from here on
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = (warp + j * WARPS) * 16 + gid + 8 * hi;
          const int v = r < rows ? list[r] : 0;
          slot[j][hi] = center_slot(v);
          rkey[j][hi] = r < rows ? key[v / BX] : -1;
        }
      }
    }
    const int* wg = wq + g * 27 * MAXC * MAXC / 4;
    const float* wsg = ws + g * MAXC;
    // one pass per distinct tile among the brick rows, in row order
    for (int wr = 0; wr < WARPS; ++wr) {
      const int k = key[wr];
      bool seen = k < 0;
      for (int p = 0; p < wr; ++p) seen = seen || key[p] == k;
      if (seen) continue;
      const float s =
          tile_scale(amax[(static_cast<long long>(b) * nz * ny + k) * xs.n +
                          g]);
      quantize_window<T, CPAD, NH>(
          buf, qb, cin, aff != nullptr ? sa + g * 2 * MAXC : nullptr, hm,
          1.0f / s);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool mine = rkey[j][0] == k || rkey[j][1] == k;
        if (!__any_sync(0xffffffffu, mine)) continue;
        int ia[NT][4];
        mma_rows_s8<CPAD>(qb, slot[j][0], slot[j][1], wg, ia);
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
      __syncthreads();  // before q or this group's buffer is written again
    }
  }

  // the active voxels' outputs: round(acc m) into buffer 0 by row, then
  // each row's voxel + its residual, rounded, as 16-byte vectors
  T* ot = reinterpret_cast<T*>(smem + S::IN);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (warp + j * WARPS) * 16 + gid + 8 * (e / 2);
      if (r >= rows) continue;
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
    const long long iv =
        voxel_index(b, z0 + v / (BY * BX), y0 + v / BX % BY, x0 + v % BX, Zp,
                    Yp, Xs) * CPAD;
    float r[CPAD];
#pragma unroll
    for (int c = 0; c < S::SLOT / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(ot + tid * CPAD)[c];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e)
        r[c * (16 / static_cast<int>(sizeof(T))) + e] = to_f(t[e]);
    }
    if (resid != nullptr) {
      float rr[CPAD];
      load_voxel<T, CPAD>(resid + iv, rr);
#pragma unroll
      for (int c = 0; c < CPAD; ++c) r[c] = __fadd_rn(r[c], rr[c]);
    }
    store_voxel<T, CPAD>(out + iv, r);
  }
}

template <typename T, int CPAD>
static int launch_conv_site_q(const Groups& g, const void* mask,
                              const void* resid, const void* wq,
                              const float* ws, const float* aff,
                              const float* amax, void* out, int B, int Zp,
                              int Yp, int xq, int tz, int ty, int nz, int ny,
                              cudaStream_t stream) {
  using S = SiteQSmem<T, CPAD>;
  static_assert(S::BYTES <= 227 * 1024, "a brick's shared memory");
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_site_q_kernel<T, CPAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int Xs = xq * (LANES / CPAD);
  const int nbz = (Zp + BZ - 1) / BZ;
  const dim3 grid((Xs + BX - 1) / BX, (Yp + BY - 1) / BY, B * nbz);
  conv_site_q_kernel<T, CPAD><<<grid, THREADS, S::BYTES, stream>>>(
      g, static_cast<const T*>(mask), static_cast<const T*>(resid),
      static_cast<const int*>(wq), ws, aff, amax, static_cast<T*>(out), Zp,
      Yp, Xs, nbz, tz, ty, nz, ny);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPAD>
static int launch_conv_site(const Groups& g, const void* mask,
                            const void* resid, const float* w,
                            const float* aff, void* out, int B,
                            int Zp, int Yp, int xq, cudaStream_t stream) {
  using S = SiteSmem<T, CPAD>;
  static_assert(S::BYTES <= 227 * 1024, "a brick's shared memory");
  // above 48 KB only once the kernel allows it (f32 at cpad 16); the
  // attribute belongs to the current device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_site_kernel<T, CPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int Xs = xq * (LANES / CPAD);
  const int nbz = (Zp + BZ - 1) / BZ;
  const dim3 grid((Xs + BX - 1) / BX, (Yp + BY - 1) / BY, B * nbz);
  conv_site_kernel<T, CPAD><<<grid, THREADS, S::BYTES, stream>>>(
      g, static_cast<const T*>(mask), static_cast<const T*>(resid), w, aff,
      static_cast<T*>(out), Zp, Yp, Xs, nbz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// xs / cins: host arrays of G device pointers and input widths.
// resid, aff: null when absent. bf16: 1 for bfloat16 grids, 0 for float32.
extern "C" int sgnn_conv_site(const void* const* xs, const int* cins, int G,
                              const void* mask, const void* resid,
                              const float* w, const float* aff,
                              void* out, int B, int Zp, int Yp, int xq,
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
    return bf16 ? launch_conv_site<__nv_bfloat16, 8>(
                      g, mask, resid, w, aff, out, B, Zp, Yp, xq, s)
                : launch_conv_site<float, 8>(g, mask, resid, w, aff, out, B,
                                             Zp, Yp, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_conv_site<__nv_bfloat16, 16>(
                      g, mask, resid, w, aff, out, B, Zp, Yp, xq, s)
                : launch_conv_site<float, 16>(g, mask, resid, w, aff, out, B,
                                              Zp, Yp, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 mode: wq int8 [G, 27, 16, 16] (co, ci), ws [G, 16], amax
// [B, nz, ny, G] from sgnn_tile_amax, (tz, ty) the TPU tile.
extern "C" int sgnn_conv_site_q(const void* const* xs, const int* cins,
                                int G, const void* mask, const void* resid,
                                const void* wq, const float* ws,
                                const float* aff, const float* amax,
                                void* out, int B, int Zp, int Yp, int xq,
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
    return bf16 ? launch_conv_site_q<__nv_bfloat16, 8>(
                      g, mask, resid, wq, ws, aff, amax, out, B, Zp, Yp, xq,
                      tz, ty, nz, ny, s)
                : launch_conv_site_q<float, 8>(g, mask, resid, wq, ws, aff,
                                               amax, out, B, Zp, Yp, xq, tz,
                                               ty, nz, ny, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_conv_site_q<__nv_bfloat16, 16>(
                      g, mask, resid, wq, ws, aff, amax, out, B, Zp, Yp, xq,
                      tz, ty, nz, ny, s)
                : launch_conv_site_q<float, 16>(g, mask, resid, wq, ws, aff,
                                                amax, out, B, Zp, Yp, xq, tz,
                                                ty, nz, ny, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
