// K1, the fused 3^3 submanifold conv site.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py fused_conv_folded (:593),
// body _kernel_fused (:319); called by ops/folded.py subm_conv_fused (:631).
//
//   out[v] = round(mask[v] * sum_g sum_taps sum_ci in_g'[v + tap][ci] *
//                  W_g[tap][ci][:]) (+ residual[v], in the compute type)
//   in_g'  = round(relu(in_g * scale_g + bias_g) * mask)   (with an affine)
//
// The weights hold values of the compute type (ops/folded.py rounds every
// prepared tap); the bf16 mode reads them as bf16, so bf16 grids take
// bf16-valued weights.
//
// What bounds it on Hopper: bytes. Every voxel's mask is read and every
// output voxel written (the residual read) whatever the mask, and the
// groups are needed only around active voxels; most voxels of a scene are
// inactive. The 27 * cin * cout MACs per active voxel are a few per byte
// moved: on the bf16 tensor cores they take a sliver of the bytes' time.
// Beyond the bytes, both modes pay for staging each active brick's halo'd
// window (3.2 times its voxels, mostly from L2) and for a barrier a brick.
//
// Skip, both modes: a masked voxel's output (the residual, loaded with the
// mask, or zero; zero on the halo ring) is written at once as 16-byte
// vectors, so a brick of 2 x 4 x 32 voxels (common.cuh) with no active
// voxel (most of a scene) is a copy that ends at its one barrier. -0
// counts as masked. An active brick lists its active voxels in order.
//
// bf16, an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 x
// bf16 -> f32):
// - Persistent blocks, as many as the card holds at once at the shared
//   memory the site's G groups need (2 an SM at most); each builds the B
//   fragments of every group's weights [G, 27, 16, 16] once, exactly from
//   the bf16-valued f32 taps (input channels >= cin zero).
// - Walk: block i takes bricks i, i + grid, i + 2 grid, ... It judges one
//   brick a barrier, the next candidate's mask and residual loads in
//   flight meanwhile, and keeps an active voxel's residual in its
//   registers for the epilogue. (A counter handing the bricks out evened
//   the blocks' active bricks, which range from 0 to 2.6 times their mean
//   on the sphere shell, and cut the kernel's time, but moved no serving
//   rate while the host paces it.)
// - Stage: an active brick's halo'd window (4 x 6 x 34 slots) of each
//   group is one (brick, group) unit, copied by cp.async into a ring of
//   two buffers (16-byte chunks XOR-swizzled across slots, as K7's; the
//   first unit with the window's masks): the next unit's copy, the next
//   brick's first once this brick's last is in, flies while this one
//   computes. With the affine, each staged slot is
//   transformed in place once, round(relu(x s + b) m_neighbour) in bf16,
//   channels >= cin zero, so a masked neighbour adds +0 and nothing is
//   skipped per thread.
// - Rows: the brick's active voxels, padded to tiles of 16; warp w takes
//   tiles w and w + 8. N is the output channels (two or one 8-wide
//   tiles); K runs over the groups, then the 27 taps: one k16 step is one
//   tap at cpad 16, two at cpad 8 (a 28th tap of zero weights pads the
//   last). A rows come by ldmatrix from the staged slot of (row, tap).
// - Epilogue, the FMA body's arithmetic: round(acc * m) to bf16 into a
//   tile in shared memory, then each active voxel's thread adds its
//   residual in f32, rounds and writes 16-byte vectors.
// The sums are f32 in the tensor cores' order; products of bf16 pairs are
// exact in f32, so only the order of the f32 additions differs from the
// plain version's, and each output is held to 2 bf16 ulps of it
// (chip_smoke.py's _tol). Serving's gates are judged against an f32
// reference that follows them (h100bench's check), not against a surface
// drawn by another summation order.
//
// f32, FMAs on the CUDA cores: one block of 256 threads per brick, each
// group's halo'd window staged by cp.async two buffers deep (group g + 1's
// copies fly while group g computes), the affine applied once a staged
// voxel; each row's voxel summed in the order of the one-thread-per-voxel
// kernel this design replaced (group, tap, channel; a masked neighbour
// skipped), so its outputs are that kernel's bit for bit, a row's output
// channels split 8 to a thread, the weights as uniform float4 loads. No
// TF32: f32 outputs are held to 1e-4 of their scale, which the tensor
// cores' TF32 inputs (10-bit mantissas) would not meet.
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
#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace sgnn {

// Dynamic shared memory of one brick of the f32 body, byte offsets.
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

// One output voxel's loads: its mask and, inside the ring, its residual.
template <typename T, int CPAD>
struct SiteLoad {
  static constexpr int W = CPAD * static_cast<int>(sizeof(T)) / 16;
  uint4 rv[W];
  float m;
  long long idx;
  bool inside, copy;
};

// Voxel (b, z, y, x)'s loads: its mask, 0 on the halo ring and outside the
// grid, and the residual it keeps if masked (inside the ring).
template <typename T, int CPAD>
__device__ __forceinline__ SiteLoad<T, CPAD> site_load(
    const T* __restrict__ mask, const T* __restrict__ resid, int b, int z,
    int y, int x, int Zp, int Yp, int Xs) {
  SiteLoad<T, CPAD> s;
  s.inside = z < Zp && y < Yp && x < Xs;
  const bool ring = z == 0 || z == Zp - 1 || y == 0 || y == Yp - 1;
  s.idx = voxel_index(b, z, y, x, Zp, Yp, Xs);
  s.copy = s.inside && !ring && resid != nullptr;
  if (s.copy) {
#pragma unroll
    for (int v = 0; v < s.W; ++v)
      s.rv[v] =
          __ldg(reinterpret_cast<const uint4*>(resid + s.idx * CPAD) + v);
  }
  s.m = s.inside && !ring ? to_f(mask[s.idx * CPAD]) : 0.f;
  return s;
}

// A masked voxel's output is the residual (inside the ring) or zero
// whatever its brick does: written at once as 16-byte vectors. Returns the
// voxel's mask.
template <typename T, int CPAD>
__device__ __forceinline__ float site_store(const SiteLoad<T, CPAD>& s,
                                            T* __restrict__ out) {
  T* o = out + s.idx * CPAD;
  if (s.inside && s.m == 0.f) {
    if (s.copy) {
#pragma unroll
      for (int v = 0; v < s.W; ++v) reinterpret_cast<uint4*>(o)[v] = s.rv[v];
    } else {
      store_zero<T, CPAD>(o);
    }
  }
  return s.m;
}

// Voxel (b, z, y, x)'s mask, its output written at once if masked; its
// residual load is issued with the mask's, so a skipped brick is a copy
// with no barrier between its loads and stores.
template <typename T, int CPAD>
__device__ __forceinline__ float site_mask(const T* __restrict__ mask,
                                           const T* __restrict__ resid,
                                           T* __restrict__ out, int b, int z,
                                           int y, int x, int Zp, int Yp,
                                           int Xs) {
  return site_store<T, CPAD>(
      site_load<T, CPAD>(mask, resid, b, z, y, x, Zp, Yp, Xs), out);
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

// ------------------------------------------------------------ f32: FMAs

template <int CPAD>
__device__ __forceinline__ void conv_site_fma(
    const Groups& xs, const float* __restrict__ mask,
    const float* __restrict__ resid, const float* __restrict__ w,
    const float* __restrict__ aff, float* __restrict__ out, int Zp, int Yp,
    int Xs, int nbz) {
  using T = float;
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

// -------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;

// Dynamic shared memory of one persistent bf16 block, byte offsets.
template <int CPAD>
struct MmaSmem : TapGemm<CPAD> {
  using G = TapGemm<CPAD>;
  static constexpr int BUF = NH * G::NC * 16;  // a staged (brick, group)
  static constexpr int MT = NV / 16 / WARPS;   // 16-row M tiles a warp
  // a brick's masks and rows, two sets (this brick's, the next one's)
  static constexpr int SM = 0;                 // float [NV]
  static constexpr int HM = SM + NV * 4;       // bf16 pairs [NH]
  static constexpr int LIST = HM + NH * 4;     // ushort [NV]
  static constexpr int META = LIST + NV * 2;
  static constexpr int RING = 0;               // unit u in buffer u % 2
  static constexpr int OUT = RING + 2 * BUF;   // bf16 [NV][CPAD]
  static constexpr int AFF = OUT + NV * CPAD * 2;          // float [G][2][MAXC]
  static constexpr int CNT = AFF + MAXG * 2 * MAXC * 4;    // int [2][16]
  static constexpr int METAS = CNT + 2 * 16 * 4;           // 2 x META
  static constexpr int WF = METAS + 2 * META;  // uint2 [G][FRAGS]
  static constexpr int bytes(int groups) {
    return WF + groups * G::FRAGS * 8;
  }
  static_assert(META % 16 == 0 && METAS % 16 == 0, "16-byte regions");
  static_assert(WARPS <= 16, "a scan's counts");
};

// This thread's loads of brick i's voxel (threadIdx.x).
template <int CPAD>
__device__ __forceinline__ SiteLoad<bf16, CPAD> site_load_at(
    int i, const bf16* __restrict__ mask, const bf16* __restrict__ resid,
    int Zp, int Yp, int Xs, int nbx, int nby, int nbz) {
  const Brick k = brick_at(i, nbx, nby, nbz);
  const int t = threadIdx.x;
  return site_load<bf16, CPAD>(mask, resid, k.b, k.z0 + t / (BY * BX),
                               k.y0 + t / BX % BY, k.x0 + t % BX, Zp, Yp,
                               Xs);
}

// Starts the copies of brick k's halo'd window of grid x (origin (z0 - 1,
// y0 - 1, x0 - 1), zero outside the grid) into buf, swizzled, with those
// of the window's masks into hm (channels 0 and 1 of each voxel; 0 outside
// the grid) where hm is given, as one copy group. Dead lanes are zero and
// meet zero weight rows, so slots are copied whole.
template <int CPAD>
__device__ __forceinline__ void stage_unit(unsigned buf,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ mask,
                                           unsigned* hm, const Brick& k,
                                           int Zp, int Yp, int Xs) {
  constexpr int NC = MmaSmem<CPAD>::NC;
  for (int q = threadIdx.x; q < NH * NC; q += THREADS) {
    const int i = q / NC, c = q % NC;
    const int z = k.z0 - 1 + i / (HY * HX), y = k.y0 - 1 + i / HX % HY,
              xx = k.x0 - 1 + i % HX;
    const bool in =
        z >= 0 && z < Zp && y >= 0 && y < Yp && xx >= 0 && xx < Xs;
    const long long v = in ? voxel_index(k.b, z, y, xx, Zp, Yp, Xs) : 0;
    cp_async16(buf + chunk_off<NC>(i, c), x + v * CPAD + c * 8, in ? 16 : 0);
    if (hm != nullptr && c == 0)
      cp_async4(smem_addr(hm + i), mask + v * CPAD, in ? 4 : 0);
  }
  cp_async_commit();
}

// The affine in place on a staged unit: round(relu(x s + b) m_i) in bf16
// for channels < cin where the voxel's mask (channel 0 of hm[i]) is set,
// else 0 (affine_window's arithmetic, on swizzled chunks).
template <int CPAD>
__device__ __forceinline__ void affine_unit(unsigned char* buf, int cin,
                                            const float* sa,
                                            const unsigned* hm) {
  constexpr int NC = MmaSmem<CPAD>::NC;
  for (int q = threadIdx.x; q < NH * NC; q += THREADS) {
    const int i = q / NC, c = q % NC;
    const float mi = to_f(__ushort_as_bfloat16(
        static_cast<unsigned short>(hm[i] & 0xffffu)));
    uint4* p = reinterpret_cast<uint4*>(buf + chunk_off<NC>(i, c));
    uint4 u = *p;
    bf16* t = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = c * 8 + e;
      t[e] = from_f<bf16>(ch < cin && mi != 0.f
                              ? affine_relu_mask(to_f(t[e]), sa[ch],
                                                 sa[MAXC + ch], mi)
                              : 0.f);
    }
    *p = u;
  }
}

// A block's walk over the bricks, gridDim.x apart from blockIdx.x: cand
// holds this thread's loads of brick, whose judging issues the loads of
// after.
struct Walk {
  int brick, after, scans;
};

// Walks on from wk.brick, writing each masked voxel's output, until a
// brick holds an active voxel: returns its active voxels (0 past the last
// brick), and then its index in at, this thread's loads of it in found,
// this thread's row in li (-1 if masked) and the brick's active voxels in
// order in list (visible after the next barrier); cand and wk move on to
// the next candidate, whose loads are in flight. One barrier a brick.
// cnt: [2][16] ints, alternating with scans (the rows of each warp).
template <int CPAD>
__device__ __forceinline__ int find_brick(
    Walk& wk, int& at, SiteLoad<bf16, CPAD>& cand,
    SiteLoad<bf16, CPAD>& found, int& li, int* cnt, unsigned short* list,
    const bf16* __restrict__ mask, const bf16* __restrict__ resid,
    bf16* __restrict__ out, int Zp, int Yp, int Xs, int nbx, int nby,
    int nbz, int nbricks) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  while (wk.brick < nbricks) {
    SiteLoad<bf16, CPAD> nxt{};
    if (wk.after < nbricks)
      nxt = site_load_at<CPAD>(wk.after, mask, resid, Zp, Yp, Xs, nbx, nby,
                             nbz);
    int* c = cnt + (wk.scans++ & 1) * 16;
    const float m = site_store<bf16, CPAD>(cand, out);
    const unsigned ball = __ballot_sync(0xffffffffu, m != 0.f);
    if (lane == 0) c[warp] = __popc(ball);
    __syncthreads();
    int off = 0, rows = 0;
    for (int wi = 0; wi < WARPS; ++wi) {
      off += wi < warp ? c[wi] : 0;
      rows += c[wi];
    }
    at = wk.brick;
    wk.brick = wk.after;
    wk.after += gridDim.x;
    if (rows > 0) {
      li = m != 0.f ? off + __popc(ball & ((1u << lane) - 1u)) : -1;
      if (li >= 0) list[li] = tid;
      found = cand;
      cand = nxt;
      return rows;
    }
    cand = nxt;
  }
  return 0;
}

template <int CPAD>
__device__ __forceinline__ void conv_site_mma(
    const Groups& xs, const bf16* __restrict__ mask,
    const bf16* __restrict__ resid, const float* __restrict__ w,
    const float* __restrict__ aff, bf16* __restrict__ out, int Zp, int Yp,
    int Xs, int nbx, int nby, int nbz, int nbricks) {
  using S = MmaSmem<CPAD>;
  using Load = SiteLoad<bf16, CPAD>;
  constexpr int NT = S::NT, MT = S::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int G = xs.n;
  uint2* wf = reinterpret_cast<uint2*>(smem + S::WF);
  float* sa = reinterpret_cast<float*>(smem + S::AFF);
  int* cnt = reinterpret_cast<int*>(smem + S::CNT);
  bf16* ot = reinterpret_cast<bf16*>(smem + S::OUT);
  // the walk, units begun, metadata set, this thread's row (-1: masked),
  // its loads of the brick found and of the next candidate
  Walk wk{static_cast<int>(blockIdx.x),
          static_cast<int>(blockIdx.x + gridDim.x), 0};
  int u = 0, mb = 0, li = -1;
  Load found{}, cand{};
  if (wk.brick < nbricks)  // the first candidate's loads fly meanwhile
    cand = site_load_at<CPAD>(wk.brick, mask, resid, Zp, Yp, Xs, nbx, nby,
                            nbz);
  auto ring = [&](int unit) {
    return smem + S::RING + (unit & 1) * S::BUF;
  };
  auto meta = [&](int i) { return smem + S::METAS + i * S::META; };
  auto list_of = [&](int i) {
    return reinterpret_cast<unsigned short*>(meta(i) + S::LIST);
  };
  auto find = [&](int& at, int mi) {
    return find_brick<CPAD>(wk, at, cand, found, li, cnt, list_of(mi), mask,
                            resid, out, Zp, Yp, Xs, nbx, nby, nbz, nbricks);
  };
  // an active brick's first unit with its window's masks, and its voxels'
  // masks (the row list is find_brick's)
  auto begin = [&](int i, int unit, int mi) {
    stage_unit<CPAD>(smem_addr(ring(unit)),
                     static_cast<const bf16*>(xs.p[0]), mask,
                     aff != nullptr
                         ? reinterpret_cast<unsigned*>(meta(mi) + S::HM)
                         : nullptr,
                     brick_at(i, nbx, nby, nbz), Zp, Yp, Xs);
    reinterpret_cast<float*>(meta(mi) + S::SM)[tid] = found.m;
  };

  // visible after the first scan's barrier
  for (int g = 0; g < G; ++g)
    tap_fragments<CPAD>(wf + g * S::FRAGS, w + g * 27 * MAXC * MAXC,
                        xs.cin[g]);
  if (aff != nullptr) {
    for (int i = tid; i < G * 2 * MAXC; i += THREADS) sa[i] = aff[i];
  }
  int brick = 0;
  int rows = find(brick, 0);
  if (rows > 0) begin(brick, 0, 0);

  while (rows > 0) {
    const Brick k = brick_at(brick, nbx, nby, nbz);
    const unsigned short* list = list_of(mb);
    const float* sm = reinterpret_cast<const float*>(meta(mb) + S::SM);
    const unsigned* hm =
        reinterpret_cast<const unsigned*>(meta(mb) + S::HM);
    uint4 res[Load::W];  // this thread's voxel's residual, if active
#pragma unroll
    for (int v = 0; v < Load::W; ++v) res[v] = found.rv[v];
    const int row = li;
    float acc[MT][NT][4];
    int cs[MT];
    bool act[MT];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;
    int next = brick, nrows = 0;
    for (int g = 0; g < G; ++g, ++u) {
      cp_async_wait<0>();
      // unit u visible; every thread done with unit u - 1, whose buffer
      // takes unit u + 1
      __syncthreads();
      if (g == 0) {  // the list is visible from here on
        const int r = (lane & 7) + (lane >> 3 & 1) * 8;
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int r0 = (warp + t * WARPS) * 16;
          act[t] = r0 < rows;
          cs[t] = center_slot(r0 + r < rows ? list[r0 + r] : 0);
        }
      }
      if (g + 1 < G) {
        stage_unit<CPAD>(smem_addr(ring(u + 1)),
                         static_cast<const bf16*>(xs.p[g + 1]), mask,
                         nullptr, k, Zp, Yp, Xs);
      } else {  // this brick's last unit: find the next brick, stage its
                // first
        nrows = find(next, mb ^ 1);
        if (nrows > 0) begin(next, u + 1, mb ^ 1);
      }
      unsigned char* buf = ring(u);
      if (aff != nullptr) {
        affine_unit<CPAD>(buf, xs.cin[g], sa + g * 2 * MAXC, hm);
        __syncthreads();
      }
      if (act[0])
        tap_mma<CPAD, MT>(smem_addr(buf), wf + g * S::FRAGS, cs, act, acc);
    }

    // round(acc m) into the out tile by row; then each active voxel's
    // thread adds its residual in f32, rounds and writes 16-byte vectors
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (!act[t]) continue;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = (warp + t * WARPS) * 16 + gid + 8 * hi;
        if (r >= rows) continue;
        const float mv = sm[list[r]];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<__nv_bfloat162*>(ot + r * CPAD + nt * 8 +
                                             2 * tig) =
              __floats2bfloat162_rn(__fmul_rn(acc[t][nt][2 * hi], mv),
                                    __fmul_rn(acc[t][nt][2 * hi + 1], mv));
        }
      }
    }
    __syncthreads();
    if (row >= 0) {
      float v[CPAD];
#pragma unroll
      for (int c = 0; c < S::NC; ++c) {
        const uint4 q = reinterpret_cast<const uint4*>(ot + row * CPAD)[c];
        const bf16* t = reinterpret_cast<const bf16*>(&q);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[c * 8 + e] = to_f(t[e]);
      }
      if (resid != nullptr) {
#pragma unroll
        for (int c = 0; c < S::NC; ++c) {
          const bf16* t = reinterpret_cast<const bf16*>(&res[c]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[c * 8 + e] = __fadd_rn(v[c * 8 + e], to_f(t[e]));
        }
      }
      store_voxel<bf16, CPAD>(
          out + voxel_index(k.b, k.z0 + tid / (BY * BX),
                            k.y0 + tid / BX % BY, k.x0 + tid % BX, Zp, Yp,
                            Xs) * CPAD,
          v);
    }
    brick = next;
    rows = nrows;
    mb ^= 1;
  }
}

// f32: one brick a block (grid nbx x nby x B nbz), 2 blocks of 256 threads
// an SM (~110 KB of shared memory at cpad 16); bf16: persistent blocks
// over the nbricks bricks, 2 an SM (a cap of 80 registers for a third
// spilled and ran slower)
template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS, 2)
    conv_site_kernel(Groups xs, const T* __restrict__ mask,
                     const T* __restrict__ resid,
                     const float* __restrict__ w,    // [G, 27, MAXC, MAXC]
                     const float* __restrict__ aff,  // [G, 2, MAXC] or null
                     T* __restrict__ out, int Zp, int Yp, int Xs, int nbx,
                     int nby, int nbz, int nbricks) {
  if constexpr (sizeof(T) == 2) {
    conv_site_mma<CPAD>(xs, mask, resid, w, aff, out, Zp, Yp, Xs, nbx, nby,
                        nbz, nbricks);
  } else {
    conv_site_fma<CPAD>(xs, mask, resid, w, aff, out, Zp, Yp, Xs, nbz);
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

constexpr int MAXDEV = 64;  // devices whose block counts are kept

template <typename T, int CPAD>
static int launch_conv_site(const Groups& g, const void* mask,
                            const void* resid, const float* w,
                            const float* aff, void* out, int B, int Zp,
                            int Yp, int xq, cudaStream_t stream) {
  constexpr bool TC = sizeof(T) == 2;
  using S = SiteSmem<T, CPAD>;
  static_assert(S::BYTES <= 227 * 1024, "a brick's shared memory");
  static_assert(MmaSmem<CPAD>::bytes(MAXG) <= 227 * 1024,
                "a persistent block's shared memory");
  const auto kernel = conv_site_kernel<T, CPAD>;
  const int bytes = TC ? MmaSmem<CPAD>::bytes(g.n) : S::BYTES;
  // above 48 KB only once the kernel allows it; the attribute belongs to
  // the current device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int Xs = xq * (LANES / CPAD);
  const int nbx = (Xs + BX - 1) / BX, nby = (Yp + BY - 1) / BY,
            nbz = (Zp + BZ - 1) / BZ;
  const long long nbricks = static_cast<long long>(B) * nbz * nby * nbx;
  if (nbricks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(nbx, nby, B * nbz);
  if (TC) {  // persistent: as many blocks as the card holds at once,
             // found once a device and group count
    static std::atomic<int> held[MAXDEV][MAXG + 1];
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if (dev >= MAXDEV) return static_cast<int>(cudaErrorInvalidDevice);
    int blocks = held[dev][g.n].load(std::memory_order_relaxed);
    if (blocks == 0) {
      int sms = 0, per_sm = 0;
      if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
          (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, THREADS, bytes)) != cudaSuccess) {
        return static_cast<int>(e);
      }
      blocks = sms * std::max(per_sm, 1);
      held[dev][g.n].store(blocks, std::memory_order_relaxed);
    }
    grid = dim3(static_cast<unsigned>(
        std::min(nbricks, static_cast<long long>(blocks))));
    if (grid.x == 0) return 0;
  }
  kernel<<<grid, THREADS, bytes, stream>>>(
      g, static_cast<const T*>(mask), static_cast<const T*>(resid), w, aff,
      static_cast<T*>(out), Zp, Yp, Xs, nbx, nby, nbz,
      static_cast<int>(nbricks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn

using namespace sgnn;

// xs / cins: host arrays of G device pointers and input widths.
// resid, aff: null when absent. bf16: 1 for bfloat16 grids, 0 for
// float32.
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
