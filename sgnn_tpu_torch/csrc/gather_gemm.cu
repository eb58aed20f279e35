// K10, the fused neighbour gather and tap GEMM of the coordinate-list
// sparse convolution.
//
// Replaces: sgnn_tpu/ops/pallas/gather_gemm.py gather_gemm_pallas (:62),
// body _kernel (:48); the XLA form it stands in for is
// sgnn_tpu/ops/conv.py gather_gemm (:80), called by every submanifold
// and strided sparse conv of the coordinate-list execution.
//
//   out[n] = round(sum_k feats[nbr[n, k] - 1] @ W[k])    f32 sums
//
// nbr [n, K] int32 holds row + 1 of each tap's neighbour, 0 for a
// missing one (a value outside [1, n] is read as missing too); feats
// [n, cin] and out [n, cout] are in the compute type; W arrives as
// f32 [K, cin, coutp] rounded to that type (common.cuh, row kernels).
//
// What bounds it on Hopper: the gathered rows. The function's own bytes
// (the table, nbr, the weights, the output) take ~8 us at the widest site
// of the serving path (the refinement n1: 27 taps of 48 bf16 channels over
// ~114k rows), but the gathers read each present neighbour row again, once
// a tap (~25 a row there), from L2, where the table stays: ~270 MB in
// scattered 32-byte sectors. The replaced one-thread-per-row kernel walked
// its row's taps with uncoalesced loads and one uniform f32 weight load per
// 4 FMAs, bound by its load-store unit. On an H100, time follows the
// sectors gathered and the warps an SM holds, not the depth of the copy
// ring: 8 units in flight a warp at one block an SM ran slower than 4 at
// two blocks.
//
// Design: persistent blocks of 8 warps take tiles of ROWS = 128 output
// rows and COLS = 16 output columns (blockIdx.y: the column group); warp w
// takes rows 16 w .. 16 w + 15 of the tile and runs its own pipeline, so
// no block barrier stands between a copy and the products that need it.
// - The weights are staged in shared memory once per block: bf16 B
//   fragments of mma.sync (exact: prep_weight rounds them to bf16), or f32
//   rows for the FMA mode. A tap's channels form one unit (an input wider
//   than CCH channels, several); when the units' weights do not fit at
//   once they are staged in windows, the block's warps in step.
// - Per tile, a warp copies its [16, K] block of nbr into shared memory
//   with cp.async, all of it in flight at once, and votes on each unit: a
//   tap that none of its rows has is skipped, and rows with no neighbour
//   at all are written as zeros.
// - Per active unit, the warp copies each row's neighbour row by cp.async
//   into its ring of STAGES = 4 staged [16, cin] tiles, in 16-, 8- or 4-byte
//   pieces as the row width and alignment allow (cin 34 gives 68-byte
//   rows; 2-byte rows are read by plain loads), missing rows zero-filled:
//   STAGES - 1 units stay in flight while the oldest is summed. Staged rows
//   are an odd number of 16-byte words apart, so ldmatrix and float4 reads
//   of 8 consecutive rows hit distinct banks.
// - bf16: mma.sync m16n8k16 bf16 x bf16 -> f32, the warp's 16 rows against
//   the 16 columns; each sum is rounded once at the end.
// - f32: f32 FMAs out of shared memory (no TF32) in the replaced kernel's
//   order, tap outer and channel inner; a lane sums 8 columns of one row.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace sgnn {
namespace {

constexpr int SLICE = 16;             // output rows a warp
constexpr int ROWS = SLICE * WARPS;   // output rows a block tile
constexpr int STAGES = 4;             // a warp's ring of staged units
constexpr int COLS = 16;              // output columns a block
constexpr int CCH = 64;               // most input channels a staged unit
constexpr int SMEM_MAX = 227 * 1024;

// bf16 sums on the tensor cores, f32 on FMAs
template <typename T>
struct Mode {
  static constexpr bool TC = sizeof(T) == 2;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
};

struct Args {
  const void* feats;
  const int* nbr;
  const float* w;  // [K, cin, coutp]
  void* out;
  int n, K, cin, cout, coutp;
  int ncc;      // channel chunks (units) a tap
  int ciu;      // channels a unit (the last of a tap may hold fewer)
  int units;    // K * ncc, tap outer
  int wu;       // units whose weights fit in shared memory at once
  int piece;    // bytes a copy piece: 16, 8, 4 (cp.async) or 2 (loads)
  int np;       // pieces a staged row
  int tpr_log;  // log2 of the lanes that copy one row
  int astride;  // bytes between staged rows
  int ksu;      // bf16: k16 steps a unit
  int ntiles;   // block tiles
  // shared memory: weights at 0, then per warp its nbr block, its list of
  // active units and its ring
  int off_nbr, nbr_stride, off_list, list_stride, off_ring;
};

__device__ __forceinline__ int unit_channels(const Args& a, int c) {
  return min(a.ciu, a.cin - c * CCH);
}

__device__ __forceinline__ bool present(const Args& a, int j) {
  return j >= 1 && j <= a.n;
}

// The warp copies unit u (tap u / ncc, channel chunk u % ncc) of its rows
// into slot: each neighbour's channels, zeros for a missing neighbour, a
// row past the table's end or the chunk's end.
template <typename T>
__device__ __forceinline__ void issue_unit(const Args& a, const int* s_nbr,
                                           unsigned char* slot, int u,
                                           int rows, int lane) {
  constexpr int SZ = static_cast<int>(sizeof(T));
  const int k = u / a.ncc, c = u % a.ncc;
  const int have = unit_channels(a, c) * SZ;  // bytes to copy a row
  const int tpr = 1 << a.tpr_log;
  const unsigned char* src0 = static_cast<const unsigned char*>(a.feats) +
                              static_cast<long long>(c) * CCH * SZ;
  for (int r = lane >> a.tpr_log; r < SLICE; r += 32 >> a.tpr_log) {
    const int j = r < rows ? s_nbr[r * a.K + k] : 0;
    const bool ok = present(a, j);
    const unsigned char* row =
        src0 + (ok ? static_cast<long long>(j - 1) * a.cin * SZ : 0);
    for (int p = lane & (tpr - 1); p < a.np; p += tpr) {
      const int off = p * a.piece;
      const bool in = ok && off < have;
      unsigned char* dst = slot + r * a.astride + off;
      if (a.piece == 2) {
        *reinterpret_cast<unsigned short*>(dst) =
            in ? *reinterpret_cast<const unsigned short*>(row + off) : 0;
        continue;
      }
      const unsigned s = smem_addr(dst);
      const unsigned char* src = in ? row + off : src0;
      const int nb = in ? a.piece : 0;
      if (a.piece == 16) {
        cp_async16(s, src, nb);
      } else if (a.piece == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                     "l"(src), "r"(nb));
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                     "l"(src), "r"(nb));
      }
    }
  }
}

// The weights of units [u0, u0 + cnt) for the columns col0 ..: bf16 B
// fragments uint2 [slot][ksu][2][32], or f32 rows [slot][ciu][COLS];
// channels past a unit's and columns past coutp zero. The whole block, a
// thread BATCH entries at a time with all their loads in flight.
template <typename T>
__device__ __forceinline__ void stage_weights(const Args& a,
                                              unsigned char* s_w, int u0,
                                              int cnt, int col0) {
  constexpr int BATCH = 8;
  // weight (unit u, channel kk of the unit, column col), 0 outside
  const auto weight = [&](int u, int kk, int col) {
    const int k = u / a.ncc, c = u % a.ncc;
    return kk < unit_channels(a, c) && col < a.coutp
               ? __ldg(a.w + (static_cast<long long>(k) * a.cin + c * CCH +
                              kk) * a.coutp + col)
               : 0.f;
  };
  if constexpr (Mode<T>::TC) {
    uint2* wf = reinterpret_cast<uint2*>(s_w);
    const int total = cnt * a.ksu * 64;
    for (int q0 = threadIdx.x; q0 < total; q0 += THREADS * BATCH) {
      float f[BATCH][4];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int q = q0 + b * THREADS;
        const int lane = q % 32, nb = q / 32 % 2, ks = q / 64 % a.ksu,
                  u = u0 + q / (64 * a.ksu);
        const int col = col0 + nb * 8 + lane / 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // B rows 2 (lane % 4) + (0, 1) and the same + 8 of the k16 step
          const int kk = ks * 16 + 8 * (e / 2) + 2 * (lane % 4) + e % 2;
          f[b][e] = q < total ? weight(u, kk, col) : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int q = q0 + b * THREADS;
        if (q >= total) break;
        unsigned v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = __bfloat16_as_ushort(__float2bfloat16_rn(f[b][e]));
        wf[q] = make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
      }
    }
  } else {
    float* ws = reinterpret_cast<float*>(s_w);
    const int total = cnt * a.ciu * COLS;
    for (int q0 = threadIdx.x; q0 < total; q0 += THREADS * BATCH) {
      float f[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int q = q0 + b * THREADS;
        f[b] = q < total ? weight(u0 + q / (COLS * a.ciu), q / COLS % a.ciu,
                                  col0 + q % COLS)
                         : 0.f;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int q = q0 + b * THREADS;
        if (q < total) ws[q] = f[b];
      }
    }
  }
}

// bf16: acc[nb][0..4) += the slot's 16 rows times the unit's B fragments,
// k16 step by step
__device__ __forceinline__ void mma_unit(const unsigned char* slot,
                                         int astride, int ksu,
                                         const uint2* wf, int lane,
                                         float (*acc)[4]) {
  // the A row this lane addresses for ldmatrix, and its 8-wide k half
  const int r = (lane & 7) + (lane >> 3 & 1) * 8, h = lane >> 4;
  const unsigned base = smem_addr(slot + r * astride) + h * 16;
  for (int ks = 0; ks < ksu; ++ks) {
    unsigned fa[4];
    ldmatrix_x4(fa, base + ks * 32);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const uint2 u = wf[(ks * 2 + nb) * 32 + lane];
      const unsigned fb[2] = {u.x, u.y};
      mma_bf16(acc[nb], fa, fb);
    }
  }
}

// FMA mode: acc[0..8) += the slot's row (lane % 16) nch channels times the
// unit's weight rows, columns 8 (lane / 16) .., channel by channel
template <typename T>
__device__ __forceinline__ void fma_unit(const unsigned char* slot,
                                         int astride, int nch,
                                         const float* ws, int lane,
                                         float* acc) {
  constexpr int VEC = Mode<T>::VEC;
  const uint4* p = reinterpret_cast<const uint4*>(slot + (lane & 15) *
                                                              astride);
  const float* wl = ws + 8 * (lane >> 4);
  for (int v = 0; v * VEC < nch; ++v) {
    const uint4 u = p[v];
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int ci = v * VEC + e;
      if (ci < nch) {
        const float x = to_f(t[e]);
        const float4 w0 = *reinterpret_cast<const float4*>(wl + ci * COLS);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wl + ci * COLS + 4);
        acc[0] = fmaf(x, w0.x, acc[0]);
        acc[1] = fmaf(x, w0.y, acc[1]);
        acc[2] = fmaf(x, w0.z, acc[2]);
        acc[3] = fmaf(x, w0.w, acc[3]);
        acc[4] = fmaf(x, w1.x, acc[4]);
        acc[5] = fmaf(x, w1.y, acc[5]);
        acc[6] = fmaf(x, w1.z, acc[6]);
        acc[7] = fmaf(x, w1.w, acc[7]);
      }
    }
  }
}

// o[0..min(n, N)) = v rounded to T; vec: as 4-byte (bf16 pairs) or
// 16-byte (f32 quads) stores (N a multiple of their width, o aligned)
template <typename T, int N>
__device__ __forceinline__ void store_cols(T* o, const float* v, int n,
                                           bool vec) {
  if (vec && n >= N) {
    if constexpr (sizeof(T) == 2 && N % 2 == 0) {
#pragma unroll
      for (int e = 0; e < N; e += 2)
        *reinterpret_cast<__nv_bfloat162*>(o + e) =
            __floats2bfloat162_rn(v[e], v[e + 1]);
      return;
    } else if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(o + e) =
            make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      return;
    }
  }
  for (int e = 0; e < min(n, N); ++e) o[e] = from_f<T>(v[e]);
}

// two blocks an SM where shared memory allows (bf16 up to cin 48)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    gather_gemm_kernel(const Args a) {
  using M = Mode<T>;
  constexpr int S = STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned char* s_w = smem;
  int* s_nbr = reinterpret_cast<int*>(smem + a.off_nbr +
                                      warp * a.nbr_stride);  // [16, K]
  int* s_list = reinterpret_cast<int*>(smem + a.off_list +
                                       warp * a.list_stride);
  const int sbytes = SLICE * a.astride;  // a ring slot
  unsigned char* ring = smem + a.off_ring + warp * S * sbytes;
  const int col0 = blockIdx.y * COLS;
  T* out = static_cast<T*>(a.out);
  // channels past cin stay zero: no copy writes them
  for (int i = lane; i < S * sbytes / 16; i += 32)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  const int nwin = (a.units + a.wu - 1) / a.wu;
  if (nwin == 1) {
    stage_weights<T>(a, s_w, 0, a.units, col0);
    __syncthreads();
  }
  int resident = nwin == 1 ? 0 : -1;  // the window of staged weights
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const long long r0 = static_cast<long long>(tile) * ROWS + warp * SLICE;
    const int rows = static_cast<int>(
        max(0LL, min(static_cast<long long>(SLICE), a.n - r0)));
    // the warp's nbr block, every 4-byte piece in flight at once, once
    // every lane is done with the previous tile's block and list
    __syncwarp();
    const int* g = a.nbr + r0 * a.K;
    for (int i = lane; i < rows * a.K; i += 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(s_nbr + i)),
                   "l"(g + i));
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    // the active units: some row has the tap's neighbour
    int cnt = 0;
    for (int base = 0; base < a.units; base += 32) {
      const int u = base + lane;
      bool act = false;
      if (u < a.units) {
        const int k = u / a.ncc;
        for (int r = 0; r < rows; ++r) act |= present(a, s_nbr[r * a.K + k]);
      }
      const unsigned m = __ballot_sync(0xffffffffu, act);
      if (act) s_list[cnt + __popc(m & ((1u << lane) - 1))] = u;
      cnt += __popc(m);
    }
    __syncwarp();
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    int i0 = 0;  // the window's first active unit in s_list
    for (int win = 0; win < nwin; ++win) {
      const int ubeg = win * a.wu, uend = min(a.units, ubeg + a.wu);
      if (nwin > 1) {  // the block's warps in step
        __syncthreads();
        if (resident != win) stage_weights<T>(a, s_w, ubeg, uend - ubeg,
                                              col0);
        resident = win;
        __syncthreads();
      }
      int i1 = i0;
      while (i1 < cnt && s_list[i1] < uend) ++i1;
      const int c = i1 - i0;
      __syncwarp();  // every lane is done with the ring
#pragma unroll
      for (int p = 0; p < S - 1; ++p) {
        if (p < c) issue_unit<T>(a, s_nbr, ring + p * sbytes,
                                 s_list[i0 + p], rows, lane);
        cp_async_commit();
      }
      for (int i = 0; i < c; ++i) {
        cp_async_wait<S - 2>();
        // unit i is visible to the warp, and every lane is done with unit
        // i - 1's slot, which the next copies take
        __syncwarp();
        const int nx = i + S - 1;
        if (nx < c) issue_unit<T>(a, s_nbr, ring + nx % S * sbytes,
                                  s_list[i0 + nx], rows, lane);
        cp_async_commit();
        const int u = s_list[i0 + i], slot = u - ubeg;
        const unsigned char* buf = ring + i % S * sbytes;
        if constexpr (M::TC) {
          mma_unit(buf, a.astride, a.ksu,
                   reinterpret_cast<const uint2*>(s_w) + slot * a.ksu * 64,
                   lane, reinterpret_cast<float(*)[4]>(acc));
        } else {
          fma_unit<T>(buf, a.astride, unit_channels(a, u % a.ncc),
                      reinterpret_cast<const float*>(s_w) +
                          slot * a.ciu * COLS,
                      lane, acc);
        }
      }
      i0 = i1;
    }
    if (rows == 0) continue;
    if (cnt == 0) {  // no row of the warp has a neighbour
      for (int q = lane; q < rows * COLS; q += 32) {
        const int col = col0 + q % COLS;
        if (col < a.cout)
          out[(r0 + q / COLS) * a.cout + col] = from_f<T>(0.f);
      }
      continue;
    }
    if constexpr (M::TC) {
      const int gid = lane / 4, tig = lane % 4;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = gid + 8 * hi;
        if (row >= rows) continue;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int col = col0 + nb * 8 + 2 * tig;
          const float v[2] = {acc[4 * nb + 2 * hi], acc[4 * nb + 2 * hi + 1]};
          if (col < a.cout)
            store_cols<T, 2>(out + (r0 + row) * a.cout + col, v,
                             a.cout - col, a.cout % 2 == 0);
        }
      }
    } else {
      const int row = lane & 15, col = col0 + 8 * (lane >> 4);
      if (row < rows && col < a.cout)
        store_cols<T, 8>(out + (r0 + row) * a.cout + col, acc, a.cout - col,
                         a.cout % 4 == 0);
    }
  }
}

template <typename T>
int launch_gather_gemm(const void* feats, const int* nbr, const float* w,
                       void* out, int n, int K, int cin, int cout, int coutp,
                       int vec_in, cudaStream_t stream) {
  using M = Mode<T>;
  constexpr int SZ = static_cast<int>(sizeof(T));
  Args a{};
  a.feats = feats;
  a.nbr = nbr;
  a.w = w;
  a.out = out;
  a.n = n;
  a.K = K;
  a.cin = cin;
  a.cout = cout;
  a.coutp = coutp;
  a.ncc = (cin + CCH - 1) / CCH;
  a.ciu = std::min(cin, CCH);
  a.units = K * a.ncc;
  // the widest piece that divides every row's bytes at the table's
  // alignment (a chunk boundary, CCH values, is 16-byte aligned)
  const auto addr = reinterpret_cast<uintptr_t>(feats);
  const int rb = cin * SZ;
  a.piece = vec_in                         ? 16
            : rb % 8 == 0 && addr % 8 == 0 ? 8
            : rb % 4 == 0 && addr % 4 == 0 ? 4
                                           : 2;
  if (a.piece < SZ || addr % a.piece)
    return static_cast<int>(cudaErrorMisalignedAddress);
  a.np = a.ciu * SZ / a.piece;
  while ((1 << a.tpr_log) < std::min(a.np, 32)) ++a.tpr_log;
  const int cinp = M::TC ? (a.ciu + 15) / 16 * 16
                         : (a.ciu + M::VEC - 1) / M::VEC * M::VEC;
  int words = cinp * SZ / 16;
  if (words % 2 == 0) ++words;
  a.astride = words * 16;
  a.ksu = cinp / 16;
  const auto up16 = [](long long b) { return (b + 15) / 16 * 16; };
  const long long nbr_stride = up16(4LL * SLICE * K);
  const long long list_stride = up16(4LL * a.units);
  const long long fixed =
      WARPS * (nbr_stride + list_stride +
               static_cast<long long>(STAGES) * SLICE * a.astride);
  const long long unit_w =
      M::TC ? 512LL * a.ksu : 4LL * a.ciu * COLS;  // a unit's weights
  if (fixed + unit_w > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.wu = static_cast<int>(
      std::min<long long>(a.units, (SMEM_MAX - fixed) / unit_w));
  a.off_nbr = static_cast<int>(up16(a.wu * unit_w));
  a.nbr_stride = static_cast<int>(nbr_stride);
  a.off_list = a.off_nbr + WARPS * a.nbr_stride;
  a.list_stride = static_cast<int>(list_stride);
  a.off_ring = a.off_list + WARPS * a.list_stride;
  const int bytes = static_cast<int>(
      a.off_ring + WARPS * static_cast<long long>(STAGES) * SLICE *
                       a.astride);
  const long long ntiles = (static_cast<long long>(n) + ROWS - 1) / ROWS;
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.ntiles = static_cast<int>(ntiles);
  const int groups = (cout + COLS - 1) / COLS;
  const auto kernel = gather_gemm_kernel<T>;
  // the attribute belongs to the current device: set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e != cudaSuccess || (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, bytes)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  // persistent: as many blocks as the card holds at once, at most a tile
  // each
  const long long room =
      std::max(1LL, 1LL * sms * std::max(per_sm, 1) / groups);
  const dim3 grid(static_cast<unsigned>(std::min(ntiles, room)), groups);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sgnn

using namespace sgnn;

// feats [n, cin], out [n, cout] (bf16: 1 for bfloat16, 0 for float32);
// nbr [n, K] int32; w f32 [K, cin, coutp], coutp a multiple of co (4, 8
// or 16) and >= cout, values rounded to the compute type. vec_in: feats
// rows may be read as 16-byte vectors.
extern "C" int sgnn_gather_gemm(const void* feats, const int* nbr,
                                const float* w, void* out, int n, int K,
                                int cin, int cout, int coutp, int co,
                                int vec_in, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || K < 1 || cin < 1 || cout < 1 || co < 1 || coutp % co ||
      coutp < cout || coutp - cout >= co) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch_gather_gemm<__nv_bfloat16>(feats, nbr, w, out, n, K,
                                                  cin, cout, coutp, vec_in, s)
              : launch_gather_gemm<float>(feats, nbr, w, out, n, K, cin,
                                          cout, coutp, vec_in, s);
}
