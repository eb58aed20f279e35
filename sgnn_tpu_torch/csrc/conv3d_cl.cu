// K8 and K9, the zero-padded 3^3 convolution over a channels-last grid.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py _conv_impl (:178, the
// pallas_call at :191) behind conv3d_3x3x3_folded (:268, custom VJP
// :279-300), K8, which models/dense_flow.py:_conv_one routes every
// eligible 3^3 conv of the dense-flow execution through under
// cfg.use_pallas_conv (C in {8, 16, 32}, Cout <= C); and
// sgnn_tpu/ops/pallas/conv3d.py conv3d_3x3x3_pallas (:77, the
// pallas_call at :103), K9, the experimental form for any Cout (and, on
// this card, Cin up to 64), which no entry point of the JAX package
// reaches. Both compute
//
//   out[b, z, y, x] = round(sum_taps sum_ci
//                     in[b, z + dz - 1, y + dy - 1, x + dx - 1][ci]
//                     * W[tap][ci][:])                    f32 sums
//
// x [B, Z, Y, X, cin] and out [B, Z, Y, X, cout] in the compute type;
// neighbours outside the volume are zero; W arrives as f32 [27, cin,
// coutp] rounded to the compute type, taps in C order over (dz, dy, dx)
// (common.cuh, row kernels). Each entry point has a kernel of its own
// (conv3d_brick_kernel, conv3d_any_brick_kernel), and both run one body,
// conv3d_bricks.
//
// What bounds it on Hopper: the bytes, if the products run on the tensor
// cores. At the dense-flow execution's full resolution (96x192x192, C = 8,
// bf16) the call reads and writes 57 MB each (~0.034 ms); the MACs of the
// masked grid's non-zero voxels take a small fraction of that at the bf16
// tensor-core rate, but a brick that holds one non-zero voxel computes all
// of its 256 outputs.
// Design (K7's, conv_raw.cu, on this layout): persistent blocks of 256
// threads walk output bricks of 2 x 4 x 32 voxels, x fastest. Each brick's
// halo'd input (4 x 6 x 34 voxels, zero outside [0, Z) x [0, Y) x [0, X):
// there is no halo ring, and X need not be a multiple of 32) is staged in
// shared memory by cp.async, two buffers deep where two fit (the next
// brick's copies fly while this one computes), XOR-swizzled (common.cuh,
// chunk_off). A staged voxel holds CP channels: cin padded with zeros to
// the next of 8, 16, 32, 48 or 64. A row of cin values that is not a
// multiple of 16 bytes, or not 16-byte aligned, is copied in the largest
// words of 8 or 4 bytes that divide it and its address, else (an odd cin
// in bf16) by plain 2-byte loads and stores. A brick whose staged input is
// all zero (-0 counts as zero) writes zeros and skips the products; the
// input gradient's dense cotangent skips nothing.
// - bf16: mma.sync m16n8k16, bf16 x bf16 -> f32. Warp w takes brick row w
//   as two M tiles of 16 consecutive x; K runs over (tap, ci < CP), two
//   taps a k16 step at CP = 8 (a 28th tap of zero weights pads the last),
//   one at 16, two or more k16 steps a tap above; N is the block's NB
//   output columns in 8-wide tiles, zero weight columns past coutp and
//   zero weight rows past cin. A rows come from the staged slots by
//   ldmatrix; B fragments are built once per block from the f32 weights,
//   which hold bf16 values (prep_weight rounds them), so the conversion is
//   exact. The sums are f32 in the tensor cores' order, rounded once per
//   output.
// - f32: f32 FMAs on the CUDA cores in (tap, ci) order (no TF32), the
//   order of the one-thread-per-voxel kernels these designs replaced, so
//   the outputs are theirs bit for bit (a zero input's product adds
//   exactly nothing: the sums start at +0 and never become -0, which is
//   also why the replaced K9's skips of zero inputs and of neighbours
//   outside the volume cost nothing here). A thread takes half of the
//   block's NB output columns of two voxels (v and v + 128), so each
//   uniform weight load serves two voxels.
// Outputs go through shared memory (the brick's own buffer, free once its
// products are done) as a [256][nb] tile, and each warp writes its brick
// row's outputs: one contiguous run as 16-byte vectors where it is
// aligned, else element by element (Cout 1 and 12 occur in the dense
// flow). Where Cout exceeds NB (K9 only), blockIdx.y picks the block's NB
// columns: each block stages its own B fragments and reads every brick's
// input once per column group. Shared memory per instantiation (BrickSmem):
// at C48->40 in bf16 two staged bricks (2 x 78 KB) and the B fragments of
// all five N tiles (104 KB) exceed 227 KB, so N is split across blocks
// (three groups of 16 columns, 41 KB of fragments each) rather than
// giving up the second buffer; f32 at CP 48 and 64 (157 and 209 KB a
// brick) and bf16 at CP 64 keep one buffer. Blocks an SM (launch bounds):
// CP = 8 4 (K8 bf16 ~30 KB, f32 ~52 KB; 2 ran slower on a masked grid),
// CP = 16 2 (bf16 ~66 KB, f32 ~104 KB; 3 ran slower on a dense input),
// else 1 (K8 at C = 32: bf16 ~160 KB, the B fragments alone 55 KB; f32
// ~204 KB).
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace sgnn {
namespace {

constexpr int SMEM_MAX = 227 * 1024;  // a block's shared memory on Hopper

// Shared memory of a block, byte offsets. CP: channels of a staged voxel;
// NB: output columns a block computes (bf16 NB / 8 N tiles; f32 two
// halves of NB / 2 columns).
template <typename T, int CP, int NB>
struct BrickSmem {
  static constexpr bool TC = sizeof(T) == 2;    // bf16: the tensor cores
  static constexpr int NC = CP * static_cast<int>(sizeof(T)) / 16;
  static constexpr int BUF = NH * NC * 16;      // one staged brick
  static constexpr int KSTEPS = (27 * CP + 15) / 16;  // k16 steps
  static constexpr int NT = NB / 8;             // 8-wide N tiles
  static constexpr int WFB = TC ? KSTEPS * NT * 32 * 8 : 0;
  static constexpr int NBUF = 2 * BUF + WFB <= SMEM_MAX ? 2 : 1;
  static constexpr int IN = 0;                  // brick i in buffer i % NBUF
  static constexpr int WF = IN + NBUF * BUF;    // uint2 [KSTEPS][NT][32]
  static constexpr int BYTES = WF + WFB;
  static constexpr int MIN_BLOCKS = CP == 8 ? 4 : CP == 16 ? 2 : 1;
  static_assert(CP % 8 == 0 && NB % (TC ? 8 : 4) == 0, "tile widths");
  static_assert(BYTES <= SMEM_MAX, "a block's shared memory");
  static_assert(NV * NB * static_cast<int>(sizeof(T)) <= BUF,
                "the output tile fits a brick's buffer");
};

// 8 or 4 bytes from global memory at p to shared address s, or as many
// zero bytes (n = 0), asynchronously (through L1: cp.async.cg copies 16
// bytes only)
__device__ __forceinline__ void cp_async8(unsigned s, const void* p, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(p), "r"(n));
}

__device__ __forceinline__ void cp_async4(unsigned s, const void* p, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(p), "r"(n));
}

// Starts the copies of brick k's halo'd input (rows z0 - 1 .. z0 + 2,
// y0 - 1 .. y0 + 4, x0 - 1 .. x0 + 32) into buf, cin channels a voxel and
// zeros up to CP, zero outside the volume, as one copy group. wb: the
// bytes of a copy (16, 8, 4, or 2 by plain loads and stores), which divide
// a row of cin values and x's address.
template <typename T, int CP>
__device__ __forceinline__ void stage_brick(unsigned char* buf,
                                            const T* __restrict__ x,
                                            const Brick& k, int Z, int Y,
                                            int X, int cin, int wb) {
  constexpr int NC = CP * static_cast<int>(sizeof(T)) / 16;
  const unsigned sbuf = smem_addr(buf);
  if (wb == 16) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    const int rc = cin / E;  // the chunks a row fills
    for (int q = threadIdx.x; q < NH * NC; q += THREADS) {
      const int i = q / NC, c = q % NC;
      const int z = k.z0 - 1 + i / (HY * HX), y = k.y0 - 1 + i / HX % HY,
                xx = k.x0 - 1 + i % HX;
      const bool in = c < rc && z >= 0 && z < Z && y >= 0 && y < Y &&
                      xx >= 0 && xx < X;
      const T* p =
          in ? x + voxel_index(k.b, z, y, xx, Z, Y, X) * cin + c * E : x;
      cp_async16(sbuf + chunk_off<NC>(i, c), p, in ? 16 : 0);
    }
  } else {
    const int nw = CP * static_cast<int>(sizeof(T)) / wb;  // words a slot
    const int rw = cin * static_cast<int>(sizeof(T)) / wb;  // words a row
    for (int q = threadIdx.x; q < NH * nw; q += THREADS) {
      const int i = q / nw, j = q % nw;
      const int z = k.z0 - 1 + i / (HY * HX), y = k.y0 - 1 + i / HX % HY,
                xx = k.x0 - 1 + i % HX;
      const bool in = j < rw && z >= 0 && z < Z && y >= 0 && y < Y &&
                      xx >= 0 && xx < X;
      const char* p =
          reinterpret_cast<const char*>(
              in ? x + voxel_index(k.b, z, y, xx, Z, Y, X) * cin : x) +
          (in ? j * wb : 0);
      const int off = chunk_off<NC>(i, j * wb / 16) + j * wb % 16;
      if (wb == 8) {
        cp_async8(sbuf + off, p, in ? 8 : 0);
      } else if (wb == 4) {
        cp_async4(sbuf + off, p, in ? 4 : 0);
      } else {
        *reinterpret_cast<unsigned short*>(buf + off) =
            in ? *reinterpret_cast<const unsigned short*>(p) : 0;
      }
    }
  }
  cp_async_commit();
}

// The B fragments of every k16 step and of the block's NT N tiles: bf16
// from the f32 weights [27, cin, coutp]; row k of step j is flattened
// (tap, ci) index 16 j + k over CP channels a tap, zero past the 27th tap,
// past cin and past coutp; column n of tile nt is output n0 + 8 nt + n.
template <int CP, int NT>
__device__ __forceinline__ void stage_weights(uint2* wf,
                                              const float* __restrict__ w,
                                              int cin, int coutp, int n0) {
  constexpr int KSTEPS = (27 * CP + 15) / 16;
  for (int q = threadIdx.x; q < KSTEPS * NT * 32; q += THREADS) {
    const int lane = q % 32, nt = q / 32 % NT, j = q / (32 * NT);
    const int n = n0 + nt * 8 + lane / 4;
    unsigned v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * j + 8 * h + 2 * (lane % 4) + e;
        const int tap = k / CP, ci = k % CP;
        const float f = tap < 27 && ci < cin && n < coutp
                            ? __ldg(w + (tap * cin + ci) * coutp + n)
                            : 0.f;
        word |= static_cast<unsigned>(
                    __bfloat16_as_ushort(__float2bfloat16_rn(f)))
                << (16 * e);
      }
      v[h] = word;
    }
    wf[q] = make_uint2(v[0], v[1]);
  }
}

// bf16: warp w's brick row through the tensor cores; acc[mt][nt] is the C
// fragment of M tile mt (x 16 mt ..) and N tile nt.
template <int CP, int NT>
__device__ __forceinline__ void mma_row(const unsigned char* buf,
                                        const uint2* wf,
                                        float (*acc)[NT][4]) {
  constexpr int NC = CP * 2 / 16, KSTEPS = (27 * CP + 15) / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // the A row this lane addresses for ldmatrix, and its 8-wide k half
  const int r = (lane & 7) + (lane >> 3 & 1) * 8, h = lane >> 4;
  const unsigned base = smem_addr(buf);
  int cs[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    cs[mt] = center_slot(warp * BX + mt * 16 + r);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
#pragma unroll  // the taps' offsets become constants
  for (int j = 0; j < KSTEPS; ++j) {
    // this lane's k half: flattened (tap, ci) 16 j + 8 h .., one chunk
    const int k = 16 * j + 8 * h;
    const int tap = k / CP, c = k % CP / 8;
    const int off = tap < 27 ? tap_offset(tap) : 0;
    unsigned b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 u = wf[(j * NT + nt) * 32 + lane];
      b[nt][0] = u.x;
      b[nt][1] = u.y;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned a[4];
      ldmatrix_x4(a, base + chunk_off<NC>(cs[mt] + off, c));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
    }
  }
}

// acc[0..CW) += v * w[0..CW): float4 loads, float2 at CW = 2
template <int CW>
__device__ __forceinline__ void axpy_cw(float* acc, float v,
                                        const float* __restrict__ w) {
  if constexpr (CW % 4 == 0) {
    axpy<CW>(acc, v, w);
  } else {
    const float2 wv = __ldg(reinterpret_cast<const float2*>(w));
    acc[0] = fmaf(v, wv.x, acc[0]);
    acc[1] = fmaf(v, wv.y, acc[1]);
  }
}

// f32: CW output columns of voxels v0 and v0 + NV / 2 over the staged
// brick, in (tap, ci) order; w points at the first column in tap 0's row
// ci = 0 of the weights [27, cin, coutp]
template <int CP, int CW>
__device__ __forceinline__ void fma_pair(const unsigned char* buf, int v0,
                                         const float* __restrict__ w,
                                         int cin, int coutp,
                                         float (*acc)[CW]) {
  constexpr int NC = CP / 4;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[j][c] = 0.f;
  const int s0 = center_slot(v0), s1 = center_slot(v0 + NV / 2);
  for (int tap = 0; tap < 27; ++tap) {
    const int off = tap_offset(tap);
    const float* wt = w + tap * cin * coutp;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (4 * c >= cin) break;
      const float4 u0 = *reinterpret_cast<const float4*>(
          buf + chunk_off<NC>(s0 + off, c));
      const float4 u1 = *reinterpret_cast<const float4*>(
          buf + chunk_off<NC>(s1 + off, c));
      const float a0[4] = {u0.x, u0.y, u0.z, u0.w};
      const float a1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * c + e >= cin) break;
        axpy_cw<CW>(acc[0], a0[e], wt + (4 * c + e) * coutp);
        axpy_cw<CW>(acc[1], a1[e], wt + (4 * c + e) * coutp);
      }
    }
  }
}

// dst[0..n) = src[0..n) (shared memory, 16-byte aligned), or zeros (src
// null), by the 32 lanes of a warp: 16-byte vectors where dst is aligned,
// then the rest element by element
template <typename T>
__device__ __forceinline__ void write_run(T* __restrict__ dst, const T* src,
                                          int n) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x % 32;
  int done = 0;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int words = n / E;
    for (int i = lane; i < words; i += 32) {
      reinterpret_cast<uint4*>(dst)[i] =
          src != nullptr ? reinterpret_cast<const uint4*>(src)[i]
                         : make_uint4(0u, 0u, 0u, 0u);
    }
    done = words * E;
  }
  for (int i = done + lane; i < n; i += 32)
    dst[i] = src != nullptr ? src[i] : from_f<T>(0.f);
}

// A brick row's outputs, by the 32 lanes of a warp: n voxels from dst (the
// first voxel's column n0), nb columns of each from src ([n][nb], shared
// memory) or zeros (src null); one run where the block has every column
template <typename T>
__device__ __forceinline__ void write_cols(T* __restrict__ dst, const T* src,
                                           int n, int nb, int cout) {
  if (nb == cout) {
    write_run<T>(dst, src, n * cout);
    return;
  }
  for (int e = threadIdx.x % 32; e < n * nb; e += 32) {
    const int v = e / nb, c = e - v * nb;
    dst[v * cout + c] = src != nullptr ? src[e] : from_f<T>(0.f);
  }
}

// The body of both kernels: this block's columns n0 = NB blockIdx.y ..
// (nb of them) over bricks blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename T, int CP, int NB>
__device__ __forceinline__ void conv3d_bricks(
    const T* __restrict__ x, const float* __restrict__ w,
    T* __restrict__ out, int Z, int Y, int X, int cin, int cout, int coutp,
    int wb, int nbx, int nby, int nbz, int nbricks) {
  using S = BrickSmem<T, CP, NB>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int n0 = blockIdx.y * NB, nb = min(NB, cout - n0);
  if constexpr (S::TC) {  // visible after the first brick's barrier
    stage_weights<CP, S::NT>(reinterpret_cast<uint2*>(smem + S::WF), w, cin,
                             coutp, n0);
  }
  int brick = blockIdx.x;
  if (S::NBUF == 2 && brick < nbricks) {
    stage_brick<T, CP>(smem + S::IN, x, brick_at(brick, nbx, nby, nbz), Z,
                       Y, X, cin, wb);
  }
  for (int it = 0; brick < nbricks; ++it, brick += gridDim.x) {
    unsigned char* buf = smem + S::IN + it % S::NBUF * S::BUF;
    const Brick k = brick_at(brick, nbx, nby, nbz);
    if constexpr (S::NBUF == 1) {
      __syncthreads();  // every thread is done with the previous brick
      stage_brick<T, CP>(buf, x, k, Z, Y, X, cin, wb);
    }
    cp_async_wait<0>();
    // words smaller than a chunk: the chunks a thread tests are other
    // threads' copies too
    if (wb != 16) __syncthreads();
    const bool mine = own_chunks_nonzero<T, S::NC>(buf);
    // every thread is done with the previous brick and every copy of this
    // one is visible
    const bool any = __syncthreads_or(mine);
    const int next = brick + gridDim.x;
    if (S::NBUF == 2 && next < nbricks) {
      stage_brick<T, CP>(smem + S::IN + (it + 1) % 2 * S::BUF, x,
                         brick_at(next, nbx, nby, nbz), Z, Y, X, cin, wb);
    }
    // warp w's brick row: n voxels from x0
    const int z = k.z0 + warp / BY, y = k.y0 + warp % BY;
    const bool row = z < Z && y < Y;
    const int n = min(BX, X - k.x0);
    T* orow = out + voxel_index(k.b, row ? z : 0, row ? y : 0, k.x0, Z, Y,
                                X) * cout + n0;
    if (!any) {
      if (row) write_cols<T>(orow, nullptr, n, nb, cout);
      continue;
    }
    T* tile = reinterpret_cast<T*>(buf);  // [NV][nb], once buf is read
    if constexpr (S::TC) {
      float acc[2][S::NT][4];
      mma_row<CP, S::NT>(buf, reinterpret_cast<const uint2*>(smem + S::WF),
                         acc);
      __syncthreads();
      const int lane = tid % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = warp * BX + mt * 16 + gid + 8 * (e / 2);
            const int c = nt * 8 + 2 * tig + e % 2;
            if (c < nb) tile[v * nb + c] = from_f<T>(acc[mt][nt][e]);
          }
    } else {
      constexpr int CW = NB / 2;  // columns a thread
      const int h = tid / (NV / 2), v0 = tid % (NV / 2);
      float acc[2][CW];
      fma_pair<CP, CW>(buf, v0, w + n0 + CW * h, cin, coutp, acc);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          if (CW * h + c < nb)
            tile[(v0 + j * NV / 2) * nb + CW * h + c] = acc[j][c];
        }
    }
    __syncthreads();
    if (row) write_cols<T>(orow, tile + warp * BX * nb, n, nb, cout);
  }
}

// K8: C = cin in {8, 16, 32}, rows of 16-byte chunks
template <typename T, int C, int NB>
__global__ void __launch_bounds__(THREADS, BrickSmem<T, C, NB>::MIN_BLOCKS)
    conv3d_brick_kernel(const T* __restrict__ x,
                        const float* __restrict__ w,  // [27, C, coutp]
                        T* __restrict__ out, int Z, int Y, int X, int,
                        int cout, int coutp, int, int nbx, int nby, int nbz,
                        int nbricks) {
  conv3d_bricks<T, C, NB>(x, w, out, Z, Y, X, C, cout, coutp, 16, nbx, nby,
                          nbz, nbricks);
}

// K9: any cin <= CP
template <typename T, int CP, int NB>
__global__ void __launch_bounds__(THREADS, BrickSmem<T, CP, NB>::MIN_BLOCKS)
    conv3d_any_brick_kernel(const T* __restrict__ x,
                            const float* __restrict__ w,  // [27, cin, coutp]
                            T* __restrict__ out, int Z, int Y, int X,
                            int cin, int cout, int coutp, int wb, int nbx,
                            int nby, int nbz, int nbricks) {
  conv3d_bricks<T, CP, NB>(x, w, out, Z, Y, X, cin, cout, coutp, wb, nbx,
                           nby, nbz, nbricks);
}

template <typename T, int CP, int NB, bool ANY>
int launch_bricks(const void* x, const float* w, void* out, int B, int Z,
                  int Y, int X, int cin, int cout, int coutp, int wb,
                  cudaStream_t stream) {
  using S = BrickSmem<T, CP, NB>;
  void (*kernel)(const T*, const float*, T*, int, int, int, int, int, int,
                 int, int, int, int, int);
  if constexpr (ANY) {
    kernel = conv3d_any_brick_kernel<T, CP, NB>;
  } else {
    kernel = conv3d_brick_kernel<T, CP, NB>;
  }
  // above 48 KB only once the kernel allows it; the attribute belongs to
  // the current device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nbx = (X + BX - 1) / BX, nby = (Y + BY - 1) / BY,
            nbz = (Z + BZ - 1) / BZ;
  const long long nbricks = static_cast<long long>(B) * nbz * nby * nbx;
  if (nbricks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (cout + NB - 1) / NB;  // column groups (blockIdx.y)
  // persistent: as many blocks as the card holds at once over all column
  // groups (which then walk the same bricks together), at most a brick
  // each
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, S::BYTES)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const long long fit = std::max(1LL, static_cast<long long>(sms) *
                                          std::max(per_sm, 1) / groups);
  const dim3 grid(static_cast<unsigned>(std::min(nbricks, fit)), groups);
  kernel<<<grid, THREADS, S::BYTES, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), Z, Y, X, cin, cout,
      coutp, wb, nbx, nby, nbz, static_cast<int>(nbricks));
  return static_cast<int>(cudaGetLastError());
}

// K8's instantiations: bf16 N tiles over C, f32 CW = coutp / 2
template <int C>
int dispatch_brick(const void* x, const float* w, void* out, int B, int Z,
                   int Y, int X, int cout, int coutp, int bf16,
                   cudaStream_t s) {
  if (bf16) {
    return launch_bricks<__nv_bfloat16, C, C, false>(x, w, out, B, Z, Y, X,
                                                     C, cout, coutp, 16, s);
  }
  switch (coutp) {
    case 4:
      return launch_bricks<float, C, 4, false>(x, w, out, B, Z, Y, X, C,
                                               cout, coutp, 16, s);
    case 8:
      return launch_bricks<float, C, 8, false>(x, w, out, B, Z, Y, X, C,
                                               cout, coutp, 16, s);
    case 16:
      if constexpr (C >= 16) {
        return launch_bricks<float, C, 16, false>(x, w, out, B, Z, Y, X, C,
                                                  cout, coutp, 16, s);
      }
      break;
    case 32:
      if constexpr (C == 32) {
        return launch_bricks<float, C, 32, false>(x, w, out, B, Z, Y, X, C,
                                                  cout, coutp, 16, s);
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9's instantiations at one CP: bf16 8 or 16 columns a block (32 at CP
// 32), f32 the widest of 32 (CP >= 16), 16, 8 and 4 that divides coutp
template <typename T, int CP>
int dispatch_any_cp(const void* x, const float* w, void* out, int B, int Z,
                    int Y, int X, int cin, int cout, int coutp, int wb,
                    cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (coutp <= 8) {
      return launch_bricks<T, CP, 8, true>(x, w, out, B, Z, Y, X, cin, cout,
                                           coutp, wb, s);
    }
    if constexpr (CP == 32) {
      if (coutp > 16) {
        return launch_bricks<T, CP, 32, true>(x, w, out, B, Z, Y, X, cin,
                                              cout, coutp, wb, s);
      }
    }
    return launch_bricks<T, CP, 16, true>(x, w, out, B, Z, Y, X, cin, cout,
                                          coutp, wb, s);
  } else {
    if constexpr (CP >= 16) {
      if (coutp % 32 == 0) {
        return launch_bricks<T, CP, 32, true>(x, w, out, B, Z, Y, X, cin,
                                              cout, coutp, wb, s);
      }
    }
    if (coutp % 16 == 0) {
      return launch_bricks<T, CP, 16, true>(x, w, out, B, Z, Y, X, cin,
                                            cout, coutp, wb, s);
    }
    if (coutp % 8 == 0) {
      return launch_bricks<T, CP, 8, true>(x, w, out, B, Z, Y, X, cin, cout,
                                           coutp, wb, s);
    }
    return launch_bricks<T, CP, 4, true>(x, w, out, B, Z, Y, X, cin, cout,
                                         coutp, wb, s);
  }
}

// K9: cin padded to the next CP of 8, 16, 32, 48 and 64
template <typename T>
int dispatch_any(const void* x, const float* w, void* out, int B, int Z,
                 int Y, int X, int cin, int cout, int coutp, int wb,
                 cudaStream_t s) {
  if (cin <= 8) {
    return dispatch_any_cp<T, 8>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                 wb, s);
  }
  if (cin <= 16) {
    return dispatch_any_cp<T, 16>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                  wb, s);
  }
  if (cin <= 32) {
    return dispatch_any_cp<T, 32>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                  wb, s);
  }
  if (cin <= 48) {
    return dispatch_any_cp<T, 48>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                  wb, s);
  }
  return dispatch_any_cp<T, 64>(x, w, out, B, Z, Y, X, cin, cout, coutp, wb,
                                s);
}

// The copy size of K9's staging: 16 bytes where the wrapper says rows of
// cin values are whole aligned 16-byte vectors (vec_in), else the largest
// of 8, 4 and 2 that divides a row's bytes and x's address
int word_bytes(const void* x, int row_bytes, int vec_in) {
  if (vec_in) return 16;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  for (int wb = 8; wb > 2; wb /= 2)
    if (row_bytes % wb == 0 && a % wb == 0) return wb;
  return 2;
}

bool bad_shape(int B, int Z, int Y, int X, int cin, int cout, int coutp,
               int co) {
  return B < 1 || Z < 1 || Y < 1 || X < 1 || cin < 1 || cout < 1 ||
         co < 1 || coutp % co || coutp < cout || coutp - cout >= co ||
         coutp % 4;
}

}  // namespace
}  // namespace sgnn

using namespace sgnn;

// x [B, Z, Y, X, cin], out [B, Z, Y, X, cout] (bf16: 1 for bfloat16, 0 for
// float32); w f32 [27, cin, coutp], coutp a multiple of co (4, 8 or 16)
// and >= cout; vec_in: x rows may be read as 16-byte vectors (x 16-byte
// aligned).
// K8's entry point: cin 8, 16 or 32, cout <= cin, vec_in 1 (the wrapper
// admits only conv3d_folded's shapes and aligns x).
extern "C" int sgnn_conv3d_folded(const void* x, const float* w, void* out,
                                  int B, int Z, int Y, int X, int cin,
                                  int cout, int coutp, int co, int vec_in,
                                  int bf16, void* stream) {
  if (bad_shape(B, Z, Y, X, cin, cout, coutp, co) || cout > cin ||
      coutp > cin || !vec_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cin) {
    case 8:
      return dispatch_brick<8>(x, w, out, B, Z, Y, X, cout, coutp, bf16, s);
    case 16:
      return dispatch_brick<16>(x, w, out, B, Z, Y, X, cout, coutp, bf16,
                                s);
    case 32:
      return dispatch_brick<32>(x, w, out, B, Z, Y, X, cout, coutp, bf16,
                                s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9's entry point: any cout, cin up to 64 (a staged brick of 64 f32
// channels takes 209 of a block's 227 KB of shared memory).
extern "C" int sgnn_conv3d(const void* x, const float* w, void* out, int B,
                           int Z, int Y, int X, int cin, int cout, int coutp,
                           int co, int vec_in, int bf16, void* stream) {
  if (bad_shape(B, Z, Y, X, cin, cout, coutp, co) || cin > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wb = word_bytes(x, cin * (bf16 ? 2 : 4), vec_in);
  return bf16 ? dispatch_any<__nv_bfloat16>(x, w, out, B, Z, Y, X, cin,
                                            cout, coutp, wb, s)
              : dispatch_any<float>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                    wb, s);
}
