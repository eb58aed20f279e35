// K7, the plain folded 3^3 convolution of the training path.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py conv_folded_raw (:213),
// body _kernel (:71), weights _fold_weights (:150); called by
// ops/folded.py _conv_train_impl (:1148) for conv_folded_train's forward
// and by _conv_dx (:1181) with flipped, in/out-transposed taps for the
// input gradient of every conv site's backward.
//
//   out[b, z, y, x] = round(sum_taps sum_ci
//                     in[b, z + dz, y + dy, x + dx - 1][ci] * W[tap][ci][:])
//
// The input is a halo'd FGrid [B, Z+2, Y+2, xq, 128] read as Xs = xq * F
// voxel slots of cpad channels (the x neighbours of a slot are slots +-1,
// across the 128-lane blocks: the TPU kernel's "carry" terms; slots
// outside [0, Xs) are zero). The output is UNPADDED [B, Z, Y, xq, 128] in
// the input's type, summed in f32: every slot is written and nothing is
// masked (the input gradient needs every voxel, and an x-tail slot past
// the real X is non-zero where its neighbour is), dead lanes are zero
// (zero weight columns). Unlike K1 there is no affine, no mask and no
// halo ring.
//
// What bounds it on Hopper: the bytes, if the products run on the tensor
// cores. At the training shapes (B = 8, 128x64x64, cpad 16, bf16) the call
// reads a 141 MB grid and writes a 134 MB one (~0.08 ms); its 27 * 16 * 16
// MACs per voxel are ~58 GFLOP, ~0.06 ms at the bf16 tensor-core rate but
// ~0.9 ms as f32 FMAs on the CUDA cores.
//
// Design: persistent blocks of 256 threads walk the output bricks of 2 x 4
// x 32 voxels (common.cuh), x fastest. Each brick's halo'd input (4 x 6 x
// 34 voxels, zero outside the grid and outside [0, Xs)) is staged in
// shared memory by cp.async, two buffers deep: the next brick's copies fly
// while this one computes. Each 16-byte chunk of a staged slot is XOR-
// swizzled so that 8 consecutive slots' chunk c fall in distinct banks. A
// brick whose staged input is all zero (training grids are masked) writes
// zeros and skips the products.
// - bf16: mma.sync m16n8k16, bf16 x bf16 -> f32. Warp w takes brick row w
//   as two M tiles of 16 consecutive x; N is cpad (two or one 8-wide
//   tiles); K runs over (tap, ci): at cpad 16 one tap per k16 step, at
//   cpad 8 two (a 28th tap of zero weights pads the last step). A rows
//   come from the staged slots by ldmatrix; B fragments are built once per
//   block from the f32 weights, which hold bf16 values (every caller
//   rounds them: ops/folded.py _prep_taps), so the conversion is exact.
//   The sums are f32 in the tensor cores' order, rounded to bf16 once per
//   output, staged in shared memory and written as 16-byte vectors.
// - f32: f32 FMAs on the CUDA cores in (tap, ci) order (no TF32), the
//   order of the one-thread-per-slot kernel this design replaced. A thread
//   takes half of the output channels of two voxels (v and v + 128), so
//   each uniform float4 weight load serves two voxels; neighbour values are
//   read from the staged slots as float4; outputs go out as 16-byte
//   vectors.
#include <algorithm>

#include "common.cuh"

namespace sgnn {
namespace {

template <typename T, int CPAD>
struct RawSmem {
  static constexpr int NC = CPAD * static_cast<int>(sizeof(T)) / 16;
  static constexpr int BUF = NH * NC * 16;  // one staged brick
  static constexpr bool TC = sizeof(T) == 2;  // bf16: the tensor cores
  static constexpr int IN = 0;                // brick i in buffer i % 2
  static constexpr int WF = IN + 2 * BUF;     // uint2 [FRAGS]
  static constexpr int OUT = WF + (TC ? TapGemm<CPAD>::FRAGS * 8 : 0);
  static constexpr int BYTES = OUT + (TC ? NV * CPAD * 2 : 0);  // bf16 out
};

// Issues the copies of brick k's halo'd input (padded rows z0 .. z0 + 3,
// y0 .. y0 + 5, slots x0 - 1 .. x0 + 32) into buf, zero outside the grid,
// as one copy group.
template <typename T, int CPAD>
__device__ __forceinline__ void stage_brick(unsigned buf,
                                            const T* __restrict__ x,
                                            const Brick& k, int Zp, int Yp,
                                            int Xs) {
  constexpr int NC = RawSmem<T, CPAD>::NC;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int q = threadIdx.x; q < NH * NC; q += THREADS) {
    const int i = q / NC, c = q % NC;
    const int z = k.z0 + i / (HY * HX), y = k.y0 + i / HX % HY,
              xx = k.x0 - 1 + i % HX;
    const bool in = z < Zp && y < Yp && xx >= 0 && xx < Xs;
    const T* p =
        in ? x + voxel_index(k.b, z, y, xx, Zp, Yp, Xs) * CPAD + c * E : x;
    cp_async16(buf + chunk_off<NC>(i, c), p, in ? 16 : 0);
  }
  cp_async_commit();
}

// bf16: warp w's brick row through the tensor cores into the out tile
// (bf16 [NV][CPAD] in shared memory).
template <int CPAD>
__device__ __forceinline__ void mma_row(const unsigned char* buf,
                                        const uint2* wf,
                                        __nv_bfloat16* otile) {
  constexpr int NT = TapGemm<CPAD>::NT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // the A row this lane addresses for ldmatrix
  const int r = (lane & 7) + (lane >> 3 & 1) * 8;
  int cs[2];
  const bool act[2] = {true, true};
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    cs[mt] = center_slot(warp * BX + mt * 16 + r);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
  tap_mma<CPAD, 2>(smem_addr(buf), wf, cs, act, acc);
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int v = warp * BX + mt * 16 + gid + 8 * hi;
        *reinterpret_cast<__nv_bfloat162*>(
            otile + v * CPAD + nt * 8 + 2 * tig) =
            __floats2bfloat162_rn(acc[mt][nt][2 * hi], acc[mt][nt][2 * hi + 1]);
      }
    }
  }
}

// f32: the sums of output channels 8 h .. (cpad 16) or 4 h .. (cpad 8) of
// voxels v0 and v0 + NV / 2 over the staged brick, in (tap, ci) order: a
// weight row read (uniform float4 loads) serves two voxels
template <int CPAD>
__device__ __forceinline__ void fma_pair(const unsigned char* buf, int v0,
                                         int h, const float* __restrict__ w,
                                         int cin, float (*acc)[CPAD / 2]) {
  constexpr int NC = RawSmem<float, CPAD>::NC, CW = CPAD / 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[j][c] = 0.f;
  const int s0 = center_slot(v0), s1 = center_slot(v0 + NV / 2);
  for (int tap = 0; tap < 27; ++tap) {
    const int off = tap_offset(tap);
    const float* wt = w + tap * MAXC * MAXC + CW * h;
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
        if (4 * c + e < cin) {
          axpy<CW>(acc[0], a0[e], wt + (4 * c + e) * MAXC);
          axpy<CW>(acc[1], a1[e], wt + (4 * c + e) * MAXC);
        }
      }
    }
  }
}

// 2 blocks an SM (shared memory at cpad 16: ~73 KB bf16, ~102 KB f32);
// capping the bf16 mode at 80 registers for a third spilled and ran slower
template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS, 2)
    conv_raw_kernel(const T* __restrict__ x,
                    const float* __restrict__ w,  // [27, MAXC, MAXC]
                    int cin, T* __restrict__ out, int Z, int Y, int Xs,
                    int nbx, int nby, int nbz, int nbricks) {
  using S = RawSmem<T, CPAD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int Zp = Z + 2, Yp = Y + 2;
  if constexpr (S::TC) {  // visible after the first brick's barrier
    tap_fragments<CPAD>(reinterpret_cast<uint2*>(smem + S::WF), w, cin);
  }
  int brick = blockIdx.x;
  if (brick < nbricks) {
    stage_brick<T, CPAD>(smem_addr(smem + S::IN),
                         x, brick_at(brick, nbx, nby, nbz), Zp, Yp, Xs);
  }
  for (int it = 0; brick < nbricks; ++it, brick += gridDim.x) {
    const unsigned char* buf = smem + S::IN + it % 2 * S::BUF;
    cp_async_wait<0>();
    const bool mine = own_chunks_nonzero<T, S::NC>(buf);
    // every thread is done with the previous brick and every copy of this
    // one is visible
    const bool any = __syncthreads_or(mine);
    const int next = brick + gridDim.x;
    if (next < nbricks) {
      stage_brick<T, CPAD>(smem_addr(smem + S::IN + (it + 1) % 2 * S::BUF),
                           x, brick_at(next, nbx, nby, nbz), Zp, Yp, Xs);
    }
    const Brick k = brick_at(brick, nbx, nby, nbz);
    const int z = k.z0 + tid / (BY * BX), y = k.y0 + tid / BX % BY,
              xx = k.x0 + tid % BX;
    const bool inside = z < Z && y < Y && xx < Xs;
    T* o = out + voxel_index(k.b, z, y, xx, Z, Y, Xs) * CPAD;
    if (!any) {
      if (inside) store_zero<T, CPAD>(o);
      continue;
    }
    if constexpr (S::TC) {
      __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(smem + S::OUT);
      mma_row<CPAD>(buf, reinterpret_cast<const uint2*>(smem + S::WF),
                    otile);
      __syncthreads();
      if (inside) {
        const uint4* src = reinterpret_cast<const uint4*>(otile + tid * CPAD);
#pragma unroll
        for (int c = 0; c < CPAD * 2 / 16; ++c)
          reinterpret_cast<uint4*>(o)[c] = src[c];
      }
    } else {
      constexpr int CW = CPAD / 2;
      const int h = tid / (NV / 2), v0 = tid % (NV / 2);
      float acc[2][CW];
      fma_pair<CPAD>(buf, v0, h, w, cin, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int v = v0 + j * NV / 2;
        const int zv = k.z0 + v / (BY * BX), yv = k.y0 + v / BX % BY,
                  xv = k.x0 + v % BX;
        if (zv < Z && yv < Y && xv < Xs) {
          store_voxel<float, CW>(
              reinterpret_cast<float*>(out) +
                  voxel_index(k.b, zv, yv, xv, Z, Y, Xs) * CPAD + CW * h,
              acc[j]);
        }
      }
    }
  }
}

template <typename T, int CPAD>
int launch_conv_raw(const void* x, const float* w, int cin, void* out, int B,
                    int Z, int Y, int xq, cudaStream_t stream) {
  using S = RawSmem<T, CPAD>;
  static_assert(S::BYTES <= 227 * 1024, "a block's shared memory");
  const auto kernel = conv_raw_kernel<T, CPAD>;
  // above 48 KB only once the kernel allows it (f32 at cpad 16); the
  // attribute belongs to the current device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int Xs = xq * (LANES / CPAD);
  const int nbx = (Xs + BX - 1) / BX, nby = (Y + BY - 1) / BY,
            nbz = (Z + BZ - 1) / BZ;
  const long long nbricks = static_cast<long long>(B) * nbz * nby * nbx;
  if (nbricks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // persistent: as many blocks as the card holds at once, at most a brick
  // each
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, S::BYTES)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>(
      std::min(nbricks, static_cast<long long>(sms) * std::max(per_sm, 1)));
  if (grid == 0) return 0;
  kernel<<<grid, THREADS, S::BYTES, stream>>>(
      static_cast<const T*>(x), w, cin, static_cast<T*>(out), Z, Y, Xs, nbx,
      nby, nbz, static_cast<int>(nbricks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sgnn

using namespace sgnn;

// x: halo'd [B, Z+2, Y+2, xq, 128]; out: [B, Z, Y, xq, 128], same type.
// w: f32 [27, 16, 16] taps holding values of the grid's type (bf16 grids:
// bf16 values; the tensor cores take them as bf16). cin: input channels
// read (weight rows >= cin are zero). bf16: 1 for bfloat16 grids, 0 for
// float32.
extern "C" int sgnn_conv_raw(const void* x, const float* w, int cin,
                             void* out, int B, int Z, int Y, int xq,
                             int cpad, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cin > cpad) return static_cast<int>(cudaErrorInvalidValue);
  if (cpad == 8) {
    return bf16 ? launch_conv_raw<__nv_bfloat16, 8>(x, w, cin, out, B, Z, Y,
                                                    xq, s)
                : launch_conv_raw<float, 8>(x, w, cin, out, B, Z, Y, xq, s);
  }
  if (cpad == 16) {
    return bf16 ? launch_conv_raw<__nv_bfloat16, 16>(x, w, cin, out, B, Z, Y,
                                                     xq, s)
                : launch_conv_raw<float, 16>(x, w, cin, out, B, Z, Y, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
