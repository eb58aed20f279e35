// K8 and K9, the zero-padded 3^3 convolution over a channels-last grid.
//
// Replaces: sgnn_tpu/ops/pallas/conv3d_folded.py _conv_impl (:178, the
// pallas_call at :191) behind conv3d_3x3x3_folded (:268, custom VJP
// :279-300), K8, which models/dense_flow.py:_conv_one routes every
// eligible 3^3 conv of the dense-flow execution through under
// cfg.use_pallas_conv (C in {8, 16, 32}, Cout <= C); and
// sgnn_tpu/ops/pallas/conv3d.py conv3d_3x3x3_pallas (:77, the
// pallas_call at :103), K9, the experimental form for any Cin and
// Cout, which no entry point of the JAX package reaches. Both compute
//
//   out[b, z, y, x] = round(sum_taps sum_ci
//                     in[b, z + dz - 1, y + dy - 1, x + dx - 1][ci]
//                     * W[tap][ci][:])                    f32 sums
//
// x [B, Z, Y, X, cin] and out [B, Z, Y, X, cout] in the compute type;
// neighbours outside the volume are zero; W arrives as f32 [27, cin,
// coutp] rounded to the compute type, taps in C order over (dz, dy, dx)
// (common.cuh, row kernels). Each entry point has a kernel of its own.
//
// K8, conv3d_brick_kernel. What bounds it on Hopper: the bytes, if the
// products run on the tensor cores. At the dense-flow execution's full
// resolution (96x192x192, C = 8, bf16) the call reads and writes 57 MB
// each (~0.034 ms); the MACs of the masked grid's non-zero voxels take a
// small fraction of that at the bf16 tensor-core rate, but a brick that
// holds one non-zero voxel computes all of its 256 outputs.
// Design (K7's, conv_raw.cu, on this layout): persistent blocks of 256
// threads walk output bricks of 2 x 4 x 32 voxels, x fastest. Each brick's
// halo'd input (4 x 6 x 34 voxels, zero outside [0, Z) x [0, Y) x [0, X):
// there is no halo ring, and X need not be a multiple of 32) is staged in
// shared memory by cp.async, two buffers deep (the next brick's copies fly
// while this one computes), XOR-swizzled (common.cuh, chunk_off). A brick
// whose staged input is all zero (-0 counts as zero) writes zeros and
// skips the products; the input gradient's dense cotangent skips nothing.
// - bf16: mma.sync m16n8k16, bf16 x bf16 -> f32. Warp w takes brick row w
//   as two M tiles of 16 consecutive x; K runs over (tap, ci), two taps a
//   k16 step at C = 8 (a 28th tap of zero weights pads the last), one at
//   16, two k16 steps a tap at 32; N is C in 8-wide tiles, zero weight
//   columns past Cout. A rows come from the staged slots by ldmatrix; B
//   fragments are built once per block from the f32 weights, which hold
//   bf16 values (prep_weight rounds them), so the conversion is exact.
//   The sums are f32 in the tensor cores' order, rounded once per output.
// - f32: f32 FMAs on the CUDA cores in (tap, ci) order (no TF32), the
//   order of the one-thread-per-voxel kernel this design replaced, so its
//   outputs are that kernel's bit for bit (a zero input's product adds
//   exactly nothing: the sums start at +0 and never become -0). A thread
//   takes half of the coutp output channels of two voxels (v and v + 128),
//   so each uniform weight load serves two voxels.
// Outputs go through shared memory (the brick's own buffer, free once its
// products are done) as a [256][cout] tile, and each warp writes its brick
// row's contiguous run of outputs as 16-byte vectors where the run is
// aligned, else element by element (Cout 1 and 12 occur in the dense
// flow). Blocks an SM (shared memory, launch bounds): C = 8 4 (bf16 ~30
// KB, f32 ~52 KB; 2 ran slower on a masked grid), C = 16 2 (bf16 ~66 KB,
// f32 ~104 KB; 3 ran slower on a dense input), C = 32 1 (bf16 ~160 KB, the
// B fragments alone 55 KB; f32 ~204 KB).
//
// K9, conv3d_any_kernel, keeps the first port's design, as it runs on no
// path: one thread per output voxel and chunk of CO outputs, each
// neighbour row read from global memory (16-byte vectors where aligned)
// and each zero value skipping its row of FMAs, weights as uniform float4
// loads (common.cuh, accumulate_row). Its redesign is still to do.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace sgnn {
namespace {

// ------------------------------------------------------------------- K8

// Shared memory of a K8 block, byte offsets.
template <typename T, int C>
struct BrickSmem {
  static constexpr int NC = C * static_cast<int>(sizeof(T)) / 16;
  static constexpr int BUF = NH * NC * 16;      // one staged brick
  static constexpr bool TC = sizeof(T) == 2;    // bf16: the tensor cores
  static constexpr int KSTEPS = (27 * C + 15) / 16;  // k16 steps
  static constexpr int NT = C / 8;              // 8-wide N tiles
  static constexpr int IN = 0;                  // brick i in buffer i % 2
  static constexpr int WF = IN + 2 * BUF;       // uint2 [KSTEPS][NT][32]
  static constexpr int BYTES = WF + (TC ? KSTEPS * NT * 32 * 8 : 0);
  static constexpr int MIN_BLOCKS = C == 8 ? 4 : C == 16 ? 2 : 1;
  static_assert(BYTES <= 227 * 1024, "a block's shared memory");
};

// Starts the copies of brick k's halo'd input (rows z0 - 1 .. z0 + 2,
// y0 - 1 .. y0 + 4, x0 - 1 .. x0 + 32) into buf, zero outside the volume,
// as one copy group.
template <typename T, int C>
__device__ __forceinline__ void stage_brick(unsigned buf,
                                            const T* __restrict__ x,
                                            const Brick& k, int Z, int Y,
                                            int X) {
  constexpr int NC = BrickSmem<T, C>::NC;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int q = threadIdx.x; q < NH * NC; q += THREADS) {
    const int i = q / NC, c = q % NC;
    const int z = k.z0 - 1 + i / (HY * HX), y = k.y0 - 1 + i / HX % HY,
              xx = k.x0 - 1 + i % HX;
    const bool in =
        z >= 0 && z < Z && y >= 0 && y < Y && xx >= 0 && xx < X;
    const T* p =
        in ? x + voxel_index(k.b, z, y, xx, Z, Y, X) * C + c * E : x;
    cp_async16(buf + chunk_off<NC>(i, c), p, in ? 16 : 0);
  }
  cp_async_commit();
}

// The B fragments of every k16 step and N tile: bf16 from the f32 weights
// [27, C, coutp]; row k of step j is flattened (tap, ci) index 16 j + k,
// zero past the 27th tap and past coutp.
template <int C>
__device__ __forceinline__ void stage_weights(uint2* wf,
                                              const float* __restrict__ w,
                                              int coutp) {
  using S = BrickSmem<__nv_bfloat16, C>;
  for (int q = threadIdx.x; q < S::KSTEPS * S::NT * 32; q += THREADS) {
    const int lane = q % 32, nt = q / 32 % S::NT, j = q / (32 * S::NT);
    const int n = nt * 8 + lane / 4;
    unsigned v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * j + 8 * h + 2 * (lane % 4) + e;
        const int tap = k / C, ci = k % C;
        const float f = tap < 27 && n < coutp
                            ? __ldg(w + (tap * C + ci) * coutp + n)
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
template <int C>
__device__ __forceinline__ void mma_row(
    const unsigned char* buf, const uint2* wf,
    float (*acc)[BrickSmem<__nv_bfloat16, C>::NT][4]) {
  using S = BrickSmem<__nv_bfloat16, C>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // the A row this lane addresses for ldmatrix, and its 8-wide k half
  const int r = (lane & 7) + (lane >> 3 & 1) * 8, h = lane >> 4;
  const unsigned base = smem_addr(buf);
  int cs[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    cs[mt] = center_slot(warp * BX + mt * 16 + r);
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
#pragma unroll  // the taps' offsets become constants
  for (int j = 0; j < S::KSTEPS; ++j) {
    // this lane's k half: flattened (tap, ci) 16 j + 8 h .., one chunk
    const int k = 16 * j + 8 * h;
    const int tap = k / C, c = k % C / 8;
    const int off = tap < 27 ? tap_offset(tap) : 0;
    unsigned b[S::NT][2];
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) {
      const uint2 u = wf[(j * S::NT + nt) * 32 + lane];
      b[nt][0] = u.x;
      b[nt][1] = u.y;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned a[4];
      ldmatrix_x4(a, base + chunk_off<S::NC>(cs[mt] + off, c));
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
    }
  }
}

// acc[0..CW) += v * w[0..CW): float4 loads, float2 at CW = 2 (coutp 4)
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

// f32: output channels CW h .. CW h + CW - 1 (CW = coutp / 2) of voxels v0
// and v0 + NV / 2 over the staged brick, in (tap, ci) order
template <int C, int CW>
__device__ __forceinline__ void fma_pair(const unsigned char* buf, int v0,
                                         int h, const float* __restrict__ w,
                                         float (*acc)[CW]) {
  constexpr int NC = BrickSmem<float, C>::NC, COUTP = 2 * CW;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[j][c] = 0.f;
  const int s0 = center_slot(v0), s1 = center_slot(v0 + NV / 2);
  for (int tap = 0; tap < 27; ++tap) {
    const int off = tap_offset(tap);
    const float* wt = w + tap * C * COUTP + CW * h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 u0 = *reinterpret_cast<const float4*>(
          buf + chunk_off<NC>(s0 + off, c));
      const float4 u1 = *reinterpret_cast<const float4*>(
          buf + chunk_off<NC>(s1 + off, c));
      const float a0[4] = {u0.x, u0.y, u0.z, u0.w};
      const float a1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        axpy_cw<CW>(acc[0], a0[e], wt + (4 * c + e) * COUTP);
        axpy_cw<CW>(acc[1], a1[e], wt + (4 * c + e) * COUTP);
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

// CW: f32 output channels a thread (coutp / 2); 0 in bf16
template <typename T, int C, int CW>
__global__ void __launch_bounds__(THREADS, BrickSmem<T, C>::MIN_BLOCKS)
    conv3d_brick_kernel(const T* __restrict__ x,
                        const float* __restrict__ w,  // [27, C, coutp]
                        T* __restrict__ out, int Z, int Y, int X, int cout,
                        int coutp, int nbx, int nby, int nbz, int nbricks) {
  using S = BrickSmem<T, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  if constexpr (S::TC) {  // visible after the first brick's barrier
    stage_weights<C>(reinterpret_cast<uint2*>(smem + S::WF), w, coutp);
  }
  int brick = blockIdx.x;
  if (brick < nbricks) {
    stage_brick<T, C>(smem_addr(smem + S::IN),
                      x, brick_at(brick, nbx, nby, nbz), Z, Y, X);
  }
  for (int it = 0; brick < nbricks; ++it, brick += gridDim.x) {
    unsigned char* buf = smem + S::IN + it % 2 * S::BUF;
    cp_async_wait<0>();
    const bool mine = own_chunks_nonzero<T, S::NC>(buf);
    // every thread is done with the previous brick and every copy of this
    // one is visible
    const bool any = __syncthreads_or(mine);
    const int next = brick + gridDim.x;
    if (next < nbricks) {
      stage_brick<T, C>(smem_addr(smem + S::IN + (it + 1) % 2 * S::BUF),
                        x, brick_at(next, nbx, nby, nbz), Z, Y, X);
    }
    const Brick k = brick_at(brick, nbx, nby, nbz);
    // warp w's brick row: n voxels from x0, a run of n * cout outputs
    const int z = k.z0 + warp / BY, y = k.y0 + warp % BY;
    const bool row = z < Z && y < Y;
    const int n = min(BX, X - k.x0);
    T* orow = out + voxel_index(k.b, row ? z : 0, row ? y : 0, k.x0, Z, Y,
                                X) * cout;
    if (!any) {
      if (row) write_run<T>(orow, nullptr, n * cout);
      continue;
    }
    T* tile = reinterpret_cast<T*>(buf);  // [NV][cout], once buf is read
    if constexpr (S::TC) {
      float acc[2][S::NT][4];
      mma_row<C>(buf, reinterpret_cast<const uint2*>(smem + S::WF), acc);
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
            if (c < cout) tile[v * cout + c] = from_f<T>(acc[mt][nt][e]);
          }
    } else {
      const int h = tid / (NV / 2), v0 = tid % (NV / 2);
      float acc[2][CW];
      fma_pair<C, CW>(buf, v0, h, w, acc);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          if (CW * h + c < cout)
            tile[(v0 + j * NV / 2) * cout + CW * h + c] = acc[j][c];
        }
    }
    __syncthreads();
    if (row) write_run<T>(orow, tile + warp * BX * cout, n * cout);
  }
}

template <typename T, int C, int CW>
int launch_brick(const void* x, const float* w, void* out, int B, int Z,
                 int Y, int X, int cout, int coutp, cudaStream_t stream) {
  using S = BrickSmem<T, C>;
  const auto kernel = conv3d_brick_kernel<T, C, CW>;
  // above 48 KB only once the kernel allows it; the attribute belongs to
  // the current device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nbx = (X + BX - 1) / BX, nby = (Y + BY - 1) / BY,
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
  kernel<<<grid, THREADS, S::BYTES, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), Z, Y, X, cout,
      coutp, nbx, nby, nbz, static_cast<int>(nbricks));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int dispatch_brick(const void* x, const float* w, void* out, int B, int Z,
                   int Y, int X, int cout, int coutp, int bf16,
                   cudaStream_t s) {
  if (bf16) {
    return launch_brick<__nv_bfloat16, C, 0>(x, w, out, B, Z, Y, X, cout,
                                             coutp, s);
  }
  switch (coutp) {
    case 4:
      return launch_brick<float, C, 2>(x, w, out, B, Z, Y, X, cout, coutp,
                                       s);
    case 8:
      return launch_brick<float, C, 4>(x, w, out, B, Z, Y, X, cout, coutp,
                                       s);
    case 16:
      if constexpr (C >= 16) {
        return launch_brick<float, C, 8>(x, w, out, B, Z, Y, X, cout,
                                         coutp, s);
      }
      break;
    case 32:
      if constexpr (C == 32) {
        return launch_brick<float, C, 16>(x, w, out, B, Z, Y, X, cout,
                                          coutp, s);
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------- K9

template <typename T, int CO>
__global__ void __launch_bounds__(THREADS)
    conv3d_any_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, int B, int Z, int Y, int X,
                      int cin, int cout, int coutp, bool vec_in,
                      bool vec_out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Z * Y * X) return;
  const Voxel v = decode(idx, Z, Y, X);
  const int c0 = blockIdx.y * CO;
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
  for (int dz = 0; dz < 3; ++dz) {
    const int zz = v.z + dz - 1;
    if (zz < 0 || zz >= Z) continue;
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = v.y + dy - 1;
      if (yy < 0 || yy >= Y) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = v.x + dx - 1;
        if (xx < 0 || xx >= X) continue;
        const int tap = (dz * 3 + dy) * 3 + dx;
        accumulate_row<T, CO>(
            acc, x + voxel_index(v.b, zz, yy, xx, Z, Y, X) * cin, cin,
            w + static_cast<long long>(tap) * cin * coutp + c0, coutp,
            vec_in);
      }
    }
  }
  store_row<T, CO>(out + idx * cout + c0, acc, min(CO, cout - c0), vec_out);
}

template <typename T, int CO>
int launch_any(const void* x, const float* w, void* out, int B, int Z,
               int Y, int X, int cin, int cout, int coutp, int vec_in,
               cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * Z * Y * X;
  const dim3 grid(blocks_for(n), coutp / CO);
  const bool vec_out =
      (cout * sizeof(T)) % 16 == 0 && coutp == cout &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  conv3d_any_kernel<T, CO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), B, Z, Y, X, cin,
      cout, coutp, vec_in != 0, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_any(const void* x, const float* w, void* out, int B, int Z,
                 int Y, int X, int cin, int cout, int coutp, int co,
                 int vec_in, cudaStream_t s) {
  switch (co) {
    case 4:
      return launch_any<T, 4>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                              vec_in, s);
    case 8:
      return launch_any<T, 8>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                              vec_in, s);
    case 16:
      return launch_any<T, 16>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                               vec_in, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int B, int Z, int Y, int X, int cin, int cout, int coutp,
               int co) {
  return B < 1 || Z < 1 || Y < 1 || X < 1 || cin < 1 || cout < 1 ||
         co < 1 || coutp % co || coutp < cout || coutp - cout >= co;
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

// K9's entry point (any cin, cout):
extern "C" int sgnn_conv3d(const void* x, const float* w, void* out, int B,
                           int Z, int Y, int X, int cin, int cout, int coutp,
                           int co, int vec_in, int bf16, void* stream) {
  if (bad_shape(B, Z, Y, X, cin, cout, coutp, co)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_any<__nv_bfloat16>(x, w, out, B, Z, Y, X, cin,
                                            cout, coutp, co, vec_in, s)
              : dispatch_any<float>(x, w, out, B, Z, Y, X, cin, cout, coutp,
                                    co, vec_in, s);
}
