// Shared helpers of the sgnn_tpu_torch kernels.
//
// Layout every kernel reads and writes (sgnn_tpu/ops/folded.py:12-34): an
// FGrid [B, Z+2, Y+2, xq, 128] with lane = slot * cpad + channel and
// slot = x % (128 / cpad), block = x / (128 / cpad). Because
// 128 = F * cpad, a row (b, z, y) is just Xs = xq * F voxel slots of cpad
// contiguous channels, so voxel (b, z, y, x) starts at element
// (((b * Zp + z) * Yp + y) * Xs + x) * cpad. The one-voxel z/y ring is
// zero, dead lanes (channel >= real width) and x-tail slots are zero.
//
// Weights and affines arrive prepared by the Python side (ops/folded.py):
// f32 arrays padded to MAXC channels whose values are already rounded to
// the compute type, so the kernels read one layout for cpad 8 and 16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgnn {

constexpr int LANES = 128;
constexpr int MAXC = 16;  // channel padding of the prepared weight arrays
constexpr int MAXG = 4;   // most input groups a site takes
constexpr int THREADS = 256;

// Input groups of one site, passed by value to the kernel.
struct Groups {
  const void* p[MAXG];
  int cin[MAXG];
  int n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Value after a round trip through the compute type.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// relu(v * s + b) * m with every operation rounded on its own (no FMA
// contraction), the order the plain PyTorch versions compute in.
__device__ __forceinline__ float affine_relu_mask(float v, float s, float b,
                                                  float m) {
  const float r = fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.f);
  return __fmul_rn(r, m);
}

// acc[0..C) += v * w[0..C); w is 16-byte aligned (rows of MAXC floats).
template <int C>
__device__ __forceinline__ void axpy(float* acc, float v,
                                     const float* __restrict__ w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 wv = __ldg(w4 + q);
    acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
  }
}

// v[0..C) = one voxel's C channels at p, read as 16-byte vectors (a voxel
// row of C values starts on a 16-byte boundary: C * sizeof(T) >= 16).
template <typename T, int C>
__device__ __forceinline__ void load_voxel(const T* __restrict__ p,
                                           float* v) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte vector
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < C / E; ++i) {
    const uint4 u = __ldg(q + i);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < E; ++e) v[i * E + e] = to_f(t[e]);
  }
}

// o[0..C) = v[0..C) rounded to T, written as 16-byte vectors (one voxel
// row; 16-byte aligned as in load_voxel).
template <typename T, int C>
__device__ __forceinline__ void store_voxel(T* __restrict__ o,
                                            const float* v) {
  constexpr int E = 16 / sizeof(T);
  uint4* q = reinterpret_cast<uint4*>(o);
#pragma unroll
  for (int i = 0; i < C / E; ++i) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < E; ++e) t[e] = from_f<T>(v[i * E + e]);
    q[i] = u;
  }
}

// o[0..C) = +0 (all bits clear in f32 and bf16), as 16-byte vectors.
template <typename T, int C>
__device__ __forceinline__ void store_zero(T* o) {
  static_assert((C * sizeof(T)) % 16 == 0, "a voxel row of 16-byte words");
  uint4* q = reinterpret_cast<uint4*>(o);
#pragma unroll
  for (int i = 0; i < C * static_cast<int>(sizeof(T)) / 16; ++i)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// --------------------------------------- output bricks (K1, K3, K7, K8, K9)
//
// K1, K1q (conv_site.cu), K3, K3q (upconv.cu), K7 (conv_raw.cu), K8 and K9
// (conv3d_cl.cu) give a block of THREADS threads one output brick of BZ x
// BY x BX voxels, x fastest, so warp w holds brick row w (one (z, y), 32
// consecutive x slots). K1, K7, K8 and K9 stage
// the brick's halo'd input, HZ x HY x HX voxels, in shared memory with
// cp.async; staged slot i is halo'd-brick voxel (i / (HY HX), i / HX % HY,
// i % HX).
constexpr int BZ = 2, BY = 4, BX = 32;
constexpr int NV = BZ * BY * BX;
constexpr int HZ = BZ + 2, HY = BY + 2, HX = BX + 2;
constexpr int NH = HZ * HY * HX;  // staged (halo'd) voxels
constexpr int WARPS = THREADS / 32;
static_assert(NV == THREADS && BX == 32, "one voxel a thread, a row a warp");

// offset between a voxel's staged slot and its tap t = (dz * 3 + dy) * 3
// + dx neighbour's
__host__ __device__ constexpr int tap_offset(int t) {
  return ((t / 9 - 1) * HY + (t / 3 % 3 - 1)) * HX + (t % 3 - 1);
}

// staged slot of output voxel v of the brick
__device__ __forceinline__ int center_slot(int v) {
  return ((v / (BY * BX) + 1) * HY + (v / BX % BY + 1)) * HX + v % BX + 1;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory at p to shared address s, or 16 zero bytes
// (n = 0), asynchronously
__device__ __forceinline__ void cp_async16(unsigned s, const void* p, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(p), "r"(n));
}

// 4 bytes, likewise (n = 4 or 0)
__device__ __forceinline__ void cp_async4(unsigned s, const void* p, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(p), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------ tensor-core fragments (sm_80+)
//
// mma.sync tiles, in PTX's fragment layouts: lane = 4 * gid + tig; an A
// fragment holds rows gid and gid + 8, B column gid, C rows gid and gid + 8
// at columns 2 tig and 2 tig + 1.

// r[0..4) = four 8x8 b16 matrices from shared memory; lanes 8 i .. 8 i + 7
// give the 16-byte row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d[0..4) += A (16 x 16 bf16, a[0..4)) * B (16 x 8 bf16, b[0..2)), f32
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[0..4) += A (16 x 32 s8, a[0..4)) * B (32 x 8 s8, b[0..2)), exact s32
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row kernels (K10 gather_gemm.cu; K8 and K9 read the same weights in
// their bricks) keep weights of their own layout: f32 [taps, cin, coutp]
// with coutp a multiple of the output chunk CO (4, 8 or 16) and >= cout,
// values rounded to the compute type, zero columns past cout.

// ------------------------------------------------------- int8 modes
//
// The int8 sites (K1q-K3q, sgnn_tpu/ops/pallas/conv3d_folded.py with
// quantize=True) quantize each input value with the scale of the TPU
// tile that holds the output voxel, s = max(amax, 1e-8) / 127
// from the tile_amax pre-pass (quant.cu), and sum int8 x int8 products
// in int32 (exact: at most 27 taps x 16 channels x 127^2 < 2^24, so the
// f32 conversion is exact too). Weights arrive as int8 [..., co, ci]:
// one output channel's 16 input-channel weights are one 16-byte word.

__device__ __forceinline__ float tile_scale(float amax) {
  return fmaxf(amax, 1e-8f) / 127.0f;  // IEEE division (no fast math)
}

// clip(round(tf * inv), -127, 127), rounding half to even (rintf).
__device__ __forceinline__ int quantize_s8(float tf, float inv) {
  const float q = rintf(__fmul_rn(tf, inv));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// words[0..CI/4) = one voxel's CI channel values v as the site's f32
// input (relu(v * s + b) * mi with the affine sc, else v), quantized with
// inv and packed four to a word (channel ci in byte ci % 4 of word ci / 4;
// channels >= cin are 0). Returns false when every value is 0.
template <int CI>
__device__ __forceinline__ bool quantize_values(const float* v, int cin,
                                                const float* sc, float mi,
                                                float inv, int* words) {
  unsigned any = 0;
#pragma unroll
  for (int w = 0; w < CI / 4; ++w) {
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = 4 * w + e;
      int q = 0;
      if (ci < cin) {
        const float tf = sc != nullptr
                             ? affine_relu_mask(v[ci], sc[ci],
                                                sc[MAXC + ci], mi)
                             : v[ci];
        q = quantize_s8(tf, inv);
      }
      word |= (static_cast<unsigned>(q) & 0xffu) << (8 * e);
    }
    words[w] = static_cast<int>(word);
    any |= word;
  }
  return any != 0;
}

// iacc[co] += sum_ci q[ci] * w[co][ci] for co < CO, over the CI/4 packed
// words; w: CO 16-byte words in shared memory (one address per warp, a
// broadcast).
template <int CI, int CO>
__device__ __forceinline__ void dp4a_voxel(int* iacc, const int* words,
                                           const int4* w) {
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    const int4 wv = w[co];
    int a = iacc[co];
    a = __dp4a(words[0], wv.x, a);
    a = __dp4a(words[1], wv.y, a);
    if constexpr (CI > 8) {
      a = __dp4a(words[2], wv.z, a);
      a = __dp4a(words[3], wv.w, a);
    }
    iacc[co] = a;
  }
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

// Decoded position of a flat voxel index over [B, Zp, Yp, Xs].
struct Voxel {
  int b, z, y, x;
};

__device__ __forceinline__ Voxel decode(long long idx, int Zp, int Yp,
                                        int Xs) {
  Voxel v;
  v.x = static_cast<int>(idx % Xs);
  long long r = idx / Xs;
  v.y = static_cast<int>(r % Yp);
  r /= Yp;
  v.z = static_cast<int>(r % Zp);
  v.b = static_cast<int>(r / Zp);
  return v;
}

__device__ __forceinline__ long long voxel_index(int b, int z, int y, int x,
                                                 int Zp, int Yp, int Xs) {
  return ((static_cast<long long>(b) * Zp + z) * Yp + y) * Xs + x;
}

// ---------------------------------------- staged windows (K1, K3, K1q, K3q)
//
// A window of WZ x WY x WX voxels of a grid [B, Zp, Yp, Xs, CPAD] staged in
// shared memory: slot i is window voxel (i / (WY WX), i / WX % WY, i % WX),
// CPAD * sizeof(T) bytes, 16-byte word v of it at i * SLOT + 16 v.

// Starts the copies of the window at (z0, y0, x0) of grid xg into buf,
// zero outside the grid, as one copy group. The grid's dead lanes are zero
// and meet zero weight rows, so slots are copied whole.
template <typename T, int CPAD, int WZ, int WY, int WX>
__device__ __forceinline__ void copy_window(unsigned buf,
                                            const T* __restrict__ xg, int b,
                                            int z0, int y0, int x0, int Zp,
                                            int Yp, int Xs) {
  constexpr int SLOT = CPAD * static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < WZ * WY * WX; i += THREADS) {
    const int z = z0 + i / (WY * WX), y = y0 + i / WX % WY,
              x = x0 + i % WX;
    const bool in =
        z >= 0 && z < Zp && y >= 0 && y < Yp && x >= 0 && x < Xs;
    const T* p = in ? xg + voxel_index(b, z, y, x, Zp, Yp, Xs) * CPAD : xg;
#pragma unroll
    for (int v = 0; v < SLOT / 16; ++v)
      cp_async16(buf + i * SLOT + v * 16, p + v * (16 / sizeof(T)),
                 in ? 16 : 0);
  }
  cp_async_commit();
}

// The affine in place on the N slots of a staged window: round(relu(x s +
// b) m_i) in the compute type for channels < cin, where the voxel's mask
// hm[i] is set, else 0 (relu(.) * 0), once per staged voxel.
template <typename T, int CPAD, int N>
__device__ __forceinline__ void affine_window(unsigned char* buf, int cin,
                                              const float* sa,
                                              const float* hm) {
  constexpr int SLOT = CPAD * static_cast<int>(sizeof(T));
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float mi = hm[i];
#pragma unroll
    for (int v = 0; v < SLOT / 16; ++v) {
      uint4* q = reinterpret_cast<uint4*>(buf + i * SLOT + v * 16);
      uint4 u = *q;
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = v * E + e;
        t[e] = from_f<T>(c < cin && mi != 0.f
                             ? affine_relu_mask(to_f(t[e]), sa[c],
                                                sa[MAXC + c], mi)
                             : 0.f);
      }
      *q = u;
    }
  }
}

// Quantizes the N slots of a staged window (int8 modes K1q, K3q) into q,
// int8 [N][CPAD]: each staged voxel's f32 input (with the affine sa,
// relu(x s + b) hm[i]; 0 where the voxel's mask is 0) with 1 / s = inv,
// channels >= cin 0; a zero-filled slot quantizes to 0.
template <typename T, int CPAD, int N>
__device__ __forceinline__ void quantize_window(const unsigned char* buf,
                                                unsigned char* q, int cin,
                                                const float* sa,
                                                const float* hm, float inv) {
  constexpr int SLOT = CPAD * static_cast<int>(sizeof(T));
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float mi = sa != nullptr ? hm[i] : 1.f;
    int words[CPAD / 4] = {};
    if (mi != 0.f) {
      float v[CPAD];
#pragma unroll
      for (int c = 0; c < SLOT / 16; ++c) {
        const uint4 u = *reinterpret_cast<const uint4*>(buf + i * SLOT +
                                                        c * 16);
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < E; ++e) v[c * E + e] = to_f(t[e]);
      }
      quantize_values<CPAD>(v, cin, sa, mi, inv, words);
    }
    if constexpr (CPAD == 16) {
      *reinterpret_cast<int4*>(q + i * CPAD) =
          make_int4(words[0], words[1], words[2], words[3]);
    } else {
      *reinterpret_cast<int2*>(q + i * CPAD) = make_int2(words[0], words[1]);
    }
  }
}

// --------------------------------------- persistent bricks (K7, K8, K9)
//
// Persistent blocks walk output bricks (BZ x BY x BX, x fastest) and stage
// each brick's halo'd input, NH slots of NC 16-byte chunks, by cp.async;
// thread t copies chunks t, t + THREADS, ... Chunk c of slot i lies at
// chunk_off: XOR-swizzled within the slot so that 8 consecutive slots'
// chunk c fall in distinct 16-byte bank groups (i NC mod 8 takes 8 values
// over them for an odd NC, 4 for NC = 2 mod 4, 2 for NC = 4 mod 8 and 1
// for a multiple of 8; the XOR supplies the missing bits of i mod 8 and
// keeps c below NC).

template <int NC>
__device__ __forceinline__ int chunk_off(int i, int c) {
  int sw = 0;
  if constexpr (NC % 8 == 0) {
    sw = i % 8;
  } else if constexpr (NC % 4 == 0) {
    sw = i / 2 % 4;
  } else if constexpr (NC % 2 == 0) {
    sw = i / 4 % 2;
  }
  return (i * NC + (c ^ sw)) * 16;
}

struct Brick {
  int b, z0, y0, x0;
};

__device__ __forceinline__ Brick brick_at(int i, int nbx, int nby, int nbz) {
  Brick k;
  k.x0 = i % nbx * BX;
  i /= nbx;
  k.y0 = i % nby * BY;
  i /= nby;
  k.z0 = i % nbz * BZ;
  k.b = i / nbz;
  return k;
}

// Whether any value of the chunks this thread copied into buf is non-zero
// (its own copies are visible to it once waited for). -0 counts as zero:
// a masked grid holds x * 0, which is -0 for a negative x.
template <typename T, int NC>
__device__ __forceinline__ bool own_chunks_nonzero(const unsigned char* buf) {
  constexpr unsigned MAG = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  unsigned any = 0;
  for (int q = threadIdx.x; q < NH * NC; q += THREADS) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        buf + chunk_off<NC>(q / NC, q % NC));
    any |= u.x | u.y | u.z | u.w;
  }
  return (any & MAG) != 0;
}

// ----------------------------------- implicit GEMM over 3^3 taps (K1, K7)
//
// bf16 products on the tensor cores (mma_bf16, f32 sums) of 16-row tiles
// of voxels with 27 taps w [27][MAXC][MAXC] (f32 holding bf16 values), over
// a staged window whose slots hold CPAD channels as 16-byte chunks at
// chunk_off: A rows are the slots of a row's tap neighbours, by ldmatrix;
// K runs over (tap, ci), one tap a k16 step at cpad 16 and two at cpad 8
// (a 28th tap of zero weights pads the last); N is CPAD, in 8-wide tiles.
template <int CPAD>
struct TapGemm {
  static constexpr int NC = CPAD * 2 / 16;  // 16-byte chunks a slot
  static constexpr int TPK = 16 / CPAD;     // taps a k16 step
  static constexpr int KSTEPS = (27 + TPK - 1) / TPK;
  static constexpr int NT = CPAD / 8;       // 8-wide N tiles
  static constexpr int FRAGS = KSTEPS * NT * 32;  // B fragments (uint2)
};

// wf[0, FRAGS) = the B fragments of taps w in bf16 (input channels >= cin
// and the padding tap zero): for k16 step j and N tile nt, lane l's uint2
// at (j NT + nt) 32 + l holds rows 2 (l % 4) .. and 8 + 2 (l % 4) .. of
// column 8 nt + l / 4. The block's threads share the work.
template <int CPAD>
__device__ __forceinline__ void tap_fragments(uint2* wf,
                                              const float* __restrict__ w,
                                              int cin) {
  using G = TapGemm<CPAD>;
  for (int q = threadIdx.x; q < G::FRAGS; q += THREADS) {
    const int lane = q % 32, nt = q / 32 % G::NT, j = q / (32 * G::NT);
    const int n = nt * 8 + lane / 4;
    unsigned v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * h + 2 * (lane % 4) + e;  // row of the k16 step
        const int tap = G::TPK * j + k / CPAD, ci = k % CPAD;
        const float f =
            tap < 27 && ci < cin ? __ldg(w + (tap * MAXC + ci) * MAXC + n)
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

// acc[t] += the products of M tile t with the B fragments wf over the
// window at shared address base, for each of the MT tiles with act[t];
// this lane addresses the centre slot cs[t] of its ldmatrix row (row
// (lane & 7) + 8 (lane >> 3 & 1), k half lane >> 4).
template <int CPAD, int MT>
__device__ __forceinline__ void tap_mma(unsigned base, const uint2* wf,
                                        const int* cs, const bool* act,
                                        float (*acc)[TapGemm<CPAD>::NT][4]) {
  using G = TapGemm<CPAD>;
  const int lane = threadIdx.x % 32, h = lane >> 4;
#pragma unroll  // the taps' offsets become constants
  for (int j = 0; j < G::KSTEPS; ++j) {
    // cpad 16: tap j, channels 8 h ..; cpad 8: tap 2 j + h, all 8
    const int tap = G::TPK * j + (CPAD == 8 ? h : 0);
    const int c = CPAD == 16 ? h : 0;
    const int off = tap < 27 ? tap_offset(tap) : 0;
    unsigned b[G::NT][2];
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const uint2 u = wf[(j * G::NT + nt) * 32 + lane];
      b[nt][0] = u.x;
      b[nt][1] = u.y;
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (!act[t]) continue;
      unsigned a[4];
      ldmatrix_x4(a, base + chunk_off<G::NC>(cs[t] + off, c));
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) mma_bf16(acc[t][nt], a, b[nt]);
    }
  }
}

}  // namespace sgnn
