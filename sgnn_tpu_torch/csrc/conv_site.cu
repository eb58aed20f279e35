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
// K1q, the int8 mode (quantize=True, _kernel_fused :413-451), keeps one
// thread per output voxel over the whole grid: the thread reads its TPU
// tile's amax per group (tile (iz, iy) holds interior rows [iz tz, (iz + 1)
// tz) x [iy ty, (iy + 1) ty)), turns it into s and 1 / s, quantizes each
// neighbour's f32 input (the affine's value before any rounding to the
// compute type) on the fly, sums int8 products in int32 with __dp4a against
// int8 weights [G, 27, co, ci], and dequantizes per group, acc += f32(iacc)
// * (s * ws[g, co]), before the mask. Bound: the same bytes as K1, and
// 27 * cin * cout int8 MACs per active voxel (int8 tensor-core rate).
#include "common.cuh"

namespace sgnn {

// the exact modes' output brick; one voxel per thread
constexpr int BZ = 2, BY = 4, BX = 32;
constexpr int NV = BZ * BY * BX;
constexpr int HZ = BZ + 2, HY = BY + 2, HX = BX + 2;
constexpr int NH = HZ * HY * HX;  // staged (halo'd) voxels
constexpr int WARPS = THREADS / 32;
static_assert(NV == THREADS, "one output voxel per thread");

// offset between a voxel's staged slot and its tap t = (dz * 3 + dy) * 3
// + dx neighbour's
__host__ __device__ constexpr int tap_offset(int t) {
  return ((t / 9 - 1) * HY + (t / 3 % 3 - 1)) * HX + (t % 3 - 1);
}

// staged slot of output voxel v of the brick
__device__ __forceinline__ int center_slot(int v) {
  return ((v / (BY * BX) + 1) * HY + (v / BX % BY + 1)) * HX + v % BX + 1;
}

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory at p to shared address s, or 16 zero bytes
// (n = 0), asynchronously
__device__ __forceinline__ void cp_async16(unsigned s, const void* p, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(p), "r"(n));
}

// waits until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of one group's halo'd input brick (origin z0 - 1,
// y0 - 1, x0 - 1) into the staged slots of buf, zero outside the grid,
// and commits them as one copy group. The grid's dead lanes are zero and
// meet zero weight rows, so slots are copied whole.
template <typename T, int CPAD>
__device__ __forceinline__ void issue_group(unsigned buf,
                                            const T* __restrict__ xg, int b,
                                            int z0, int y0, int x0, int Zp,
                                            int Yp, int Xs) {
  using S = SiteSmem<T, CPAD>;
  for (int i = threadIdx.x; i < NH; i += THREADS) {
    const int z = z0 - 1 + i / (HY * HX), y = y0 - 1 + i / HX % HY,
              x = x0 - 1 + i % HX;
    const bool in =
        z >= 0 && z < Zp && y >= 0 && y < Yp && x >= 0 && x < Xs;
    const T* p = in ? xg + voxel_index(b, z, y, x, Zp, Yp, Xs) * CPAD : xg;
#pragma unroll
    for (int v = 0; v < S::SLOT / 16; ++v)
      cp_async16(buf + S::word(i, v), p + v * (16 / sizeof(T)), in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The affine in place on a staged group: round(relu(x s + b) m_i) in the
// compute type for channels < cin, where the neighbour's mask hm is set,
// else 0 (relu(.) * 0), once per staged voxel.
template <typename T, int CPAD>
__device__ __forceinline__ void affine_group(unsigned char* buf, int cin,
                                             const float* sa,
                                             const float* hm) {
  using S = SiteSmem<T, CPAD>;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < NH; i += THREADS) {
    const float mi = hm[i];
#pragma unroll
    for (int v = 0; v < S::SLOT / 16; ++v) {
      uint4* q = reinterpret_cast<uint4*>(buf + S::word(i, v));
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
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z / nbz;
  const int z0 = blockIdx.z % nbz * BZ, y0 = blockIdx.y * BY,
            x0 = blockIdx.x * BX;
  const int z = z0 + tid / (BY * BX), y = y0 + tid / BX % BY,
            x = x0 + tid % BX;
  const bool inside = z < Zp && y < Yp && x < Xs;
  const bool ring = z == 0 || z == Zp - 1 || y == 0 || y == Yp - 1;
  const long long idx = voxel_index(b, z, y, x, Zp, Yp, Xs);
  T* o = out + idx * CPAD;
  // A masked voxel's output is the residual (inside the ring) or zero
  // whatever its brick does: it is written at once, its residual load
  // issued with the mask's, so a skipped brick is a copy with no barrier
  // between its loads and stores.
  const bool copy = inside && !ring && resid != nullptr;
  uint4 rv[S::SLOT / 16];
  if (copy) {
#pragma unroll
    for (int v = 0; v < S::SLOT / 16; ++v)
      rv[v] = __ldg(reinterpret_cast<const uint4*>(resid + idx * CPAD) + v);
  }
  const float m = inside && !ring ? to_f(mask[idx * CPAD]) : 0.f;
  if (inside && m == 0.f) {
    if (copy) {
#pragma unroll
      for (int v = 0; v < S::SLOT / 16; ++v)
        reinterpret_cast<uint4*>(o)[v] = rv[v];
    } else {
      store_zero<T, CPAD>(o);
    }
  }
  if (!__syncthreads_or(m != 0.f)) return;

  // an active brick: group 0's copies first, then its masks, affines and
  // row list
  unsigned char* bufs[2] = {smem + S::IN, smem + S::IN + S::BUF};
  issue_group<T, CPAD>(smem_addr(bufs[0]), static_cast<const T*>(xs.p[0]),
                       b, z0, y0, x0, Zp, Yp, Xs);
  float* hm = reinterpret_cast<float*>(smem + S::HM);
  float* sm = reinterpret_cast<float*>(smem + S::M);
  float* sa = reinterpret_cast<float*>(smem + S::AFF);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + S::LIST);
  int* cnt = reinterpret_cast<int*>(smem + S::CNT);
  sm[tid] = m;
  const unsigned ball = __ballot_sync(0xffffffffu, m != 0.f);
  if (lane == 0) cnt[warp] = __popc(ball);
  if (aff != nullptr) {
    for (int i = tid; i < xs.n * 2 * MAXC; i += THREADS) sa[i] = aff[i];
#pragma unroll 4
    for (int i = tid; i < NH; i += THREADS) {
      const int hz = z0 - 1 + i / (HY * HX), hy = y0 - 1 + i / HX % HY,
                hx = x0 - 1 + i % HX;
      hm[i] = hz >= 0 && hz < Zp && hy >= 0 && hy < Yp && hx >= 0 && hx < Xs
                  ? to_f(mask[voxel_index(b, hz, hy, hx, Zp, Yp, Xs) * CPAD])
                  : 0.f;
    }
  }
  __syncthreads();

  // the rows: the brick's active voxels, in order
  int off = 0, rows = 0;
  for (int wi = 0; wi < WARPS; ++wi) {
    off += wi < warp ? cnt[wi] : 0;
    rows += cnt[wi];
  }
  if (m != 0.f) list[off + __popc(ball & ((1u << lane) - 1u))] = tid;

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
      issue_group<T, CPAD>(smem_addr(bufs[(g + 1) % 2]),
                           static_cast<const T*>(xs.p[g + 1]), b, z0, y0, x0,
                           Zp, Yp, Xs);
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
      affine_group<T, CPAD>(buf, cin, sa + g * 2 * MAXC, hm);
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

template <typename T, int CPAD>
__global__ void __launch_bounds__(THREADS)
    conv_site_q_kernel(Groups xs, const T* __restrict__ mask,
                       const T* __restrict__ resid,
                       const int4* __restrict__ wq,    // [G, 27, MAXC] x 16
                       const float* __restrict__ ws,   // [G, MAXC]
                       const float* __restrict__ aff,  // [G, 2, MAXC] or null
                       const float* __restrict__ amax,  // [B, nz, ny, G]
                       T* __restrict__ out, int B, int Zp, int Yp, int Xs,
                       int tz, int ty, int nz, int ny) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Zp * Yp * Xs) return;
  const Voxel v = decode(idx, Zp, Yp, Xs);
  T* o = out + idx * CPAD;
  const bool ring = v.z == 0 || v.z == Zp - 1 || v.y == 0 || v.y == Yp - 1;
  const float m = ring ? 0.f : to_f(mask[idx * CPAD]);
  if (m == 0.f) {
    if (resid != nullptr && !ring) {
#pragma unroll
      for (int c = 0; c < CPAD; ++c) o[c] = resid[idx * CPAD + c];
    } else {
      store_zero<T, CPAD>(o);
    }
    return;
  }
  const float* am =
      amax + ((static_cast<long long>(v.b) * nz + (v.z - 1) / tz) * ny +
              (v.y - 1) / ty) * xs.n;
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
    for (int dz = 0; dz < 3; ++dz) {
      for (int dy = 0; dy < 3; ++dy) {
        const long long row =
            voxel_index(v.b, v.z + dz - 1, v.y + dy - 1, 0, Zp, Yp, Xs);
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = v.x + dx - 1;
          if (xx < 0 || xx >= Xs) continue;
          const long long nv = (row + xx) * CPAD;
          float mi = 1.f;
          if (sc != nullptr) {
            mi = to_f(mask[nv]);
            if (mi == 0.f) continue;  // relu(.) * 0 quantizes to 0
          }
          int words[CPAD / 4];
          if (!quantize_voxel<T, CPAD>(xg + nv, cin, sc, mi, inv, words))
            continue;
          dp4a_voxel<CPAD, CPAD>(
              iacc, words, wq + (g * 27 + (dz * 3 + dy) * 3 + dx) * MAXC);
        }
      }
    }
    dequant_add<CPAD>(acc, iacc, s, ws + g * MAXC);
  }
#pragma unroll
  for (int c = 0; c < CPAD; ++c) {
    T r = from_f<T>(acc[c] * m);
    if (resid != nullptr) r = from_f<T>(to_f(r) + to_f(resid[idx * CPAD + c]));
    o[c] = r;
  }
}

template <typename T, int CPAD>
static int launch_conv_site_q(const Groups& g, const void* mask,
                              const void* resid, const void* wq,
                              const float* ws, const float* aff,
                              const float* amax, void* out, int B, int Zp,
                              int Yp, int xq, int tz, int ty, int nz, int ny,
                              cudaStream_t stream) {
  const int Xs = xq * (LANES / CPAD);
  const long long n = static_cast<long long>(B) * Zp * Yp * Xs;
  conv_site_q_kernel<T, CPAD><<<blocks_for(n), THREADS, 0, stream>>>(
      g, static_cast<const T*>(mask), static_cast<const T*>(resid),
      static_cast<const int4*>(wq), ws, aff, amax, static_cast<T*>(out), B,
      Zp, Yp, Xs, tz, ty, nz, ny);
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
