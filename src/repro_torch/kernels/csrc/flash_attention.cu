// Blocked online-softmax attention with position masks, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_bhsd of
// repro/kernels/flash_attention.py (pallas_call at :104); the GQA fold of
// repro/kernels/ops.py:26 stays in the Python wrapper (kernels/ops.py).
//
//   q (BH, Sq, dqk), k (BH, Sk, dqk) and v (BH, Sk, dv), bf16 or float32,
//   contiguous (dv == dqk except for MLA's prefill, dqk 192 over dv 128);
//   qpos (Sq,) and kpos (Sk,) int32 absolute positions, -1 = empty slot.
//   A key is visible to a query row when
//       kpos >= 0 && qpos >= 0
//       && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
//   scores are dot(q, k) * scale, masked to NEG_INF = -1e30; the running
//   max, normalizer and accumulator are float32 with the reference's
//   "s > NEG_INF/2" test; out = acc / max(l, 1e-30) in v's dtype, so a
//   fully masked row is zeros.
//
// Masking is by position, never by row or column index: after the GQA
// fold the rows of one tile can belong to several heads, whose positions
// are tile(qpos, G).  A key tile is skipped only when none of its keys can
// be visible to any row, judged from the tile's live query range
// [min qpos, max qpos] and each key's own position (so ring caches with
// -1 holes anywhere, and unsorted positions, stay exact).  Skipping such a
// tile leaves (m, l, acc) exactly as the reference's update would.
// Sq and Sk need not be multiples of the tiles: missing rows take
// position -1 and zero data.
//
// Two routes, chosen by the wrapper from dtype and head dim alone:
//
// * The tensor-core route (namespace tc; bf16, d 64 and 128, the head dims
//   of every dense config at full width).  Bound: a long causal prompt is
//   bound by operations (4 d flops per visible pair), which bf16 reaches
//   only through wgmma.  One block of three warpgroups per (bh, 128 query
//   rows), launched longest first (the last tiles of a causal prompt see
//   the most keys).  Warp 8 produces: it loads the query tile once by TMA,
//   then walks the key tiles of 64, skips the dead ones, marks the ones
//   every live row sees whole (no mask needed), and streams the rest
//   through a ring of three K/V stages filled by TMA (3-D maps over (d,
//   S, BH), 128-byte swizzle, rows past S zero-filled by the hardware),
//   each signalled on an mbarrier, with the tile's key positions beside
//   it.  Warpgroups 0 and 1 consume 64 query rows each: S = Q K^T by
//   wgmma (both operands in shared memory, float32 accumulators), the
//   mask and the online softmax on the registers of S, then O += P V by
//   wgmma with P from registers and V transposed.  As in
//   FlashAttention-3, S of tile j + 1 is issued ahead of P V of tile j,
//   and the softmax of j + 1 runs while P V of j is on the tensor cores
//   (a consumer holds two stages; the third is in flight); the last P V
//   is peeled out of the loop, so no wgmma is issued under a branch
//   (ptxas serializes them otherwise).
//   P is split into bf16 hi = bf16(p) and lo = bf16(p - hi), two products
//   into the one float32 O: a single bf16 P rounds p to 2^-9 and leaves
//   B6's envelope (2 bf16 ulps of the plain output) on about 6% of the
//   outputs of a 2048-token folded prompt, the split carries p to about
//   2^-17 and leaves it on none (tests/test_torch_flash_attention.py
//   emulates both); it costs a third product, 6 d flops per pair.  Q K^T
//   needs no such care: bf16 products are exact in float32.
//   p = 2^((s - m) log2 e) by ex2.approx.ftz rather than the plain
//   version's expf: the accurate expf took 1.5 of 3.4 ms at an 8192-token
//   prompt (exp2f 0.6, ex2.approx.ftz 0.2), and the emulation (its 2 ulps
//   and the flush of results below 2^-126 included) stays inside the
//   envelope.
//   Registers decide the key tile: ptxas gave the consumers at most 168
//   registers whatever setmaxnreg asked (232 here, 40 for the producer),
//   and S, the split P and O of 128-key tiles (64 + 64 + 64) spilled; the
//   spilling builds ran slower, and some builds of an earlier form gave
//   wrong outputs for a cause not found (spilling builds of this source
//   did not), so the wrapper refuses a build whose tensor-core instances
//   use local memory (flash_attention_tc_local_bytes).  64-key tiles (32
//   + 32 + 64 at d 128) do not spill.  The epilogue divides by
//   max(l, 1e-30) and stores bf16 pairs from registers.
// * The SIMT route (float32; bf16 at d 48, at d 80 and at dqk 192 over dv
//   128): one block of 256 threads per (bh, 64-row query tile), K and V
//   staged by the threads, all arithmetic float32 FMAs on the CUDA cores
//   (tensor cores would need TF32 for float32, which moves the results
//   off the reference).  Thread (ty, tx) of a 16 x 16 grid owns query rows
//   ty + 16 i (i < 4) and a 4 x 4 tile of scores; row max and row sum are
//   four xor-shuffles.  The kernel takes q/k's head dim and v's apart
//   (DQK, DV): the scores run over DQK, the output's DV / 16 columns per
//   thread over DV.  Instances: (48, 48), (64, 64), (128, 128) in float32,
//   (48, 48) in bf16, and (80, 80) and (192, 128) in both (zamba2's and
//   hubert's head dim; DeepSeek-V2's MLA prefill, nope 128 + rope 64 over
//   v 128).  The float32 (192, 128) tiles take ~146 KB of shared memory,
//   above the 48 KB default, by the same opt-in as d 128.  No instance
//   uses local memory (flash_attention_simt_local_bytes; the wrapper
//   refuses a build where one does, as for the tensor-core route).
#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: see tc::encode_tiled)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row stride of a (rows, D) tile in shared memory, in elements: one extra
// 4-byte word per row, so the 16 rows that 16 lanes read at one column
// fall in 16 different banks.
template <typename T, int DQK, int DV>
struct Layout {
  static constexpr int kPad = 4 / static_cast<int>(sizeof(T));
  static constexpr int kLd = DQK + kPad;   // Q and K tiles
  static constexpr int kLdv = DV + kPad;   // V tile
  static constexpr int kLdp = kBK + 1;     // float P tile
  static constexpr size_t kBytes =
      static_cast<size_t>(kBQ + kBK) * kLd * sizeof(T) +
      static_cast<size_t>(kBK) * kLdv * sizeof(T) +
      static_cast<size_t>(kBQ) * kLdp * sizeof(float) +
      static_cast<size_t>(kBQ + kBK) * sizeof(int);
};

__device__ __forceinline__ bool visible(int kp, int qp, int causal,
                                        int has_window, int window) {
  return kp >= 0 && qp >= 0 && (!causal || kp <= qp) &&
         (!has_window || kp > qp - window);
}

// The minimum of one block a multiprocessor lifts ptxas's own register
// target: without it ptxas held the float32 (64, 64) instance at 64
// registers and spilled 24 bytes a thread; with it no instance uses local
// memory (tools/b6_variants.py simt), and the wrapper refuses a build
// where one does.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, T* __restrict__ out,
                       int Sq, int Sk, float scale, int causal,
                       int has_window, int window) {
  static_assert(DQK % 8 == 0 && DQK <= 192, "q/k head dim: a multiple of 8, <= 192");
  static_assert(DV % 16 == 0 && DV <= 128, "v head dim: a multiple of 16, <= 128");
  constexpr int LD = Layout<T, DQK, DV>::kLd;
  constexpr int LDV = Layout<T, DQK, DV>::kLdv;
  constexpr int LDP = Layout<T, DQK, DV>::kLdp;
  constexpr int NJ = DV / 16;  // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * LD;
  T* vs = ks + kBK * LD;
  float* ps = reinterpret_cast<float*>(vs + kBK * LDV);
  int* qp_s = reinterpret_cast<int*>(ps + kBQ * LDP);
  int* kp_s = qp_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * DQK;
  const T* kb = k + bh * Sk * DQK;
  const T* vb = v + bh * Sk * DV;
  T* ob = out + bh * Sq * DV;
  const T zero = from_f32<T>(0.f);

  // the query tile and its positions (rows past Sq: zeros, position -1)
  for (int e = tid; e < kBQ * DQK; e += kThreads) {
    const int r = e / DQK, c = e - r * DQK;
    const int row = q0 + r;
    qs[r * LD + c] = row < Sq ? qb[static_cast<size_t>(row) * DQK + c] : zero;
  }
  if (tid < kBQ) qp_s[tid] = q0 + tid < Sq ? qpos[q0 + tid] : -1;
  __syncthreads();

  // the tile's live position range (rows with qpos >= 0)
  int qmin = 0x7fffffff, qmax = -1;
  for (int r = 0; r < kBQ; ++r) {
    const int p = qp_s[r];
    if (p >= 0) {
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = qp_s[ty + 16 * i];

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    // positions of this key tile (keys past Sk: -1); skip the tile when no
    // key in it is visible to any live row of the query tile
    int live = 0;
    if (tid < kBK) {
      const int key = k0 + tid;
      const int p = key < Sk ? kpos[key] : -1;
      kp_s[tid] = p;
      live = qmax >= 0 && p >= 0 && (!causal || p <= qmax) &&
             (!has_window || p > qmin - window);
    }
    if (!__syncthreads_or(live)) continue;

    for (int e = tid; e < kBK * DQK; e += kThreads) {
      const int r = e / DQK, c = e - r * DQK;
      const int key = k0 + r;
      ks[r * LD + c] = key < Sk ? kb[static_cast<size_t>(key) * DQK + c] : zero;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int r = e / DV, c = e - r * DV;
      const int key = k0 + r;
      vs[r * LDV + c] = key < Sk ? vb[static_cast<size_t>(key) * DV + c] : zero;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DQK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(qs[(ty + 16 * i) * LD + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f32(ks[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // mask, then the online-softmax update of (m, l, acc)
    float alpha[4], rsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kp_s[tx + 16 * j];
        s[i][j] = visible(kp, qp[i], causal, has_window, window)
                      ? s[i][j] * scale
                      : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      alpha[i] = m[i] > kNegInf * 0.5f ? expf(m[i] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > kNegInf * 0.5f ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      rsum[i] = rs;
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = alpha[i] * l[i] + rsum[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = to_f32(vs[c * LDV + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // K, V, P and kpos are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[static_cast<size_t>(row) * DV + tx + 16 * j] =
          from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int BH, int Sq, int Sk, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  // shared memory above 48 KB must be allowed on the current device; the
  // call is a host-side attribute write, cheap next to the launch
  constexpr size_t smem = Layout<T, DQK, DV>::kBytes;
  static_assert(smem <= 232448, "227 KB of shared memory per block");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), Sq, Sk,
      scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

// The SIMT instances, (dqk, dv) pairs: float32 at (48, 48), (64, 64),
// (128, 128), (80, 80) and (192, 128); bfloat16 at (48, 48), (80, 80) and
// (192, 128) (bf16 at equal dims of 64 and 128 takes the tensor-core
// route, so the SIMT kernel has no instance for it).
int launch_d(int dqk, int dv, bool bf16, const void* q, const void* k,
             const void* v, const int* qpos, const int* kpos, void* out,
             int BH, int Sq, int Sk, float scale, int causal, int has_window,
             int window, cudaStream_t stream) {
#define FA_CASE(T, DQK, DV)                                                 \
  if (dqk == DQK && dv == DV)                                               \
    return launch<T, DQK, DV>(q, k, v, qpos, kpos, out, BH, Sq, Sk, scale,  \
                              causal, has_window, window, stream);
  if (bf16) {
    FA_CASE(__nv_bfloat16, 48, 48)
    FA_CASE(__nv_bfloat16, 80, 80)
    FA_CASE(__nv_bfloat16, 192, 128)
  } else {
    FA_CASE(float, 48, 48)
    FA_CASE(float, 64, 64)
    FA_CASE(float, 128, 128)
    FA_CASE(float, 80, 80)
    FA_CASE(float, 192, 128)
  }
#undef FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ===================================================================
// The tensor-core route: bfloat16, head dim 64 or 128.
// ===================================================================
namespace tc {

constexpr int kBQ = 128;        // query rows per block: two consumer warpgroups
constexpr int kBK = 64;         // keys per tile
constexpr int kStages = 3;      // K/V ring depth
constexpr int kThreads = 384;   // warpgroups 0, 1 consume; warp 8 produces
constexpr int kRowBytes = 128;  // one 64-column half of a bf16 row (a swizzle row)
constexpr int kEnd = -1;        // the tile stream's end marker
constexpr long long kWatchdogCycles = 1ll << 34;  // ~9 s: a lost barrier traps
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base: each operand tile is stored
// as D/64 column halves of (rows x 128 bytes), 128-byte swizzled by TMA.
template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  static constexpr int kQBytes = kHalves * kBQ * kRowBytes;
  static constexpr int kTileBytes = kHalves * kBK * kRowBytes;  // one K or V
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                  // + stage * kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;     // + stage * kTileBytes
  static constexpr int kKpos = kV + kStages * kTileBytes;  // int [kStages][kBK]
  static constexpr int kInfo = kKpos + kStages * kBK * 4;  // int2 [kStages]
  static constexpr int kBar = kInfo + kStages * 8;  // q, full[kStages], empty[..]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete.  A barrier that never
// completes (a fault in the protocol) traps after kWatchdogCycles, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// One box of a 3-D tensor map (d, rows, bh) into shared memory; completion
// is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
// K-major (Q, K): SBO = 1024 (8 rows of 128 B), LBO unused.  N-major (V,
// transposed): LBO = the distance between 64-column halves, SBO = 1024
// (8 keys of 128 B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's commit groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register accesses across the asynchronous
// products (the accumulators are written by the tensor cores until the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The wgmma forms the kernel uses, by N (the tile's width): S = Q K^T with
// both operands in shared memory (N = the key tile), O += P V with P from
// registers (N = the head dim).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);
template <int N>
__device__ void wgmma_ss_first(float (&d)[N / 2], uint64_t da, uint64_t db);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

// D (64 x 64, f32) += A (64 x 16) B (16 x 64); A and B K-major in
// shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, f32) = A (64 x 16) B (16 x 64): the first step, which
// reads no accumulator.
template <>
__device__ __forceinline__ void wgmma_ss_first<64>(float (&d)[32],
                                                  uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64); B N-major
// (transposed) in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) B (16 x 128); B N-major
// (transposed) in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// p0, p1 (adjacent columns of one row) -> bf16x2 hi = bf16(p) and lo =
// bf16(p - hi); p - hi is exact in float32, so hi + lo carries p to about
// 2^-17 of itself and each product with a bf16 v is exact in float32.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S = Q K^T over d in steps of 16 (32 bytes inside a swizzle row): one
// commit group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t qa,
                                         uint32_t ka) {
  fence_regs(s);
  wgmma_fence();
  wgmma_ss_first<kBK>(s, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024));
#pragma unroll
  for (int j = 1; j < D / 16; ++j) {
    const uint32_t qoff = (j / 4) * kBQ * kRowBytes + (j % 4) * 32;
    const uint32_t koff = (j / 4) * kBK * kRowBytes + (j % 4) * 32;
    wgmma_ss<kBK>(s, sw128_desc(qa + qoff, 16, 1024),
                  sw128_desc(ka + koff, 16, 1024));
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V over the tile's keys in steps of 16 (16 rows of V,
// 2048 bytes); V is N-major, its two halves kBK * 128 bytes apart: one
// commit group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&ph)[kBK / 16][4],
                                         const uint32_t (&pl)[kBK / 16][4],
                                         uint32_t va) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wgmma_rs<D>(o, ph[j],
                sw128_desc(va + j * 16 * kRowBytes, kBK * kRowBytes, 1024));
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wgmma_rs<D>(o, pl[j],
                sw128_desc(va + j * 16 * kRowBytes, kBK * kRowBytes, 1024));
  wgmma_commit();
}

// The online-softmax step of one tile on the registers of S, in place:
// scale, mask by position unless every pair is visible, the new row maxima
// m0, m1, p = exp(s - m) (0 where masked), l = alpha l + (this thread's
// share of the row sums; the quad adds the shares at the end).  a0, a1 get
// alpha, the factor for the old O.
// 2^x by the MUFU unit (ex2.approx: at most 2 ulps; results below 2^-126
// flush to zero, far under what a bf16 output resolves).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void softmax_tile(
    float (&s)[kBK / 2], int unmasked, const int* kps, int cq, int qp0,
    int qp1, float scale, int causal, int has_window, int window, float& m0,
    float& m1, float& l0, float& l1, float& a0, float& a1) {
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] *= scale;
  if (!unmasked) {
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      const int2 kp = *reinterpret_cast<const int2*>(kps + 8 * i + cq);
      if (!visible(kp.x, qp0, causal, has_window, window)) s[4 * i] = kNegInf;
      if (!visible(kp.y, qp0, causal, has_window, window))
        s[4 * i + 1] = kNegInf;
      if (!visible(kp.x, qp1, causal, has_window, window))
        s[4 * i + 2] = kNegInf;
      if (!visible(kp.y, qp1, causal, has_window, window))
        s[4 * i + 3] = kNegInf;
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = m0 > kNegInf * 0.5f ? ex2((m0 - mn0) * kLog2e) : 0.f;
  a1 = m1 > kNegInf * 0.5f ? ex2((m1 - mn1) * kLog2e) : 0.f;
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * i + e];
      const float p =
          x > kNegInf * 0.5f ? ex2((x - (e < 2 ? mn0 : mn1)) * kLog2e) : 0.f;
      s[4 * i + e] = p;
      if (e < 2)
        rs0 += p;
      else
        rs1 += p;
    }
  }
  l0 = a0 * l0 + rs0;
  l1 = a1 * l1 + rs1;
}

// P (in the registers of S) as the A operand of P V, split into hi and lo:
// register h of key step j holds s[8 j + 2 h], s[8 j + 2 h + 1] (row r0 for
// h even, r0 + 8 for h odd).
__device__ __forceinline__ void split_tile(const float (&s)[kBK / 2],
                                           uint32_t (&ph)[kBK / 16][4],
                                           uint32_t (&pl)[kBK / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      split_p(s[8 * j + 2 * h], s[8 * j + 2 * h + 1], ph[j][h], pl[j][h]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const int* __restrict__ qpos, const int* __restrict__ kpos,
             __nv_bfloat16* __restrict__ out, int Sq, int Sk, float scale,
             int causal, int has_window, int window) {
  static_assert(D == 64 || D == 128, "tensor-core head dims: 64, 128");
  static_assert(kBK % 32 == 0 && kBK <= 256, "key tile: lanes x 32, <= 256");
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int* kpos_s = reinterpret_cast<int*>(smem + L::kKpos);
  int2* info_s = reinterpret_cast<int2*>(smem + L::kInfo);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.x;
  // longest first: under a causal mask the last query tiles see most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // warp-uniform to the compiler (as CUTLASS's canonical_warp_group_idx)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);    // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    // the tile's live query range, and whether every row below Sq is live
    int qmin = 0x7fffffff, qmax = -1;
    bool rows_live = true;
#pragma unroll
    for (int i = 0; i < kBQ / 32; ++i) {
      const int r = q0 + lane + 32 * i;
      const int p = r < Sq ? qpos[r] : -1;
      if (p >= 0) {
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      } else if (r < Sq) {
        rows_live = false;
      }
    }
    qmin = __reduce_min_sync(0xffffffffu, qmin);
    qmax = __reduce_max_sync(0xffffffffu, qmax);
    const bool all_rows = __all_sync(0xffffffffu, rows_live);
    if (lane == 0) {
      mbar_arrive_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h)
        tma_load(base + L::kQ + h * kBQ * kRowBytes, &tq, bar_q, 64 * h, q0,
                 bh);
    }
    int stage = 0, round = 0;
    const int nk = (Sk + kBK - 1) / kBK;
    // key positions four tiles at a time (16 loads in flight), so that
    // runs of skipped tiles cost one latency per four
    for (int t0 = 0; qmax >= 0 && t0 < nk; t0 += 4) {
      int kp[4][kBK / 32];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < kBK / 32; ++i) {
          const int key = (t0 + u) * kBK + lane + 32 * i;
          kp[u][i] = key < Sk ? __ldg(kpos + key) : -1;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u;
        if (t >= nk) break;
        // some key of the tile visible to some live row (skip otherwise);
        // every key visible to every live row (no mask needed)
        bool any = false, all = true;
#pragma unroll
        for (int i = 0; i < kBK / 32; ++i) {
          const int p = kp[u][i];
          any |= p >= 0 && (!causal || p <= qmax) &&
                 (!has_window || p > qmin - window);
          all &= p >= 0 && (!causal || p <= qmin) &&
                 (!has_window || p > qmax - window);
        }
        if (!__any_sync(0xffffffffu, any)) continue;
        const int unmasked = all_rows && __all_sync(0xffffffffu, all);
        mbar_wait(bar_empty + 8 * stage, round ^ 1);
#pragma unroll
        for (int i = 0; i < kBK / 32; ++i)
          kpos_s[stage * kBK + lane + 32 * i] = kp[u][i];
        const uint32_t full = bar_full + 8 * stage;
        if (lane == 0) {
          info_s[stage] = make_int2(t * kBK, unmasked);
          mbar_arrive_tx(full, 2 * L::kTileBytes);
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            const uint32_t off = stage * L::kTileBytes + h * kBK * kRowBytes;
            tma_load(base + L::kK + off, &tk, full, 64 * h, t * kBK, bh);
            tma_load(base + L::kV + off, &tv, full, 64 * h, t * kBK, bh);
          }
        } else {
          mbar_arrive(full);
        }
        if (++stage == kStages) {
          stage = 0;
          round ^= 1;
        }
      }
    }
    // the end of the stream
    mbar_wait(bar_empty + 8 * stage, round ^ 1);
    if (lane == 0) info_s[stage] = make_int2(kEnd, 0);
    mbar_arrive(bar_full + 8 * stage);
  } else {
    // ------------------------------------------------------ consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    // accumulator layout of m64nN: this thread holds rows r0 and r0 + 8 of
    // the warpgroup's 64, columns 8 i + cq and 8 i + cq + 1 of each 8
    const int r0 = q0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const int qp0 = r0 < Sq ? qpos[r0] : -1;
    const int qp1 = r0 + 8 < Sq ? qpos[r0 + 8] : -1;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, a0, a1;
    float s[kBK / 2];
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
    const uint32_t qa = base + L::kQ + wg * 64 * kRowBytes;
    mbar_wait(bar_q, 0);

    int stage = 0, round = 0;
    mbar_wait(bar_full, 0);
    const int2 first = info_s[0];
    if (first.x != kEnd) {
      // the first tile: S, its softmax and P (O is still zero)
      issue_qk<D>(s, qa, base + L::kK);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, first.y, kpos_s, cq, qp0, qp1, scale, causal,
                   has_window, window, m0, m1, l0, l1, a0, a1);
      split_tile(s, ph, pl);
      while (true) {
        // S of the next tile goes to the tensor cores ahead of P V of this
        // one, and the next softmax runs while P V is on the tensor cores
        int next = stage + 1, next_round = round;
        if (next == kStages) {
          next = 0;
          next_round ^= 1;
        }
        mbar_wait(bar_full + 8 * next, next_round);
        const int2 info = info_s[next];
        if (info.x == kEnd) break;
        issue_qk<D>(s, qa, base + L::kK + next * L::kTileBytes);
        issue_pv<D>(o, ph, pl, base + L::kV + stage * L::kTileBytes);
        wgmma_wait<1>();
        fence_regs(s);
        softmax_tile(s, info.y, kpos_s + next * kBK, cq, qp0, qp1, scale,
                     causal, has_window, window, m0, m1, l0, l1, a0, a1);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(bar_empty + 8 * stage);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i] *= a0;
          o[4 * i + 1] *= a0;
          o[4 * i + 2] *= a1;
          o[4 * i + 3] *= a1;
        }
        split_tile(s, ph, pl);
        stage = next;
        round = next_round;
      }
      // P V of the last tile
      issue_pv<D>(o, ph, pl, base + L::kV + stage * L::kTileBytes);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * stage);
    }

    // epilogue: out = O / max(l, 1e-30), bf16 pairs straight from registers
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = out + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + cq;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r0) * D +
                                           c) =
            __floats2bfloat162_rn(o[4 * i] / d0, o[4 * i + 1] / d0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<size_t>(r0 + 8) * D + c) =
            __floats2bfloat162_rn(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (d, rows, BH) bf16 map with (64, box_rows, 1) boxes, 128-byte swizzle;
// rows past `rows` read as zeros and never from the next bh.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D,
              int rows, int BH, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int BH, int Sq, int Sk, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const int nq = (Sq + kBQ - 1) / kBQ;
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // with no keys the K/V maps are never read: q stands in for them
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, D, Sq, BH, kBQ) ||
      !make_map(encode, &mk, Sk > 0 ? k : q, D, Sk > 0 ? Sk : Sq, BH, kBK) ||
      !make_map(encode, &mv, Sk > 0 ? v : q, D, Sk > 0 ? Sk : Sq, BH, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<D>::kAlloc;
  static_assert(smem <= 232448, "227 KB of shared memory per block");
  const cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, nq);
  fa_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, qpos, kpos, static_cast<__nv_bfloat16*>(out), Sq, Sk, scale,
      causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// The SIMT route: launch the attention of BH (batch x kv-head) rows on
// `stream`; d is q's and k's head dim, dv v's; dtype 0 is float32, 1 is
// bfloat16, at the (d, dv) pairs of launch_d.  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a dtype or
// pair without a kernel.
int flash_attention_bhsd_launch(const void* q, const void* k, const void* v,
                                const void* qpos, const void* kpos, void* out,
                                int BH, int Sq, int Sk, int d, int dv,
                                int dtype, float scale, int causal,
                                int has_window, int window, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(d, dv, dtype == 1, q, k, v, static_cast<const int*>(qpos),
                  static_cast<const int*>(kpos), out, BH, Sq, Sk, scale,
                  causal, has_window, window, static_cast<cudaStream_t>(stream));
}

// The tensor-core route: bf16 only, d one of 64, 128.  Same arguments and
// return codes as flash_attention_bhsd_launch (no dtype: always bfloat16);
// also cudaErrorInvalidValue when a tensor map cannot be encoded (a base
// address not 16-byte aligned) or Sq needs more than 65535 query tiles.
int flash_attention_bhsd_tc_launch(const void* q, const void* k,
                                   const void* v, const void* qpos,
                                   const void* kpos, void* out, int BH, int Sq,
                                   int Sk, int d, float scale, int causal,
                                   int has_window, int window, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  const auto st = static_cast<cudaStream_t>(stream);
#define TC_CASE(D)                                                         \
  case D:                                                                  \
    return tc::launch<D>(q, k, v, qp, kp, out, BH, Sq, Sk, scale, causal, \
                         has_window, window, st);
  switch (d) {
    TC_CASE(64)
    TC_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TC_CASE
}

// Local memory per thread (spill space and stack frame) of the
// tensor-core instance for head dim d (64 or 128), as the runtime reports
// it for the loaded module; -1 for another d or a failed query.  The
// wrapper refuses a build where this is not 0 (see the header note).
int flash_attention_tc_local_bytes(int d) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (d == 64)
    err = cudaFuncGetAttributes(&attr, tc::fa_tc_kernel<64>);
  else if (d == 128)
    err = cudaFuncGetAttributes(&attr, tc::fa_tc_kernel<128>);
  else
    return -1;
  return err == cudaSuccess ? static_cast<int>(attr.localSizeBytes) : -1;
}

// Local memory per thread (spill space and stack frame) of the SIMT
// instance for (dtype, dqk, dv), dtype 0 float32 and 1 bfloat16, as the
// runtime reports it for the loaded module; -1 for a pair without an
// instance (the FA_CASE list of launch_d) or a failed query.
int flash_attention_simt_local_bytes(int dtype, int dqk, int dv) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
#define FA_LOCAL(T, DQK, DV)                                           \
  if (dqk == DQK && dv == DV)                                          \
    err = cudaFuncGetAttributes(&attr, flash_attention_kernel<T, DQK, DV>);
  if (dtype == 1) {
    FA_LOCAL(__nv_bfloat16, 48, 48)
    FA_LOCAL(__nv_bfloat16, 80, 80)
    FA_LOCAL(__nv_bfloat16, 192, 128)
  } else if (dtype == 0) {
    FA_LOCAL(float, 48, 48)
    FA_LOCAL(float, 64, 64)
    FA_LOCAL(float, 128, 128)
    FA_LOCAL(float, 80, 80)
    FA_LOCAL(float, 192, 128)
  }
#undef FA_LOCAL
  return err == cudaSuccess ? static_cast<int>(attr.localSizeBytes) : -1;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
