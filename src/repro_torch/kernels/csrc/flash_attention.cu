// Blocked online-softmax attention with position masks, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_bhsd of
// repro/kernels/flash_attention.py (pallas_call at :104); the GQA fold of
// repro/kernels/ops.py:26 stays in the Python wrapper (kernels/ops.py).
//
//   q (BH, Sq, d), k and v (BH, Sk, d), bf16 or float32, contiguous;
//   qpos (Sq,) and kpos (Sk,) int32 absolute positions, -1 = empty slot.
//   A key is visible to a query row when
//       kpos >= 0 && qpos >= 0
//       && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
//   scores are dot(q, k) * scale, masked to NEG_INF = -1e30; the running
//   max, normalizer and accumulator are float32 with the reference's
//   "s > NEG_INF/2" test; out = acc / max(l, 1e-30) in v's dtype, so a
//   fully masked row is zeros.
//
// Schedule: one block of 256 threads per (bh, 64-row query tile), grid
// (ceil(Sq / 64), BH).  The block stages its query tile in shared memory
// once, then walks the keys in tiles of 64: stage K and V (in the input
// dtype), scores S = Q K^T with a 4 x 4 register tile per thread, the
// online-softmax update, P through shared memory, O += P V with a
// 4 x (d/16) register tile per thread.  Thread (ty, tx) of the 16 x 16
// grid owns query rows ty + 16 i (i < 4); the 16 threads of a row are 16
// consecutive lanes, so row max and row sum are four xor-shuffles.
// All arithmetic is float32 on the CUDA cores; tensor cores (wgmma), TMA
// and warp specialisation are for a later, speed-minded version.
//
// Masking is by position, never by row or column index: after the GQA
// fold the rows of one tile can belong to several heads, whose positions
// are tile(qpos, G).  A key tile is skipped only when none of its keys can
// be visible to any row, judged from the tile's live query range
// [min qpos, max qpos] and each key's own position (so ring caches with
// -1 holes anywhere, and unsorted positions, stay exact).  Skipping such a
// tile leaves (m, l, acc) exactly as the reference's update would.
// Sq and Sk need not be multiples of 64: missing rows take position -1
// and zero data.
//
// Bound: at the serving shapes the work is (causal) 4 d flops per visible
// (query, key) pair against 2 bytes per element of q, k, v and out.  A
// long prompt is bound by operations; a short one (the serve default,
// 64 tokens) by bytes and, in practice, by launch latency.  This first
// version spends its effort on exactness: each element of K and V is
// read from device memory once per query tile (L2 serves the repeats).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
template <typename T, int D>
struct Layout {
  static constexpr int kLd = D + 4 / static_cast<int>(sizeof(T));
  static constexpr int kLdp = kBK + 1;  // float P tile
  static constexpr size_t kBytes =
      static_cast<size_t>(kBQ + 2 * kBK) * kLd * sizeof(T) +
      static_cast<size_t>(kBQ) * kLdp * sizeof(float) +
      static_cast<size_t>(kBQ + kBK) * sizeof(int);
};

__device__ __forceinline__ bool visible(int kp, int qp, int causal,
                                        int has_window, int window) {
  return kp >= 0 && qp >= 0 && (!causal || kp <= qp) &&
         (!has_window || kp > qp - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, T* __restrict__ out,
                       int Sq, int Sk, float scale, int causal,
                       int has_window, int window) {
  static_assert(D % 16 == 0 && D <= 128, "head dim: a multiple of 16, <= 128");
  constexpr int LD = Layout<T, D>::kLd;
  constexpr int LDP = Layout<T, D>::kLdp;
  constexpr int NJ = D / 16;  // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * LD;
  T* vs = ks + kBK * LD;
  float* ps = reinterpret_cast<float*>(vs + kBK * LD);
  int* qp_s = reinterpret_cast<int*>(ps + kBQ * LDP);
  int* kp_s = qp_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  T* ob = out + bh * Sq * D;
  const T zero = from_f32<T>(0.f);

  // the query tile and its positions (rows past Sq: zeros, position -1)
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int row = q0 + r;
    qs[r * LD + c] = row < Sq ? qb[static_cast<size_t>(row) * D + c] : zero;
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

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const int key = k0 + r;
      const bool in = key < Sk;
      ks[r * LD + c] = in ? kb[static_cast<size_t>(key) * D + c] : zero;
      vs[r * LD + c] = in ? vb[static_cast<size_t>(key) * D + c] : zero;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
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
        const float vv = to_f32(vs[c * LD + tx + 16 * j]);
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
      ob[static_cast<size_t>(row) * D + tx + 16 * j] =
          from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int BH, int Sq, int Sk, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  // shared memory above 48 KB must be allowed on the current device; the
  // call is a host-side attribute write, cheap next to the launch
  constexpr size_t smem = Layout<T, D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), Sq, Sk,
      scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const int* qpos, const int* kpos, void* out, int BH, int Sq,
             int Sk, float scale, int causal, int has_window, int window,
             cudaStream_t stream) {
#define FA_CASE(D)                                                          \
  case D:                                                                   \
    return launch<T, D>(q, k, v, qpos, kpos, out, BH, Sq, Sk, scale, causal, \
                        has_window, window, stream);
  switch (d) {
    FA_CASE(48)
    FA_CASE(64)
    FA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// Launch the attention of BH (batch x kv-head) rows on `stream`; dtype 0 is
// float32, 1 is bfloat16; d one of 48, 64, 128 (the head dims of the dense
// configs and presets).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a dtype or d without a kernel.
int flash_attention_bhsd_launch(const void* q, const void* k, const void* v,
                                const void* qpos, const void* kpos, void* out,
                                int BH, int Sq, int Sk, int d, int dtype,
                                float scale, int causal, int has_window,
                                int window, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, qp, kp, out, BH, Sq, Sk, scale, causal,
                           has_window, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, qp, kp, out, BH, Sq, Sk, scale,
                                   causal, has_window, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
