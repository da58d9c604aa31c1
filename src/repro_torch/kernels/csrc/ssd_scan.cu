// Mamba2 SSD intra-chunk compute, for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_intra_chunk of repro/kernels/ssd_scan.py
// (pallas_call at :66); the cross-chunk combine of repro/kernels/ops.py:48
// stays in the Python wrapper (kernels/ops.py ssd_scan_pallas).
//
//   x  (BC, Q, H, P) float32 or bfloat16     BC = batch x chunks
//   dt (BC, Q, H), dA (BC, Q, H) float32      dA = dt * A (negative)
//   B, C (BC, Q, G, N) float32                group of head h: h / (H / G)
// For each (chunk, head) cell, in float32:
//   cums[t] = dA[0] + ... + dA[t]
//   L[t,s]  = exp(cums[t] - cums[s]) for s <= t, else 0 (the mask is applied
//             BEFORE exp: the upper triangle is positive and overflows)
//   W[t,s]  = ((C[t] . B[s]) * L[t,s]) * dt[s]
//   y[t,p]  = sum_s W[t,s] x[s,p]                        -> y (BC, Q, H, P)
//   w2[s]   = exp(cums[Q-1] - cums[s]) * dt[s]
//   st[n,p] = sum_s (B[s,n] * w2[s]) x[s,p]              -> st (BC, H, N, P)
// (the state is laid out (N, P), as the reference's kernel writes it; the
// wrapper transposes it to (P, N)).
//
// Schedule: grid (BC * H, ceil(Q / 64) + ceil(N / 64)), 256 threads.  A
// block of the first ceil(Q/64) tiles owns 64 rows t of y: it stages its C
// rows once, then walks the s tiles of 64 up to its last row (the causal
// half only), staging B and x, forming the W tile in shared memory and
// accumulating y (64 x P) in registers, a 4 x ceil(P/16) tile per thread
// (ceil(P/16) a template parameter: 1, 2, 4 or 8).
// A block of the last ceil(N/64) tiles owns 64 rows n of the state and
// walks all s tiles the same way with (B * w2)^T in place of W.  So one
// launch covers the cell, and the tiles of one cell run side by side.
// Shared memory: 2 Q + 2 x 64 (N + 1) + 64 P + 64 x 65 floats, 101 KB at
// Q 256, N 128, P 64 (mamba2-780m), allowed per launch above 48 KB.
// All arithmetic is float32 on the CUDA cores (the reference's dots are
// float32 with float32 accumulation); tensor cores are for a later,
// speed-minded version.
//
// Bound: operations at the model's shapes.  Per cell the causal half of the
// Q x Q products (C.B^T over N and W.x over P) and the Q x N x P state
// product, against the inputs read once and y and the state written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // rows t (or n) per block, and s per step
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kMaxColSlots = 8; // P <= 128: columns tx + 16 j, j < 8
constexpr int kLdW = kTile + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int Q, int N, int P) {
  return sizeof(float) * (2 * static_cast<size_t>(Q) +
                          2 * static_cast<size_t>(kTile) * (N + 1) +
                          static_cast<size_t>(kTile) * P + kTile * kLdW);
}

// kColSlots = ceil(P / 16) columns of y (or the state) per thread, a
// compile-time count so that no accumulator is kept for columns past P.
template <typename TX, int kColSlots>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ dA,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ st, int Q, int H, int P, int G,
                     int N) {
  extern __shared__ __align__(16) float smem[];
  float* cums = smem;                  // Q
  float* dts = cums + Q;               // Q
  float* sA = dts + Q;                 // 64 x (N + 1): C rows of the tile
  float* sB = sA + kTile * (N + 1);    // 64 x (N + 1): B rows of the s tile
  float* sX = sB + kTile * (N + 1);    // 64 x P: x rows of the s tile
  float* sW = sX + kTile * P;          // 64 x 65: W (or (B w2)^T) tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t cell = blockIdx.x;
  const size_t bc = cell / H;
  const int h = static_cast<int>(cell % H);
  const int grp = h / (H / G);
  const int n_t_tiles = (Q + kTile - 1) / kTile;
  const bool y_tile = static_cast<int>(blockIdx.y) < n_t_tiles;
  const int r0 = (y_tile ? blockIdx.y : blockIdx.y - n_t_tiles) * kTile;

  // dt and the within-chunk cumulative sum of dA (in order, one thread)
  for (int s = tid; s < Q; s += kThreads) {
    const size_t i = (bc * Q + s) * H + h;
    dts[s] = dt[i];
    cums[s] = dA[i];
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 1; s < Q; ++s) cums[s] = __fadd_rn(cums[s - 1], cums[s]);
  if (y_tile) {
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      const int t = r0 + r;
      sA[r * (N + 1) + n] =
          t < Q ? Cm[((bc * Q + t) * G + grp) * N + n] : 0.f;
    }
  }
  __syncthreads();

  float acc[4][kColSlots];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kColSlots; ++j) acc[i][j] = 0.f;

  // y tiles need s up to their last row; state tiles need every s
  const int s_end = y_tile ? min(r0 + kTile, Q) : Q;
  const float cum_last = cums[Q - 1];
  for (int s0 = 0; s0 < s_end; s0 += kTile) {
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int c = e / P, p = e - c * P;
      const int s = s0 + c;
      sX[e] = s < Q ? to_f32(x[((bc * Q + s) * H + h) * P + p]) : 0.f;
    }
    if (y_tile) {
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int c = e / N, n = e - c * N;
        const int s = s0 + c;
        sB[c * (N + 1) + n] =
            s < Q ? Bm[((bc * Q + s) * G + grp) * N + n] : 0.f;
      }
      __syncthreads();
      // W[r][c] for rows r0 + ty + 16 i and columns s0 + tx + 16 j
      float cb[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(a[i], b[j], cb[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, t = r0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, s = s0 + c;
          float w = 0.f;
          if (s <= t && t < Q) {
            const float L = expf(__fsub_rn(cums[t], cums[s]));
            w = __fmul_rn(__fmul_rn(cb[i][j], L), dts[s]);
          }
          sW[r * kLdW + c] = w;
        }
      }
    } else {
      // (B * w2)^T: rows n = r0 + r, columns s = s0 + c
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int c = e / kTile, r = e - c * kTile;
        const int s = s0 + c, n = r0 + r;
        float v = 0.f;
        if (s < Q && n < N) {
          const float w2 =
              __fmul_rn(expf(__fsub_rn(cum_last, cums[s])), dts[s]);
          v = __fmul_rn(Bm[((bc * Q + s) * G + grp) * N + n], w2);
        }
        sW[r * kLdW + c] = v;
      }
    }
    __syncthreads();
    // acc[rows][p] += tile[rows][s] * x[s][p]
    const int c_end = min(kTile, s_end - s0);
    for (int c = 0; c < c_end; ++c) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sW[(ty + 16 * i) * kLdW + c];
#pragma unroll
      for (int j = 0; j < kColSlots; ++j) {
        const int p = tx + 16 * j;
        if (p < P) {
          const float xv = sX[c * P + p];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], xv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // sB, sX and sW are rewritten by the next s tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= (y_tile ? Q : N)) continue;
    float* dst = y_tile ? y + ((bc * Q + row) * H + h) * P
                        : st + ((bc * H + h) * N + row) * P;
#pragma unroll
    for (int j = 0; j < kColSlots; ++j) {
      const int p = tx + 16 * j;
      if (p < P) dst[p] = acc[i][j];
    }
  }
}

template <typename TX, int kColSlots>
int launch_p(const void* x, const float* dt, const float* dA, const float* B,
             const float* C, float* y, float* st, int BC, int Q, int H,
             int P, int G, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N, P);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel<TX, kColSlots>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BC) * H,
                  (Q + kTile - 1) / kTile + (N + kTile - 1) / kTile);
  ssd_intra_kernel<TX, kColSlots><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), dt, dA, B, C, y, st, Q, H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch(const void* x, const float* dt, const float* dA, const float* B,
           const float* C, float* y, float* st, int BC, int Q, int H, int P,
           int G, int N, cudaStream_t stream) {
  const int slots = (P + 15) / 16;
  if (slots <= 1)
    return launch_p<TX, 1>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N, stream);
  if (slots <= 2)
    return launch_p<TX, 2>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N, stream);
  if (slots <= 4)
    return launch_p<TX, 4>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N, stream);
  return launch_p<TX, 8>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N, stream);
}

}  // namespace

extern "C" {

// Launch the intra-chunk SSD of BC x H cells on `stream`; dtype 0 is float32
// x, 1 is bfloat16 x (dt, dA, B, C, y and st are float32).  Needs P <= 128
// and H a multiple of G.  Returns cudaGetLastError() after the launch (0 on
// success), the attribute call's error when Q, N and P need more shared
// memory than a block has, or cudaErrorInvalidValue for shapes without a
// kernel.
int ssd_intra_chunk_launch(const void* x, const void* dt, const void* dA,
                           const void* B, const void* C, void* y, void* st,
                           int BC, int Q, int H, int P, int G, int N,
                           int dtype, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0) return 0;
  if (P <= 0 || P > 16 * kMaxColSlots || N <= 0 || G <= 0 || H % G != 0 ||
      static_cast<long long>(BC) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st_ = static_cast<cudaStream_t>(stream);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* dAp = static_cast<const float*>(dA);
  const auto* Bp = static_cast<const float*>(B);
  const auto* Cp = static_cast<const float*>(C);
  auto* yp = static_cast<float*>(y);
  auto* sp = static_cast<float*>(st);
  if (dtype == 0)
    return launch<float>(x, dtp, dAp, Bp, Cp, yp, sp, BC, Q, H, P, G, N, st_);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtp, dAp, Bp, Cp, yp, sp, BC, Q, H, P, G,
                                 N, st_);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_intra_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
