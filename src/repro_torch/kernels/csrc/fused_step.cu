// Fused PIAG/BCD event for Hopper (sm_90a): policy step + prox update.
//
// Replaces the TPU kernel repro/kernels/fused_step.py:fused_policy_prox_step
// (pallas_call of _prox_kernel, with _policy_update and select_gamma).  One
// launch handles one event for all B cells: one thread block per cell.
//
//   thread 0:  window-sum gather from the circular cumulative-sum buffer
//              (delay capped at min(k, H-1), overflow counted), gamma from
//              the six policy families, push S_{k+1} = total + gamma into
//              cumbuf[k % H], k += 1, clipped += flag; gamma goes to shared
//              memory.  The state is updated in place: of the (B, H) buffer
//              only the read slot and the written slot are touched.
//   the block: x_new = prox(x - gamma * g, gamma) over d; group_l2 first
//              reduces ||x - gamma * g||^2 through shared memory.
//
// Bound: bytes.  Per cell the event moves 12 d bytes of iterate/gradient
// plus ~56 bytes of state, against a handful of flops per element, so the
// kernel is far below the card's ops:byte balance.  The design keeps the
// (B, H) buffer out of the traffic (two slots per cell, not H) and makes a
// single pass over x and g (two for group_l2, the second from L1/L2).
//
// Float contract: every operation is written with an explicit _rn
// intrinsic, so nvcc cannot contract x - gamma * g (or any other pair) into
// an FMA; the result is then bitwise the plain PyTorch version, which runs
// each operation as its own rounded op.  Where the reference's compiled
// program does contract (the hinge denominator always; the push of a
// product-form gamma when the policy is a compile-time constant, which the
// caller signals with fma_push), both versions compute fma32 below.
// group_l2's norm is a reduction in another order (stated envelope); powf in
// the poly branch may differ from torch.pow by an ulp (stated envelope).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum ProxKind { kNone = 0, kL1 = 1, kL2 = 2, kElasticNet = 3, kBox = 4,
                kGroupL2 = 5 };

// max(a, 0) with the NaN propagation of torch.clamp / jnp.maximum
__device__ __forceinline__ float max0(float a) {
  return (a > 0.f || a != a) ? a : 0.f;
}

__device__ __forceinline__ float sign(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
}

// a * b + c rounded as one float32 operation, computed as the plain PyTorch
// version computes it (core.stepsize.fma32): the float32 product is exact in
// double, the double sum rounds once, the result once more to float32.  The
// reference's compiled program contracts these expressions into an FMA.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// The six branches of repro.kernels.fused_step.select_gamma; returns gamma
// and writes the pushed sum S_{k+1} to *new_total: total + gamma, or, with
// fma_push, fma32(a, b, total) for the product families gamma = a * b
// (adaptive1, hinge, poly), as kernels/fused_step.py:select_gamma_total.
__device__ float select_gamma(int pid, float gp, float c0, float c1, float ws,
                              int tau, float total, bool fma_push,
                              float* new_total) {
  const float t = __int2float_rn(tau);
  float gamma;
  switch (pid) {
    case 0:  // fixed family: precomputed constant
      gamma = c0;
      break;
    case 1:  // naive gamma' / (tau + b)
      gamma = __fdiv_rn(gp, __fadd_rn(t, c0));
      break;
    case 2: {  // adaptive1 alpha * max(gamma' - ws, 0)
      const float budget = max0(__fsub_rn(gp, ws));
      gamma = __fmul_rn(c0, budget);
      *new_total = fma_push ? fma32(c0, budget, total) : __fadd_rn(total, gamma);
      return gamma;
    }
    case 3: {  // adaptive2 gamma'/(tau+1) if it fits gamma' - ws, else 0
      const float cand = __fdiv_rn(gp, __fadd_rn(t, 1.f));
      gamma = cand <= __fsub_rn(gp, ws) ? cand : 0.f;
      break;
    }
    case 4: {  // hinge gamma' * (1 or 1 / (a max(t - b, 0) + 1))
      const float s = t <= c1 ? 1.f
          : __fdiv_rn(1.f, fma32(c0, max0(__fsub_rn(t, c1)), 1.f));
      gamma = __fmul_rn(gp, s);
      *new_total = fma_push ? fma32(gp, s, total) : __fadd_rn(total, gamma);
      return gamma;
    }
    default: {  // poly gamma' * (tau + 1)^(-a)
      const float p = powf(__fadd_rn(t, 1.f), -c0);
      gamma = __fmul_rn(gp, p);
      *new_total = fma_push ? fma32(gp, p, total) : __fadd_rn(total, gamma);
      return gamma;
    }
  }
  *new_total = __fadd_rn(total, gamma);
  return gamma;
}

__device__ __forceinline__ float soft(float v, float t) {
  return __fmul_rn(sign(v), max0(__fsub_rn(fabsf(v), t)));
}

__global__ void __launch_bounds__(kThreads) fused_policy_prox_kernel(
    const int* __restrict__ pid, const float* __restrict__ gp,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const int* __restrict__ tau, int* __restrict__ k,
    float* __restrict__ total, float* __restrict__ cumbuf,
    int* __restrict__ clipped, const float* __restrict__ x,
    const float* __restrict__ g, float* __restrict__ x_out,
    float* __restrict__ gamma_out, int d, int H, int prox_kind, float p0,
    float p1, int fma_push) {
  __shared__ float s_gamma;
  __shared__ float s_red[kThreads / 32];
  const int b = blockIdx.x;

  if (threadIdx.x == 0) {
    const int kk = k[b];
    const int tt = tau[b];
    const int cap = min(kk, H - 1);
    const int tc = min(max(tt, 0), cap);
    const int j = kk - tc;  // we need S_j
    float* buf = cumbuf + static_cast<size_t>(b) * H;
    const float tot = total[b];
    const float s_j = j <= 0 ? 0.f : buf[(j - 1) % H];
    float new_total;
    const float gamma = select_gamma(pid[b], gp[b], c0[b], c1[b],
                                     __fsub_rn(tot, s_j), tt, tot,
                                     fma_push != 0, &new_total);
    buf[kk % H] = new_total;
    total[b] = new_total;
    k[b] = kk + 1;
    clipped[b] += tt > cap ? 1 : 0;
    gamma_out[b] = gamma;
    s_gamma = gamma;
  }
  __syncthreads();

  const float gamma = s_gamma;
  const float* xb = x + static_cast<size_t>(b) * d;
  const float* gb = g + static_cast<size_t>(b) * d;
  float* ob = x_out + static_cast<size_t>(b) * d;

  if (prox_kind == kGroupL2) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = __fsub_rn(xb[i], __fmul_rn(gamma, gb[i]));
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) sum = __fadd_rn(sum, s_red[w]);
      const float t = __fmul_rn(gamma, p0);
      const float n = __fsqrt_rn(sum);
      s_red[0] = max0(__fsub_rn(1.f, __fdiv_rn(t, fmaxf(n, 1e-30f))));
    }
    __syncthreads();
    const float scale = s_red[0];
    for (int i = threadIdx.x; i < d; i += kThreads)
      ob[i] = __fmul_rn(scale, __fsub_rn(xb[i], __fmul_rn(gamma, gb[i])));
    return;
  }

  // per-element ops: t and s are the same for every element of the cell
  const float t = __fmul_rn(gamma, p0);
  const float s = __fadd_rn(1.f, __fmul_rn(gamma,
                                           prox_kind == kL2 ? p0 : p1));
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = __fsub_rn(xb[i], __fmul_rn(gamma, gb[i]));
    float out;
    switch (prox_kind) {
      case kL1: out = soft(v, t); break;
      case kL2: out = __fdiv_rn(v, s); break;
      case kElasticNet: out = __fdiv_rn(soft(v, t), s); break;
      case kBox: out = fminf(fmaxf(v, p0), p1); break;
      default: out = v; break;
    }
    ob[i] = out;
  }
}

}  // namespace

extern "C" {

// Launch one fused event for B cells on `stream`; returns cudaGetLastError()
// (0 on success).  State tensors (k, total, cumbuf, clipped) are updated in
// place; gamma_out (B,) and x_out (B, d) are written.
int fused_policy_prox_step_launch(const int* pid, const float* gp,
                                  const float* c0, const float* c1,
                                  const int* tau, int* k, float* total,
                                  float* cumbuf, int* clipped, const float* x,
                                  const float* g, float* x_out,
                                  float* gamma_out, int B, int d, int H,
                                  int prox_kind, float p0, float p1,
                                  int fma_push, void* stream) {
  if (B <= 0) return 0;
  fused_policy_prox_kernel<<<B, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      pid, gp, c0, c1, tau, k, total, cumbuf, clipped, x, g, x_out, gamma_out,
      d, H, prox_kind, p0, p1, fma_push);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
