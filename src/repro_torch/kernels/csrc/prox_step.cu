// Fused proximal update x' = prox_{gamma R}(x - gamma g), for Hopper (sm_90a).
//
// Replaces the TPU kernel prox_step of repro/kernels/prox_step.py (pallas_call
// at :60); prox_step_tree (:75) stays a leafwise loop in the Python wrapper.
//
//   x, g, out: n elements, all float32 or all bfloat16, contiguous;
//   gamma: a float32 scalar read from device memory (gamma_ptr), or passed by
//   value when gamma_ptr is null (a Python float: no copy to the card).
//
// Arithmetic (float32, one rounding to out's dtype at the end), as the
// reference's compiled kernel does it:
//   y    = fma(-gamma, g, x)             x - gamma*g, contracted into one FMA
//   none: y
//   l1:   sign(y) * max(|y| - t, 0)      t = gamma*lam, a float32 product
//   l2:   y / fma(gamma, lam, 1)         IEEE division; 1 + gamma*lam is
//                                        contracted as well
//   box:  clip(y, -lam, lam)
// Every operation is an explicit _rn intrinsic, so nvcc cannot contract or
// reorder anything else.
//
// Schedule: a grid-stride loop over 16-byte vectors (4 float32 or 8 bf16
// elements) when all three pointers are 16-byte aligned, then a scalar loop
// for the tail (or for all n otherwise), so any n from 1 up is exact.
//
// Bound: bytes.  Each element is read twice (x, g) and written once: 12
// bytes in float32, 6 in bf16, against ~5 float operations.  The design
// therefore moves each byte once, in 16-byte accesses, and nothing else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM of the H100

enum Kind { kNone = 0, kL1 = 1, kL2 = 2, kBox = 3 };

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

struct Params {
  float gamma;  // step size
  float t;      // l1 threshold gamma*lam
  float div;    // l2 divisor fma(gamma, lam, 1)
  float lam;    // box bound
};

template <int KIND>
__device__ __forceinline__ float prox(float x, float g, const Params& p) {
  float y = __fmaf_rn(-p.gamma, g, x);
  if (KIND == kL1) {
    const float a = fmaxf(__fsub_rn(fabsf(y), p.t), 0.f);
    // sign(y) * a; y == 0 (or NaN) keeps y * a, as sign(y) * a would
    y = y > 0.f ? a : (y < 0.f ? -a : __fmul_rn(y, a));
  } else if (KIND == kL2) {
    y = __fdiv_rn(y, p.div);
  } else if (KIND == kBox) {
    y = y < -p.lam ? -p.lam : (y > p.lam ? p.lam : y);  // NaN passes
  }
  return y;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    prox_step_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     T* __restrict__ out, long long n,
                     const float* __restrict__ gamma_ptr, float gamma_val,
                     float lam, int vec) {
  Params p;
  p.gamma = gamma_ptr != nullptr ? *gamma_ptr : gamma_val;
  p.t = __fmul_rn(p.gamma, lam);
  p.div = __fmaf_rn(p.gamma, lam, 1.f);
  p.lam = lam;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / kVec;
    const auto* xv = reinterpret_cast<const uint4*>(x);
    const auto* gv = reinterpret_cast<const uint4*>(g);
    auto* ov = reinterpret_cast<uint4*>(out);
    for (long long i = first; i < nv; i += stride) {
      const uint4 xa = xv[i], ga = gv[i];
      const T* xe = reinterpret_cast<const T*>(&xa);
      const T* ge = reinterpret_cast<const T*>(&ga);
      uint4 oa;
      T* oe = reinterpret_cast<T*>(&oa);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        oe[e] = from_f32<T>(prox<KIND>(to_f32(xe[e]), to_f32(ge[e]), p));
      ov[i] = oa;
    }
    done = nv * kVec;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = from_f32<T>(prox<KIND>(to_f32(x[i]), to_f32(g[i]), p));
}

template <typename T>
int launch(const void* x, const void* g, void* out, long long n, int kind,
           const float* gamma_ptr, float gamma, float lam, int vec,
           cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const long long items = vec ? n / kVec + n % kVec : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const T*>(g);
  auto* op = static_cast<T*>(out);
#define PROX_CASE(K)                                                     \
  case K:                                                                \
    prox_step_kernel<T, K><<<blocks, kThreads, 0, stream>>>(             \
        xp, gp, op, n, gamma_ptr, gamma, lam, vec);                      \
    break;
  switch (kind) {
    PROX_CASE(kNone)
    PROX_CASE(kL1)
    PROX_CASE(kL2)
    PROX_CASE(kBox)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROX_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the prox update of n elements on `stream`; dtype 0 is float32, 1 is
// bfloat16; kind 0 none, 1 l1, 2 l2, 3 box; gamma from gamma_ptr (a float32
// on the card) or, when it is null, the value `gamma`.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a dtype or kind without a kernel.
int prox_step_launch(const void* x, const void* g, void* out, long long n,
                     int dtype, int kind, const void* gamma_ptr, float gamma,
                     float lam, void* stream) {
  if (n <= 0) return 0;
  // the 16-byte vector path needs all three pointers 16-byte aligned
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(g) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto* gptr = static_cast<const float*>(gamma_ptr);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, out, n, kind, gptr, gamma, lam, vec, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, out, n, kind, gptr, gamma, lam, vec,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* prox_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
