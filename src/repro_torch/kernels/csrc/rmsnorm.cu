// Fused RMSNorm over the rows of (rows, D), for Hopper (sm_90a).
//
// Replaces the TPU kernel rmsnorm of repro/kernels/rmsnorm.py (pallas_call at
// :46), exported by repro.kernels.ops as rmsnorm_fused.
//
//   x (rows, D) and scale (D,) both float32 or both bfloat16, contiguous;
//   out (rows, D) in x's dtype.
//   var = sum(x*x) / D            float32, x cast to float32 first
//   r   = 1 / sqrt(var + eps)     correctly rounded sqrt, then division
//   out = (x * r) * scale         float32, scaled BEFORE the one cast to
//                                 out's dtype (the kernel's order; the
//                                 model layer casts first, then scales)
// Every operation is an explicit _rn intrinsic.  rsqrtf is not used: it is
// not correctly rounded, while 1 / sqrt with two IEEE roundings is what the
// plain version computes, so the two differ only in the order of the row
// sum.
//
// Schedule: one block of 256 threads per row, D whole per row (the
// reference keeps the norm axis resident too; D <= 8192 in every config).
// Pass 1 reads the row, each thread summing its strided elements, then a
// warp-shuffle and shared-memory tree; pass 2 reads the row again (at most
// 32 KB, from L1/L2) and writes the output.  Rows go on the grid's x
// dimension, so any row count runs.
//
// Bound: bytes.  The row is read once and written once from device memory
// (2 x 2 bytes an element in bf16), against ~4 float operations an element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int D, float eps) {
  __shared__ float partial[kWarps];
  __shared__ float r_row;
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  const int tid = threadIdx.x;

  float sum = 0.f;
  for (int i = tid; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    sum = __fadd_rn(sum, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if ((tid & 31) == 0) partial[tid >> 5] = sum;
  __syncthreads();
  if (tid < 32) {
    float s = tid < kWarps ? partial[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (tid == 0) {
      const float var = __fdiv_rn(s, static_cast<float>(D));
      r_row = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    }
  }
  __syncthreads();
  const float r = r_row;
  for (int i = tid; i < D; i += kThreads)
    orow[i] = from_f32<T>(
        __fmul_rn(__fmul_rn(to_f32(xr[i]), r), to_f32(scale[i])));
}

template <typename T>
int launch(const void* x, const void* scale, void* out, long long rows,
           int D, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the RMSNorm of `rows` rows of width D on `stream`; dtype (of x,
// scale and out) 0 is float32, 1 is bfloat16.  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a dtype
// without a kernel or more rows than the grid takes.
int rmsnorm_launch(const void* x, const void* scale, void* out,
                   long long rows, int D, int dtype, float eps,
                   void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, out, rows, D, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, out, rows, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
