// Fused per-event kernels for Hopper (sm_90a): policy step + iterate update.
//
// Replace the TPU kernels of repro/kernels/fused_step.py, one launch per
// event for all B cells (one thread block per cell):
//
//   fused_policy_prox_kernel  <- fused_policy_prox_step (pallas_call of
//                                _prox_kernel): PIAG/BCD, prox(x - gamma g)
//   fused_policy_mix_kernel   <- fused_policy_mix_step (_mix_kernel):
//                                FedAsync, x + gamma (xc - x)
//   fused_policy_buff_kernel  <- fused_policy_buff_step (_buff_kernel):
//                                FedBuff, delta += gamma (xc - xw),
//                                x += agg scale delta, delta *= (1 - agg)
//
// Every kernel starts with the reference's _policy_update: the window sum
// from the circular cumulative-sum buffer (delay capped at min(k, H-1),
// overflow counted), gamma from the six policy families, the push of
// S_{k+1} = total + gamma into cumbuf[k % H], k += 1, clipped += flag.  The
// state is updated in place: of the (B, H) buffer only the written slot is
// stored.  Then the block runs the elementwise update over d.
//
// Bound: latency, not bytes.  Per cell an event moves 12 d (prox, mix) or
// 24 d (buff) bytes of vectors plus ~60 bytes of state, a handful of flops
// per element: at the main paths' shapes (96 x 784, 24 x 784) that is
// 0.27 and 0.14 us at the card's memory rate, less than one trip to memory
// and far less than a launch.  A launch costs the launch itself plus the
// chain of dependent memory trips inside it, so the design counts trips.
//
// All three kernels make ONE trip:
//   phase A  every thread starts its loads of the vectors at once (B1 x,
//            g; B2 x, xc; B3 x, xc, xw, delta and agg), as 16-byte float4
//            loads where d % 4 == 0 and every row pointer is 16-byte
//            aligned (the launcher picks the instance), 4-byte loads
//            otherwise.  A
//            thread holds kPer floats of each vector in registers, so one
//            pass holds a row of up to kChunk = 4096; wider rows loop in
//            chunks of load-all, then compute.  Meanwhile thread 0 loads
//            the cell's scalars and the block loads the cell's whole cumbuf
//            row into shared memory where H <= kRowCap (1024 floats, 4 KB):
//            the window slot, whose address depends on k and tau, is then
//            picked on chip with no second trip.  The row costs 4 H more
//            bytes per cell (1 KB at PIAG's H = 256, 256 B at FedBuff's 64;
//            mostly L2 hits, since the previous event wrote the row).
//            Above the cap thread 0 loads the slot once k and tau arrive,
//            still overlapped with the vector loads.
//   phase B  __syncthreads(); thread 0 runs the prologue from registers and
//            shared memory (block_prologue), stores the state and gamma_out
//            and puts gamma in shared memory; __syncthreads().
//   phase C  the elementwise update from registers, 16-byte stores on the
//            float4 path; group_l2 first reduces ||x - gamma g||^2 from the
//            registers through warp shuffles and shared memory.
//            B2's update is the mix x + gamma (xc - x).
// fused_step_floor_kernel is empty: launched with B1's grid and block, it
// times the launch floor the kernels are measured against.
//
// Float contract: every operation is written with an explicit _rn
// intrinsic, so nvcc cannot contract any pair into an FMA the plain
// PyTorch version does not have; the result is then bitwise the plain
// version, which runs each operation as its own rounded op.  Where the
// reference's compiled program does contract (the hinge denominator
// always; the push of a product-form gamma when the policy is a
// compile-time constant, which the caller signals with fma_push; the
// federated mix, delta accumulate and buffered apply always), both
// versions compute fma32 below.  group_l2's norm is a reduction in another
// order (stated envelope); powf in the poly branch may differ from
// torch.pow by an ulp (stated envelope).
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the largest H whose cumbuf row phase A stages in shared memory
constexpr int kRowCap = 1024;
// floats of one vector a thread holds in registers, and the row
// chunk one pass covers
constexpr int kPer = 16;
constexpr int kChunk = kPer * kThreads;

enum ProxKind { kNone = 0, kL1 = 1, kL2 = 2, kElasticNet = 3, kBox = 4,
                kGroupL2 = 5 };

// max(a, 0) with the NaN propagation of torch.clamp / jnp.maximum
__device__ __forceinline__ float max0(float a) {
  return (a > 0.f || a != a) ? a : 0.f;
}

__device__ __forceinline__ float sign(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
}

// a * b + c rounded once to float32: the hardware FMA, correctly rounded as
// the plain PyTorch version's core.stepsize.fma32 is.  The reference's
// compiled program contracts these expressions into an FMA.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
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

// ---- one memory trip (phases A-C of the note above) ----

// The cell's scalars, loaded by thread 0 in phase A.
struct Cell {
  int pid, k, tau, clipped;
  float gp, c0, c1, total;
};

// The window start j = k - min(max(tau, 0), min(k, H - 1)): the event
// needs S_j, which sits in cumbuf[(j - 1) % H] (S_0 = 0).
__device__ __forceinline__ int window_start(const Cell& c, int H) {
  return c.k - min(max(c.tau, 0), min(c.k, H - 1));
}

// Phase A's scalar half and phase B for block b, called once the thread's
// vector loads are under way.  Thread 0 loads the cell's scalars while the
// block stages the cumbuf row in s_row (H <= kRowCap; above it thread 0
// loads the window slot alone).  After a barrier thread 0 runs the
// prologue: the six-way select, the in-place push of S_{k+1} into
// cumbuf[k % H], k += 1 and the clip count, and gamma_out[b].  After a
// second barrier every thread returns gamma.
__device__ __forceinline__ float block_prologue(
    int b, const int* __restrict__ pid, const float* __restrict__ gp,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const int* __restrict__ tau, int* __restrict__ k,
    float* __restrict__ total, float* __restrict__ cumbuf,
    int* __restrict__ clipped, float* __restrict__ gamma_out, int H,
    bool fma_push, float* s_row, float* s_gamma) {
  float* buf = cumbuf + static_cast<size_t>(b) * H;
  Cell c{};
  float s_far = 0.f;
  if (threadIdx.x == 0) {
    c = Cell{pid[b], k[b], tau[b], clipped[b], gp[b], c0[b], c1[b],
             total[b]};
    const int j = window_start(c, H);
    if (H > kRowCap && j > 0) s_far = buf[(j - 1) % H];
  }
  if (H <= kRowCap)
    for (int i = threadIdx.x; i < H; i += kThreads) s_row[i] = buf[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int j = window_start(c, H);
    const float s_j = j <= 0 ? 0.f
        : H <= kRowCap ? s_row[(j - 1) % H] : s_far;
    float new_total;
    const float gamma = select_gamma(c.pid, c.gp, c.c0, c.c1,
                                     __fsub_rn(c.total, s_j), c.tau,
                                     c.total, fma_push, &new_total);
    buf[c.k % H] = new_total;
    total[b] = new_total;
    k[b] = c.k + 1;
    clipped[b] = c.clipped + (c.tau > min(c.k, H - 1) ? 1 : 0);
    gamma_out[b] = gamma;
    *s_gamma = gamma;
  }
  __syncthreads();
  return *s_gamma;
}

// Index in the row of element j (< kPer) of this thread's share of the
// chunk at `base`: with kVec4 the thread holds the chunk's float4 number
// threadIdx.x + (j / 4) kThreads, else its element threadIdx.x + j kThreads
// (neighbouring threads on neighbouring addresses either way).
template <bool kVec4>
__device__ __forceinline__ int elem(int base, int j) {
  return kVec4 ? base + 4 * (threadIdx.x + (j >> 2) * kThreads) + (j & 3)
               : base + threadIdx.x + j * kThreads;
}

// This thread's share of the chunk at `base` of a row of d floats into r
// (0 past the end).  With kVec4, d % 4 == 0 and the row is 16-byte aligned.
template <bool kVec4>
__device__ __forceinline__ void load_chunk(const float* __restrict__ row,
                                           int base, int d,
                                           float (&r)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; j += kVec4 ? 4 : 1) {
    const int i = elem<kVec4>(base, j);
    if constexpr (kVec4) {
      const float4 v = i < d ? *reinterpret_cast<const float4*>(row + i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      r[j] = v.x;
      r[j + 1] = v.y;
      r[j + 2] = v.z;
      r[j + 3] = v.w;
    } else {
      r[j] = i < d ? row[i] : 0.f;
    }
  }
}

template <bool kVec4>
__device__ __forceinline__ void store_chunk(float* __restrict__ row,
                                            int base, int d,
                                            const float (&r)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; j += kVec4 ? 4 : 1) {
    const int i = elem<kVec4>(base, j);
    if (i >= d) continue;
    if constexpr (kVec4)
      *reinterpret_cast<float4*>(row + i) =
          make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
    else
      row[i] = r[j];
  }
}

template <int kKind>
__device__ __forceinline__ float prox_elem(float v, float t, float s,
                                           float p0, float p1) {
  if constexpr (kKind == kL1) return soft(v, t);
  else if constexpr (kKind == kL2) return __fdiv_rn(v, s);
  else if constexpr (kKind == kElasticNet) return __fdiv_rn(soft(v, t), s);
  else if constexpr (kKind == kBox) return fminf(fmaxf(v, p0), p1);
  else return v;
}

// B1's phase C for an elementwise prox: the chunk held in registers, then
// any further chunk of a row wider than kChunk (loaded, then computed).
// t and s are the same for every element of the cell.
template <bool kVec4, int kKind>
__device__ __forceinline__ void prox_rows(
    const float (&xr)[kPer], const float (&gr)[kPer],
    const float* __restrict__ xb, const float* __restrict__ gb,
    float* __restrict__ ob, int d, float gamma, float p0, float p1) {
  const float t = __fmul_rn(gamma, p0);
  const float s = __fadd_rn(1.f, __fmul_rn(gamma, kKind == kL2 ? p0 : p1));
  float o[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    o[j] = prox_elem<kKind>(__fsub_rn(xr[j], __fmul_rn(gamma, gr[j])), t, s,
                            p0, p1);
  store_chunk<kVec4>(ob, 0, d, o);
  for (int base = kChunk; base < d; base += kChunk) {
    float xs[kPer], gs[kPer];
    load_chunk<kVec4>(xb, base, d, xs);
    load_chunk<kVec4>(gb, base, d, gs);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      o[j] = prox_elem<kKind>(__fsub_rn(xs[j], __fmul_rn(gamma, gs[j])), t,
                              s, p0, p1);
    store_chunk<kVec4>(ob, base, d, o);
  }
}

template <bool kVec4>
__device__ __forceinline__ float sumsq_chunk(const float (&xr)[kPer],
                                             const float (&gr)[kPer],
                                             int base, int d, float gamma,
                                             float acc) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (elem<kVec4>(base, j) >= d) continue;
    const float v = __fsub_rn(xr[j], __fmul_rn(gamma, gr[j]));
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  return acc;
}

template <bool kVec4>
__device__ __forceinline__ void scale_chunk(const float (&xr)[kPer],
                                            const float (&gr)[kPer],
                                            float* __restrict__ ob, int base,
                                            int d, float gamma, float scale) {
  float o[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    o[j] = __fmul_rn(scale, __fsub_rn(xr[j], __fmul_rn(gamma, gr[j])));
  store_chunk<kVec4>(ob, base, d, o);
}

// B1's phase C for group_l2: ||x - gamma g||^2 from the registers (and any
// further chunk), reduced through warp shuffles and s_red; then the scaled
// row.
template <bool kVec4>
__device__ __forceinline__ void group_l2_rows(
    const float (&xr)[kPer], const float (&gr)[kPer],
    const float* __restrict__ xb, const float* __restrict__ gb,
    float* __restrict__ ob, int d, float gamma, float p0, float* s_red) {
  float acc = sumsq_chunk<kVec4>(xr, gr, 0, d, gamma, 0.f);
  for (int base = kChunk; base < d; base += kChunk) {
    float xs[kPer], gs[kPer];
    load_chunk<kVec4>(xb, base, d, xs);
    load_chunk<kVec4>(gb, base, d, gs);
    acc = sumsq_chunk<kVec4>(xs, gs, base, d, gamma, acc);
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
  scale_chunk<kVec4>(xr, gr, ob, 0, d, gamma, scale);
  for (int base = kChunk; base < d; base += kChunk) {
    float xs[kPer], gs[kPer];
    load_chunk<kVec4>(xb, base, d, xs);
    load_chunk<kVec4>(gb, base, d, gs);
    scale_chunk<kVec4>(xs, gs, ob, base, d, gamma, scale);
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) fused_policy_prox_kernel(
    const int* __restrict__ pid, const float* __restrict__ gp,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const int* __restrict__ tau, int* __restrict__ k,
    float* __restrict__ total, float* __restrict__ cumbuf,
    int* __restrict__ clipped, const float* __restrict__ x,
    const float* __restrict__ g, float* __restrict__ x_out,
    float* __restrict__ gamma_out, int d, int H, int prox_kind, float p0,
    float p1, int fma_push) {
  __shared__ float s_row[kRowCap];
  __shared__ float s_gamma;
  __shared__ float s_red[kThreads / 32];
  const int b = blockIdx.x;
  const float* xb = x + static_cast<size_t>(b) * d;
  const float* gb = g + static_cast<size_t>(b) * d;
  float* ob = x_out + static_cast<size_t>(b) * d;

  // phase A: the vectors' first chunk into registers ...
  float xr[kPer], gr[kPer];
  load_chunk<kVec4>(xb, 0, d, xr);
  load_chunk<kVec4>(gb, 0, d, gr);
  // ... the cell's scalars and row beside them; phase B
  const float gamma = block_prologue(b, pid, gp, c0, c1, tau, k, total,
                                     cumbuf, clipped, gamma_out, H,
                                     fma_push != 0, s_row, &s_gamma);
  // phase C
  switch (prox_kind) {
    case kL1:
      prox_rows<kVec4, kL1>(xr, gr, xb, gb, ob, d, gamma, p0, p1);
      break;
    case kL2:
      prox_rows<kVec4, kL2>(xr, gr, xb, gb, ob, d, gamma, p0, p1);
      break;
    case kElasticNet:
      prox_rows<kVec4, kElasticNet>(xr, gr, xb, gb, ob, d, gamma, p0, p1);
      break;
    case kBox:
      prox_rows<kVec4, kBox>(xr, gr, xb, gb, ob, d, gamma, p0, p1);
      break;
    case kGroupL2:
      group_l2_rows<kVec4>(xr, gr, xb, gb, ob, d, gamma, p0, s_red);
      break;
    default:
      prox_rows<kVec4, kNone>(xr, gr, xb, gb, ob, d, gamma, p0, p1);
      break;
  }
}

// B2's phase C for one chunk: x + gamma (xc - x), contracted as the
// reference contracts it.
template <bool kVec4>
__device__ __forceinline__ void mix_chunk(const float (&xr)[kPer],
                                          const float (&cr)[kPer],
                                          float* __restrict__ xo, int base,
                                          int d, float gamma) {
  float xn[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    xn[j] = fma32(gamma, __fsub_rn(cr[j], xr[j]), xr[j]);
  store_chunk<kVec4>(xo, base, d, xn);
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) fused_policy_mix_kernel(
    const int* __restrict__ pid, const float* __restrict__ gp,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const int* __restrict__ tau, int* __restrict__ k,
    float* __restrict__ total, float* __restrict__ cumbuf,
    int* __restrict__ clipped, const float* __restrict__ x,
    const float* __restrict__ xc, float* __restrict__ x_out,
    float* __restrict__ gamma_out, int d, int H, int fma_push) {
  __shared__ float s_row[kRowCap];
  __shared__ float s_gamma;
  const int b = blockIdx.x;
  const size_t off = static_cast<size_t>(b) * d;

  // phase A: the two vectors' first chunk ...
  float xr[kPer], cr[kPer];
  load_chunk<kVec4>(x + off, 0, d, xr);
  load_chunk<kVec4>(xc + off, 0, d, cr);
  // ... the cell's scalars and row beside them; phase B
  const float gamma = block_prologue(b, pid, gp, c0, c1, tau, k, total,
                                     cumbuf, clipped, gamma_out, H,
                                     fma_push != 0, s_row, &s_gamma);
  // phase C
  mix_chunk<kVec4>(xr, cr, x_out + off, 0, d, gamma);
  for (int base = kChunk; base < d; base += kChunk) {
    load_chunk<kVec4>(x + off, base, d, xr);
    load_chunk<kVec4>(xc + off, base, d, cr);
    mix_chunk<kVec4>(xr, cr, x_out + off, base, d, gamma);
  }
}

// B3's phase C for one chunk: delta += gamma (xc - xw); x += (agg scale)
// delta; delta *= (1 - agg), the first two contracted as the reference
// contracts them.
template <bool kVec4>
__device__ __forceinline__ void buff_chunk(
    const float (&xr)[kPer], const float (&cr)[kPer],
    const float (&wr)[kPer], const float (&dr)[kPer],
    float* __restrict__ xo, float* __restrict__ dout, int base, int d,
    float gamma, float step, float keep) {
  float xn[kPer], dn[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float acc = fma32(gamma, __fsub_rn(cr[j], wr[j]), dr[j]);
    xn[j] = fma32(step, acc, xr[j]);
    dn[j] = __fmul_rn(keep, acc);
  }
  store_chunk<kVec4>(xo, base, d, xn);
  store_chunk<kVec4>(dout, base, d, dn);
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) fused_policy_buff_kernel(
    const int* __restrict__ pid, const float* __restrict__ gp,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const int* __restrict__ tau, int* __restrict__ k,
    float* __restrict__ total, float* __restrict__ cumbuf,
    int* __restrict__ clipped, const float* __restrict__ agg,
    const float* __restrict__ x, const float* __restrict__ xc,
    const float* __restrict__ xw, const float* __restrict__ delta,
    float* __restrict__ x_out, float* __restrict__ delta_out,
    float* __restrict__ gamma_out, int d, int H, float scale,
    int fma_push) {
  __shared__ float s_row[kRowCap];
  __shared__ float s_gamma;
  const int b = blockIdx.x;
  const size_t off = static_cast<size_t>(b) * d;

  // phase A: the four vectors' first chunk and the aggregation flag ...
  float xr[kPer], cr[kPer], wr[kPer], dr[kPer];
  load_chunk<kVec4>(x + off, 0, d, xr);
  load_chunk<kVec4>(xc + off, 0, d, cr);
  load_chunk<kVec4>(xw + off, 0, d, wr);
  load_chunk<kVec4>(delta + off, 0, d, dr);
  const float a = agg[b];
  // ... the cell's scalars and row beside them; phase B
  const float gamma = block_prologue(b, pid, gp, c0, c1, tau, k, total,
                                     cumbuf, clipped, gamma_out, H,
                                     fma_push != 0, s_row, &s_gamma);
  // phase C
  const float step = __fmul_rn(a, scale);
  const float keep = __fsub_rn(1.f, a);
  buff_chunk<kVec4>(xr, cr, wr, dr, x_out + off, delta_out + off, 0, d,
                    gamma, step, keep);
  for (int base = kChunk; base < d; base += kChunk) {
    load_chunk<kVec4>(x + off, base, d, xr);
    load_chunk<kVec4>(xc + off, base, d, cr);
    load_chunk<kVec4>(xw + off, base, d, wr);
    load_chunk<kVec4>(delta + off, base, d, dr);
    buff_chunk<kVec4>(xr, cr, wr, dr, x_out + off, delta_out + off, base, d,
                      gamma, step, keep);
  }
}

// Empty: launched with B1's grid and block, it times the launch floor.
__global__ void __launch_bounds__(kThreads) fused_step_floor_kernel() {}

// The float4 instance of each kernel takes rows with d % 4 == 0 whose pointers
// are all 16-byte aligned (then every row is).
bool vec4_rows(int d, std::initializer_list<const float*> rows) {
  if (d % 4 != 0) return false;
  for (const float* p : rows)
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  return true;
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
  auto* kernel = vec4_rows(d, {x, g, x_out})
                     ? &fused_policy_prox_kernel<true>
                     : &fused_policy_prox_kernel<false>;
  kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pid, gp, c0, c1, tau, k, total, cumbuf, clipped, x, g, x_out, gamma_out,
      d, H, prox_kind, p0, p1, fma_push);
  return static_cast<int>(cudaGetLastError());
}

// Launch one fused FedAsync event for B cells on `stream`; returns
// cudaGetLastError().  The state is updated in place; gamma_out (B,) and
// x_out (B, d) are written.
int fused_policy_mix_step_launch(const int* pid, const float* gp,
                                 const float* c0, const float* c1,
                                 const int* tau, int* k, float* total,
                                 float* cumbuf, int* clipped, const float* x,
                                 const float* xc, float* x_out,
                                 float* gamma_out, int B, int d, int H,
                                 int fma_push, void* stream) {
  if (B <= 0) return 0;
  auto* kernel = vec4_rows(d, {x, xc, x_out})
                     ? &fused_policy_mix_kernel<true>
                     : &fused_policy_mix_kernel<false>;
  kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pid, gp, c0, c1, tau, k, total, cumbuf, clipped, x, xc, x_out,
      gamma_out, d, H, fma_push);
  return static_cast<int>(cudaGetLastError());
}

// Launch one fused FedBuff event for B cells on `stream`; returns
// cudaGetLastError().  The state is updated in place; gamma_out (B,),
// x_out (B, d) and delta_out (B, d) are written.  scale = eta / |R|,
// already rounded to float32 by the caller.
int fused_policy_buff_step_launch(const int* pid, const float* gp,
                                  const float* c0, const float* c1,
                                  const int* tau, int* k, float* total,
                                  float* cumbuf, int* clipped,
                                  const float* agg, const float* x,
                                  const float* xc, const float* xw,
                                  const float* delta, float* x_out,
                                  float* delta_out, float* gamma_out, int B,
                                  int d, int H, float scale, int fma_push,
                                  void* stream) {
  if (B <= 0) return 0;
  auto* kernel = vec4_rows(d, {x, xc, xw, delta, x_out, delta_out})
                     ? &fused_policy_buff_kernel<true>
                     : &fused_policy_buff_kernel<false>;
  kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pid, gp, c0, c1, tau, k, total, cumbuf, clipped, agg, x, xc, xw, delta,
      x_out, delta_out, gamma_out, d, H, scale, fma_push);
  return static_cast<int>(cudaGetLastError());
}

// Launch the empty kernel with B1's grid (B blocks of kThreads) on
// `stream`; returns cudaGetLastError().  Its time is the launch floor.
int fused_step_floor_launch(int B, void* stream) {
  if (B <= 0) return 0;
  fused_step_floor_kernel<<<B, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
