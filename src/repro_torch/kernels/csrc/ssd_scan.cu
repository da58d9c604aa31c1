// Mamba2 SSD intra-chunk compute on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel ssd_intra_chunk of repro/kernels/ssd_scan.py:50
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
// Bound, at float32 accuracy: the bytes (x, dt, dA, B, C read once, y and
// the state written once) over 3.35 TB/s, or the products on the tensor
// cores in split TF32 over 495 TFLOP/s, whichever is larger.  Split TF32
// (below) takes three TF32 products for a float32 product, two where one
// operand is exact in TF32 (a bfloat16 x): C.B^T once per (chunk, group)
// at three, W.x and the state product per cell at two (bf16 x) or three.
// At mamba2-780m's layer on 8192 tokens (BC 32, Q 256, H 48, P 64, G 1,
// N 128, bf16 x) that is 26.6 GFLOP, 53.8 us, under the 63.5 us of its
// 212.9 MB: the bytes bound it.
//
// Split TF32.  A TF32 operand keeps 10 of float32's 23 mantissa bits; one
// TF32 product per float32 one misses the 1e-5 envelope by ~50x.  Each
// float32 operand a is split into hi = tf32(a) and lo = tf32(a - hi)
// (cvt.rna.tf32.f32; a - hi is exact), and a.b is computed as
// lo.hi + hi.lo + hi.hi on the tensor cores with float32 accumulation; the
// dropped lo.lo and lo's own rounding are ~2^-21 of the product, inside
// the envelope.  A bfloat16 x is exact in TF32 (7 mantissa bits), so its
// lo is 0 and W.x and the state product take two products.  W is split
// after it is rounded to float32, the value the plain version multiplies.
// exp is expf (not __expf).
//
// Design, against the four causes that held the first (SIMT) design at
// 13x its bound:
//   1. C.B^T once per group, not per head.  B and C are per group (G 1
//      over H 48 at mamba2-780m).  A y block owns (chunk, 64 rows t,
//      group, a slice of hs heads of the group): it computes the causal
//      strip C.B^T[t, 0 .. last row] once into shared memory (64 x up to
//      256 floats, 65 KB), then walks its heads, forming each head's W
//      from the strip.  hs is the largest divisor of H / G up to 8 that
//      still gives about six blocks per SM (the launcher's choice, by
//      shape alone); at the layer above hs = 8, so C.B^T is computed 6
//      times per chunk instead of 48.  Q above 256 keeps one head a block
//      and computes the strip in windows of 256 columns, each window's
//      share of y added to the last in device memory.
//   2. Operands from registers.  mma.sync m16n8k8 tf32: each warp owns 16
//      rows; W (or (B w2)^T) is formed straight into the A fragment's
//      registers, x is read from shared memory into the B fragment, the
//      sum stays in registers (P / 2 floats a thread; a float32 x past P
//      64 runs in two column passes, as 64 sums and three products a
//      column tile spill).
//   3. The prefix sum of dA no longer holds the block: it runs once per
//      block for all hs heads at once, one thread a head, from a staged
//      copy, before the strip.  Each head's sum is in order, the plain
//      version's order (torch.cumsum along Q runs sequentially on the
//      card): at |cums| ~ 200 (Q 256) any other order moves
//      exp(cums[t] - cums[s]) by ~1e-5 and y past the 1e-5 envelope (a
//      warp-shuffle scan measured 2.3e-5 of max|y|).
//   4. Tensor cores, in split TF32 as above.
// Tiles: x (and B for the state) are staged in 64-row tiles with cp.async,
// double-buffered, so the next tile loads under the current one's
// products (16-byte copies where rows are 16-byte aligned, else element
// copies); the strip's C and B are staged in 64 x 32 chunks the same way.
// State blocks, (chunk, group, 64 rows n, hs heads), walk every s tile
// with (B w2)^T as A.  One launch covers the call; the grid's first row
// holds the state blocks and the y blocks of the last rows (the longest),
// so the longest blocks start first.
// Shared memory at the layer above: the strip 65 KB, the staging 36 KB,
// the cumulative sums of 8 heads and one head's dt 9 KB: 110 KB, two
// blocks an SM.
#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;         // rows t (or n) of a block; s of a tile
constexpr int kKc = 32;           // n of one staged C / B chunk (strip)
constexpr int kLdK = kKc + 4;     // its row stride (conflict-free reads)
constexpr int kLdN = kTile + 8;   // row stride of a staged B tile (state)
constexpr int kMaxWin = 256;      // widest strip a block keeps (columns)
constexpr int kMaxHeads = 8;      // most heads of a group a block walks
constexpr int kFill = 6;          // blocks per SM the head slices aim for
constexpr int kMaxP = 128;

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// hi = tf32(a), lo = tf32(a - hi)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(__fsub_rn(a, __uint_as_float(hi)));
}

// d += a . b, one m16n8k8 TF32 product with float32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in split TF32 where a is split into (ah, al) and b into
// (bh, bl): lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Rows [0, 64) x elements [0, cols) of a strided source into shared memory
// (row stride ld), zero where row >= nrows or element >= ncols.  With vec
// every row start is 16-byte aligned and ncols a whole number of 16-byte
// chunks: cp.async of 16 bytes (zero-filled past the edge); else element
// copies.  cols * sizeof(T) is a multiple of 16.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      size_t stride, int cols, int nrows,
                                      int ncols, bool vec) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    const int cpr = cols / per;
    for (int e = threadIdx.x; e < kTile * cpr; e += kThreads) {
      const int r = e / cpr, c = (e - r * cpr) * per;
      const bool full = r < nrows && c < ncols;
      cp16(dst + r * ld + c, full ? src + r * stride + c : src, full);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * ld + c] =
          r < nrows && c < ncols ? src[r * stride + c] : zero<T>();
    }
  }
  cp_commit();
}

// Row stride (elements) of a staged x tile of kPw columns: a whole number
// of 16-byte chunks, 8 banks past a multiple of 32 (conflict-free B
// fragments).
template <typename TX>
__host__ __device__ constexpr int ld_x(int kPw) {
  const int words = kPw * static_cast<int>(sizeof(TX)) / 4;
  return (words + ((8 - words % 32) + 32) % 32) * 4 /
         static_cast<int>(sizeof(TX));
}

// The B fragment value (as a float) of x element i of a staged tile.
__device__ __forceinline__ float xval(const float* s, int i) { return s[i]; }
__device__ __forceinline__ float xval(const __nv_bfloat16* s, int i) {
  return __bfloat162float(s[i]);
}

// One k-step of 8 of the C.B^T strip over a 64 x 32 chunk of C (rows t)
// and of B (rows s): cb (16 rows x 64 columns of the warp) += C . B^T, in
// split TF32.  In the chunk on the diagonal (kDiag) the column tiles past
// the warp's last row are skipped.
template <bool kDiag>
__device__ __forceinline__ void strip_step(float (&cb)[8][4],
                                           const float* sC, const float* sB,
                                           int kk, int row_a, int g, int q,
                                           int s0, int last_row) {
  uint32_t ah[4], al[4];
  split(sC[row_a * kLdK + kk + q], ah[0], al[0]);
  split(sC[(row_a + 8) * kLdK + kk + q], ah[1], al[1]);
  split(sC[row_a * kLdK + kk + q + 4], ah[2], al[2]);
  split(sC[(row_a + 8) * kLdK + kk + q + 4], ah[3], al[3]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (kDiag && s0 + 8 * nt > last_row) continue;
    mma3(cb[nt], ah, al, sB[(8 * nt + g) * kLdK + kk + q],
         sB[(8 * nt + g) * kLdK + kk + q + 4]);
  }
}

// acc (16 rows x kNT column tiles) += A . x for k-step ks of a staged x
// tile, A's fragment given as floats: split TF32, two products where x is
// bfloat16 (exact in TF32), three where it is float32.
template <typename TX, int kNT>
__device__ __forceinline__ void mma_x(float (&acc)[kNT][4],
                                      const float (&a)[4], const TX* sX,
                                      int ks, int g, int q) {
  constexpr int kLdX = ld_x<TX>(8 * kNT);
  uint32_t ah[4], al[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
  const TX* x0 = sX + (ks + q) * kLdX + g;
  const TX* x1 = x0 + 4 * kLdX;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float b0 = xval(x0, 8 * nt), b1 = xval(x1, 8 * nt);
    if constexpr (sizeof(TX) == 2) {
      mma(acc[nt], al, __float_as_uint(b0), __float_as_uint(b1));
      mma(acc[nt], ah, __float_as_uint(b0), __float_as_uint(b1));
    } else {
      mma3(acc[nt], ah, al, b0, b1);
    }
  }
}

// W[t, s] = ((C.B^T)[t, s] * exp(cums[t] - cums[s])) * dt[s]
__device__ __forceinline__ float w_elem(float cb, float ct, float cs,
                                        float d) {
  return __fmul_rn(__fmul_rn(cb, expf(__fsub_rn(ct, cs))), d);
}

// acc += W . x over one staged x tile of a y block.  Rows t of the
// fragment: ta, ta + 8 (strip rows sa, sb, indexed by s); columns s of
// k-step ks: s0 + ks + q, + 4.  kMasked (the tile on the diagonal): W = 0
// where s > t or t >= Q, the mask applied before exp, and k-steps past the
// warp's last row or the window skipped.  Off the diagonal every s < t.
template <bool kMasked, typename TX, int kNT>
__device__ __forceinline__ void y_tile_mma(
    float (&acc)[kNT][4], const TX* sX, const float* sa, const float* sb,
    const float* cums, const float* dts, int s0, float ct_a, float ct_b,
    int ta, int Q, int s_stop, int g, int q) {
  const int tb = ta + 8;
#pragma unroll
  for (int ks = 0; ks < kTile; ks += 8) {
    const int lo = s0 + ks + q, hi = lo + 4;
    float a[4];
    if constexpr (kMasked) {
      if (s0 + ks >= s_stop) break;
      a[0] = lo <= ta && ta < Q ? w_elem(sa[lo], ct_a, cums[lo], dts[lo])
                                : 0.f;
      a[1] = lo <= tb && tb < Q ? w_elem(sb[lo], ct_b, cums[lo], dts[lo])
                                : 0.f;
      a[2] = hi <= ta && ta < Q ? w_elem(sa[hi], ct_a, cums[hi], dts[hi])
                                : 0.f;
      a[3] = hi <= tb && tb < Q ? w_elem(sb[hi], ct_b, cums[hi], dts[hi])
                                : 0.f;
    } else {
      a[0] = w_elem(sa[lo], ct_a, cums[lo], dts[lo]);
      a[1] = w_elem(sb[lo], ct_b, cums[lo], dts[lo]);
      a[2] = w_elem(sa[hi], ct_a, cums[hi], dts[hi]);
      a[3] = w_elem(sb[hi], ct_b, cums[hi], dts[hi]);
    }
    mma_x<TX, kNT>(acc, a, sX, ks, g, q);
  }
}

// acc += (B w2)^T . x over one staged x tile of a state block: rows n of
// the fragment row_a, row_a + 8 of the staged B tile sB (s by n), w2 from
// w2s (0 past Q; B past Q and N is zero-filled).
template <typename TX, int kNT>
__device__ __forceinline__ void state_tile_mma(float (&acc)[kNT][4],
                                               const TX* sX, const float* sB,
                                               const float* w2s, int s0,
                                               int row_a, int g, int q) {
#pragma unroll
  for (int ks = 0; ks < kTile; ks += 8) {
    const float w_lo = w2s[s0 + ks + q], w_hi = w2s[s0 + ks + q + 4];
    float a[4];
    a[0] = __fmul_rn(sB[(ks + q) * kLdN + row_a], w_lo);
    a[1] = __fmul_rn(sB[(ks + q) * kLdN + row_a + 8], w_lo);
    a[2] = __fmul_rn(sB[(ks + q + 4) * kLdN + row_a], w_hi);
    a[3] = __fmul_rn(sB[(ks + q + 4) * kLdN + row_a + 8], w_hi);
    mma_x<TX, kNT>(acc, a, sX, ks, g, q);
  }
}

struct Shape {
  int Q, H, P, G, N, hs, win, passes;
};

template <typename TX, int kNT>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_intra_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ dA,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ st, Shape sh, int vec_x,
                     int vec_bc) {
  constexpr int kPw = 8 * kNT;             // P padded to the mma width
  constexpr int kLdX = ld_x<TX>(kPw);
  const int Q = sh.Q, H = sh.H, P = sh.P, G = sh.G, N = sh.N;
  const int hs = sh.hs, win = sh.win, passes = sh.passes;
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  const int ldS = win + 4;                 // strip row stride

  extern __shared__ __align__(16) float smem[];
  float* cums_all = smem;                  // hs x Qp: cumulative dA
  float* dts = cums_all + hs * Qp;         // Qp: dt (y) or w2 (state)
  float* r1 = dts + Qp;                    // the strip, or 2 B tiles
  const int r1_floats = max(kTile * ldS, 2 * kTile * kLdN);
  void* r2 = r1 + r1_floats;               // 2 x tiles, or strip chunks

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row_a = 16 * warp + g, row_b = row_a + 8;  // fragment rows

  const int rep = H / G;
  const int n_slices = rep / hs;
  const int slice = static_cast<int>(blockIdx.x % n_slices);
  const int grp = static_cast<int>(blockIdx.x / n_slices % G);
  const size_t bc = blockIdx.x / n_slices / G;
  const int h0 = grp * rep + slice * hs;
  const int nN = (N + kTile - 1) / kTile, nT = Qp / kTile;
  const bool y_tile = static_cast<int>(blockIdx.y) >= nN;
  const int r0 =
      (y_tile ? nT - 1 - (static_cast<int>(blockIdx.y) - nN)
              : static_cast<int>(blockIdx.y)) * kTile;
  const int s_end = y_tile ? min(r0 + kTile, Q) : Q;
  const int last_row = r0 + 16 * warp + 15;  // the warp's last row t
  const int n_win = y_tile ? (s_end + win - 1) / win : 1;

  TX* xbuf = static_cast<TX*>(r2);
  float* acc_strip = r1;

  // the cumulative sums of dA of the slice's heads, each in order (the
  // plain version's order: torch.cumsum along Q runs sequentially), the
  // hs heads side by side on hs threads
  for (int e = threadIdx.x; e < Q * hs; e += kThreads) {
    const int s = e / hs, hh = e - s * hs;
    cums_all[hh * Qp + s] = dA[(bc * Q + s) * H + h0 + hh];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < hs) {
    float* v = cums_all + threadIdx.x * Qp;
    float run = v[0];
#pragma unroll 8
    for (int s = 1; s < Q; ++s) {
      run = __fadd_rn(run, v[s]);
      v[s] = run;
    }
  }

  float ct_a = 0.f, ct_b = 0.f;  // cums of the warp's fragment rows
  const float* cums = cums_all;

  for (int w = 0; w < n_win; ++w) {
    const int c0 = w * win;
    const int c1 = y_tile ? min(c0 + win, s_end) : Q;
    if (y_tile) {
      // ---- the strip C.B^T[r0 .. r0 + 63, c0 .. c1), split TF32 ----
      float* sbuf = static_cast<float*>(r2);
      const int nK = (N + kKc - 1) / kKc;
      const int steps = (c1 - c0 + kTile - 1) / kTile * nK;
      const float* c_rows = Cm + ((bc * Q + r0) * G + grp) * N;
      auto issue = [&](int i) {
        const int sc = i / nK, n_lo = (i - sc * nK) * kKc;
        const int s0 = c0 + sc * kTile;
        float* dC = sbuf + (i & 1) * 2 * kTile * kLdK;
        stage<float>(dC, kLdK, c_rows + n_lo, static_cast<size_t>(G) * N,
                     kKc, Q - r0, N - n_lo, vec_bc);
        stage<float>(dC + kTile * kLdK, kLdK,
                     Bm + ((bc * Q + s0) * G + grp) * N + n_lo,
                     static_cast<size_t>(G) * N, kKc, Q - s0, N - n_lo,
                     vec_bc);
      };
      float cb[8][4];
      __syncthreads();  // the sums are done; staging and strip are free
      issue(0);
      for (int i = 0; i < steps; ++i) {
        const int sc = i / nK, kc = i - sc * nK;
        const int s0 = c0 + sc * kTile;
        cp_wait_all();
        __syncthreads();
        if (i + 1 < steps) issue(i + 1);
        if (kc == 0) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) cb[nt][e] = 0.f;
        }
        const float* sC = sbuf + (i & 1) * 2 * kTile * kLdK;
        const float* sB = sC + kTile * kLdK;
        if (s0 + kTile > r0) {  // the chunk on the diagonal
#pragma unroll
          for (int kk = 0; kk < kKc; kk += 8)
            strip_step<true>(cb, sC, sB, kk, row_a, g, q, s0, last_row);
        } else {
#pragma unroll
          for (int kk = 0; kk < kKc; kk += 8)
            strip_step<false>(cb, sC, sB, kk, row_a, g, q, s0, last_row);
        }
        if (kc == nK - 1) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = s0 - c0 + 8 * nt + 2 * q;
            acc_strip[row_a * ldS + col] = cb[nt][0];
            acc_strip[row_a * ldS + col + 1] = cb[nt][1];
            acc_strip[row_b * ldS + col] = cb[nt][2];
            acc_strip[row_b * ldS + col + 1] = cb[nt][3];
          }
        }
      }
    }

    // ---- each head of the slice: y rows (or state rows) from the tiles ----
    // tiles in the order (column pass, head, s tile)
    const int n_j = (c1 - c0 + kTile - 1) / kTile;
    const int n_it = passes * hs * n_j;
    auto issue_x = [&](int it) {
      const int vh = it / n_j, s0 = c0 + (it - vh * n_j) * kTile;
      const int p0 = vh / hs * kPw, hh = vh % hs;
      stage<TX>(xbuf + (it & 1) * kTile * kLdX, kLdX,
                x + ((bc * Q + s0) * H + h0 + hh) * P + p0,
                static_cast<size_t>(H) * P, kPw, Q - s0, P - p0, vec_x);
      if (!y_tile)
        stage<float>(r1 + (it & 1) * kTile * kLdN, kLdN,
                     Bm + ((bc * Q + s0) * G + grp) * N + r0,
                     static_cast<size_t>(G) * N, kTile, Q - s0, N - r0,
                     vec_bc);
    };
    __syncthreads();  // the sums and the strip are done; staging is free
    issue_x(0);
    float acc[kNT][4];
    for (int it = 0; it < n_it; ++it) {
      const int vh = it / n_j, j = it - vh * n_j;
      const int p0 = vh / hs * kPw, hh = vh % hs;
      const int h = h0 + hh;
      if (j == 0 && w == 0) {
        // this head's dt (or w2)
        __syncthreads();  // the previous head is done with dts
        cums = cums_all + hh * Qp;
        const float last = cums[Q - 1];
        for (int s = threadIdx.x; s < Qp; s += kThreads) {
          const float d = s < Q ? dt[(bc * Q + s) * H + h] : 0.f;
          dts[s] = y_tile || s >= Q
              ? d : __fmul_rn(expf(__fsub_rn(last, cums[s])), d);
        }
        ct_a = cums[min(r0 + row_a, Q - 1)];
        ct_b = cums[min(r0 + row_b, Q - 1)];
      }
      if (j == 0) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
      cp_wait_all();
      __syncthreads();
      if (it + 1 < n_it) issue_x(it + 1);

      const TX* sX = xbuf + (it & 1) * kTile * kLdX;
      const int s0 = c0 + j * kTile;
      if (y_tile) {
        const float* sa = acc_strip + row_a * ldS - c0;
        const float* sb = sa + 8 * ldS;
        if (s0 + kTile <= r0)
          y_tile_mma<false>(acc, sX, sa, sb, cums, dts, s0, ct_a, ct_b,
                            r0 + row_a, Q, c1, g, q);
        else
          y_tile_mma<true>(acc, sX, sa, sb, cums, dts, s0, ct_a, ct_b,
                           r0 + row_a, Q, min(last_row + 1, c1), g, q);
      } else {
        state_tile_mma<TX, kNT>(acc, sX, r1 + (it & 1) * kTile * kLdN, dts,
                                s0, row_a, g, q);
      }

      if (j == n_j - 1) {
        // c0, c1 of fragment row row_a, c2, c3 of row_b, columns 2q, 2q + 1;
        // a later window of the strip (one head a block) adds its share
        const int limit = y_tile ? Q : N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + (half ? row_b : row_a);
          if (r >= limit) continue;
          float* dst = y_tile ? y + ((bc * Q + r) * H + h) * P
                              : st + ((bc * H + h) * N + r) * P;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int p = p0 + 8 * nt + 2 * q;
            float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
            if ((P & 1) == 0 && p < P) {
              float2* d2 = reinterpret_cast<float2*>(dst + p);
              if (w > 0) {
                const float2 o = *d2;
                v0 = __fadd_rn(o.x, v0);
                v1 = __fadd_rn(o.y, v1);
              }
              *d2 = make_float2(v0, v1);
            } else {
              if (p < P) dst[p] = w > 0 ? __fadd_rn(dst[p], v0) : v0;
              if (p + 1 < P)
                dst[p + 1] = w > 0 ? __fadd_rn(dst[p + 1], v1) : v1;
            }
          }
        }
      }
    }
  }
}

// Shared memory of one block (bytes).
template <typename TX, int kNT>
size_t smem_bytes(int Q, int hs, int win) {
  const size_t Qp = (Q + kTile - 1) / kTile * kTile;
  const size_t r1 = std::max<size_t>(static_cast<size_t>(kTile) * (win + 4),
                                     2 * kTile * kLdN);
  const size_t r2 = std::max<size_t>(
      2 * kTile * ld_x<TX>(8 * kNT) * sizeof(TX),
      2 * 2 * kTile * kLdK * sizeof(float));
  return sizeof(float) * ((hs + 1) * Qp + r1) + r2;
}

// Heads of a group per block: the largest divisor of H / G up to
// kMaxHeads whose grid still gives kFill blocks per SM; 1 if none does,
// or where Q needs more than one strip window.
int heads_per_block(int BC, int Q, int H, int G, int N, int sms) {
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  if (Qp > kMaxWin) return 1;
  const int rep = H / G;
  const long long tiles = (N + kTile - 1) / kTile + Qp / kTile;
  for (int hs = std::min(rep, kMaxHeads); hs > 1; --hs)
    if (rep % hs == 0 &&
        static_cast<long long>(BC) * G * (rep / hs) * tiles >=
            static_cast<long long>(kFill) * sms)
      return hs;
  return 1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename TX, int kNT>
int launch_p(const void* x, const float* dt, const float* dA, const float* B,
             const float* C, float* y, float* st, int BC, int Q, int H,
             int P, int G, int N, cudaStream_t stream) {
  constexpr int kPw = 8 * kNT;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  const Shape sh{Q, H, P, G, N, heads_per_block(BC, Q, H, G, N, sms),
                 std::min(Qp, kMaxWin), (P + kPw - 1) / kPw};
  const size_t smem = smem_bytes<TX, kNT>(Q, sh.hs, sh.win);
  err = cudaFuncSetAttribute(ssd_intra_kernel<TX, kNT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks_x =
      static_cast<long long>(BC) * G * ((H / G) / sh.hs);
  if (blocks_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  (N + kTile - 1) / kTile + Qp / kTile);
  const int vec_x = (P * static_cast<int>(sizeof(TX))) % 16 == 0 &&
                    aligned16(x);
  const int vec_bc = N % 4 == 0 && aligned16(B) && aligned16(C);
  ssd_intra_kernel<TX, kNT><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), dt, dA, B, C, y, st, sh, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

// The instance by P: column tiles of 8 up to 16 (P 128) for a bfloat16 x;
// a float32 x keeps at most 8 (P 64), and wider P runs in two column
// passes (64 accumulators and three products a column tile spill).
template <typename TX>
int launch(const void* x, const float* dt, const float* dA, const float* B,
           const float* C, float* y, float* st, int BC, int Q, int H, int P,
           int G, int N, cudaStream_t stream) {
  if (P <= 8)
    return launch_p<TX, 1>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N, stream);
  if (P <= 32)
    return launch_p<TX, 4>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N, stream);
  if constexpr (sizeof(TX) == 2)
    if (P > 64)
      return launch_p<TX, 16>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N,
                              stream);
  return launch_p<TX, 8>(x, dt, dA, B, C, y, st, BC, Q, H, P, G, N, stream);
}

}  // namespace

extern "C" {

// Launch the intra-chunk SSD of BC x H cells on `stream`; dtype 0 is float32
// x, 1 is bfloat16 x (dt, dA, B, C, y and st are float32).  Needs P <= 128
// and H a multiple of G.  Returns cudaGetLastError() after the launch (0 on
// success), the attribute call's error when Q needs more shared memory than
// a block has, or cudaErrorInvalidValue for shapes without a kernel.
int ssd_intra_chunk_launch(const void* x, const void* dt, const void* dA,
                           const void* B, const void* C, void* y, void* st,
                           int BC, int Q, int H, int P, int G, int N,
                           int dtype, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0) return 0;
  if (P <= 0 || P > kMaxP || N <= 0 || G <= 0 || H % G != 0 ||
      (N + kTile - 1) / kTile + (Q + kTile - 1) / kTile > 65535)
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
