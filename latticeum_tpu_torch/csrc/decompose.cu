// Balanced base-b digits, their recomposition, and mod-p sums of rows, for
// sm_90a.
//
// Replace three XLA functions of the JAX witness pipelines
// (latticeum_tpu/zkvm/accel_nifs.py build_witness :282, dec_prove's
// batch_fn :499, witness_from_f :829):
//   - balanced_digits: decompose_balanced (latticeum_tpu/ring/decompose.py
//     :49), through gadget_decompose and decompose_vec_into_k_vecs;
//   - digit_recompose: recompose (:77), through gadget_recompose (:106);
//   - row_sums: batch_fn's gl.sum_axis(f[1:], axis=-2) (accel_nifs.py:510,
//     and :350 for commit), the sums of the row-constant Ajtai commits.
// The wrappers and the plain-torch twins are in ring/decompose.py
// (decompose_balanced_twin, recompose_twin) and zkvm/accel_nifs.py
// (row_sums; its twin is field/goldilocks.py sum_axis).
//
// Values are uint64, the bits torch holds in int64.  An element's digits
// (and a recomposition's inputs) sit at
//   base + (e / cols) * row_stride + digit * digit_stride + e % cols
// for element e, so one kernel serves every layout without a copy:
//   digits last              cols 1, row_stride L, digit_stride 1;
//   gadget (n, 24) (n L, 24) cols 24, row_stride 24 L, digit_stride 24;
//   k vectors (K, n, 24)     cols = digit_stride = the elements, row 0.
//
// What bounds them: the bytes.  dec's digits write 15 x 98,815 x 24 words
// (284.6 MB) from 19 MB; its recomposition reads those 284.6 MB and writes
// 56.9 MB; its row sums read 14 x 98,815 x 24 words (265.6 MB).  Their
// arithmetic (a few integer operations a digit, one gl_mul and gl_add a
// digit, one 128-bit add a word) is far under the bytes' time.  So each is
// a plain stream with many threads and loads independent of the arithmetic:
// one thread an element for the digits (each digit's stores coalesced
// across the warp), one an output for the recomposition (its digits loaded
// before the Horner chain), and for the sums many blocks a witness, each
// summing a run of rows into 128-bit sums (a thread's column fixed: the
// block is a multiple of 24 threads), then a second launch adding the
// blocks' partials through a scratch tensor the wrapper allocates for each
// call.  Nothing is kept between launches.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define DG_BLOCK 256
#define RC_UNROLL 8   // digits a recomposition loads at a time
#define RS_BLOCK 384  // 16 x 24: a thread sums one column
#define RS_UNROLL 4   // independent loads in flight a thread

namespace {

constexpr u64 Q_HALF = (P - 1) / 2;

__device__ __forceinline__ u64 gl_neg(u64 a) { return a == 0 ? 0 : P - a; }

// (e / cols, e % cols), in 32 bits where both fit.
__device__ __forceinline__ void split_index(long long e, long long cols,
                                            long long n, long long &row,
                                            long long &col) {
  if (n <= 0xFFFFFFFFLL && cols <= 0xFFFFFFFFLL) {
    const unsigned r = (unsigned)e / (unsigned)cols;
    row = r;
    col = e - (long long)r * cols;
  } else {
    row = e / cols;
    col = e - row * cols;
  }
}

// The twin's arithmetic in signed 64 bits: the magnitude |v| (v's signed
// representative) peeled into num_digits digits r or r - b, the carry of
// one into mag >> log2 b when r > b / 2, the sign flipped with it; what is
// left after the last digit is dropped.
__global__ void __launch_bounds__(DG_BLOCK)
    balanced_digits_kernel(const u64 *__restrict__ x, u64 *__restrict__ out,
                           long long n, long long cols, long long row_stride,
                           long long digit_stride, int log_b,
                           int num_digits) {
  const long long e = (long long)blockIdx.x * DG_BLOCK + threadIdx.x;
  if (e >= n) return;
  const u64 v = x[e];
  const bool is_neg = v > Q_HALF;
  long long mag = (long long)(is_neg ? gl_neg(v) : v);
  long long row, col;
  split_index(e, cols, n, row, col);
  u64 *o = out + row * row_stride + col;
  const long long b = 1LL << log_b, half = b >> 1, mask = b - 1;
  for (int d = 0; d < num_digits; ++d) {
    const long long r = mag & mask;
    const bool big = r > half;
    const u64 dmag = (u64)(big ? b - r : r);
    mag = (mag >> log_b) + (long long)big;
    o[d * digit_stride] = (is_neg != big) ? gl_neg(dmag) : dmag;
  }
}

// Horner from the top digit down: acc = d[L - 1], acc = acc b + d[j]; the
// top digit is taken as it is (L = 1 returns it unchanged, as the twin).
__global__ void __launch_bounds__(DG_BLOCK)
    digit_recompose_kernel(const u64 *__restrict__ d, u64 *__restrict__ out,
                           long long n, long long cols, long long row_stride,
                           long long digit_stride, u64 b, int num_digits) {
  const long long e = (long long)blockIdx.x * DG_BLOCK + threadIdx.x;
  if (e >= n) return;
  long long row, col;
  split_index(e, cols, n, row, col);
  const u64 *p = d + row * row_stride + col;
  u64 acc = 0;
  for (int top = num_digits - 1; top >= 0; top -= RC_UNROLL) {
    u64 v[RC_UNROLL];
#pragma unroll
    for (int i = 0; i < RC_UNROLL; ++i)
      if (top - i >= 0) v[i] = p[(top - i) * digit_stride];
#pragma unroll
    for (int i = 0; i < RC_UNROLL; ++i)
      if (top - i >= 0)
        acc = (top - i == num_digits - 1) ? v[i]
                                          : gl_add(gl_mul(acc, b), v[i]);
  }
  out[e] = acc;
}

// s += a, 64 bits into 192.
__device__ __forceinline__ void add192(U192 &s, u64 a) {
  asm("add.cc.u64 %0, %0, %3;\n\t"
      "addc.cc.u64 %1, %1, 0;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+l"(s.lo), "+l"(s.hi), "+r"(s.top)
      : "l"(a));
}

// s += t, 192 bits.
__device__ __forceinline__ void add192(U192 &s, const U192 &t) {
  asm("add.cc.u64 %0, %0, %3;\n\t"
      "addc.cc.u64 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, %5;"
      : "+l"(s.lo), "+l"(s.hi), "+r"(s.top)
      : "l"(t.lo), "l"(t.hi), "r"(t.top));
}

// The 16 sums of each column of the block (thread t holds column t % 24)
// added by threads 0..23; returns thread t's total (t < 24).
__device__ __forceinline__ U192 block_column_sum(const U192 &s) {
  __shared__ u64 lo[RS_BLOCK], hi[RS_BLOCK];
  __shared__ unsigned top[RS_BLOCK];
  lo[threadIdx.x] = s.lo;
  hi[threadIdx.x] = s.hi;
  top[threadIdx.x] = s.top;
  __syncthreads();
  U192 t{0ULL, 0ULL, 0u};
  if (threadIdx.x < 24)
    for (int k = threadIdx.x; k < RS_BLOCK; k += 24)
      add192(t, U192{lo[k], hi[k], top[k]});
  return t;
}

// Block (g, b) sums rows [g rpg, (g + 1) rpg) of witness b (rows of 24
// words) into partial[b][g][c] = (lo, hi, top).
__global__ void __launch_bounds__(RS_BLOCK)
    row_sums_partial_kernel(const u64 *__restrict__ f,
                            u64 *__restrict__ partial, long long n,
                            long long rows_per_group) {
  const int g = blockIdx.x, groups = gridDim.x, b = blockIdx.y;
  const long long r0 = g * rows_per_group;
  const long long r1 = r0 + rows_per_group < n ? r0 + rows_per_group : n;
  const u64 *base = f + (long long)b * n * 24;
  const long long lo_w = r0 * 24, hi_w = r1 * 24;
  U192 s{0ULL, 0ULL, 0u};
  long long w = lo_w + threadIdx.x;
  for (; w + (RS_UNROLL - 1) * RS_BLOCK < hi_w; w += RS_UNROLL * RS_BLOCK) {
    u64 v[RS_UNROLL];
#pragma unroll
    for (int i = 0; i < RS_UNROLL; ++i) v[i] = base[w + i * RS_BLOCK];
#pragma unroll
    for (int i = 0; i < RS_UNROLL; ++i) add192(s, v[i]);
  }
  for (; w < hi_w; w += RS_BLOCK) add192(s, base[w]);
  const U192 t = block_column_sum(s);
  if (threadIdx.x < 24) {
    u64 *o = partial + (((long long)b * groups + g) * 24 + threadIdx.x) * 3;
    o[0] = t.lo;
    o[1] = t.hi;
    o[2] = t.top;
  }
}

// Block b adds witness b's groups partials and reduces: out[b][c].
__global__ void __launch_bounds__(RS_BLOCK)
    row_sums_final_kernel(const u64 *__restrict__ partial,
                          u64 *__restrict__ out, int groups) {
  const int b = blockIdx.x, c = threadIdx.x % 24;
  const u64 *p = partial + (long long)b * groups * 24 * 3;
  U192 s{0ULL, 0ULL, 0u};
  for (int g = threadIdx.x / 24; g < groups; g += RS_BLOCK / 24) {
    const u64 *q = p + ((long long)g * 24 + c) * 3;
    add192(s, U192{q[0], q[1], (unsigned)q[2]});
  }
  const U192 t = block_column_sum(s);
  if (threadIdx.x < 24) out[b * 24 + threadIdx.x] = reduce192(t);
}

}  // namespace

extern "C" {

// Element e of x (n elements) -> its num_digits balanced digits base
// 2^log_b at out + (e / cols) row_stride + digit digit_stride + e % cols.
int lt_balanced_digits(const u64 *x, u64 *out, long long n, long long cols,
                       long long row_stride, long long digit_stride,
                       int log_b, int num_digits, cudaStream_t stream) {
  if (n < 1 || cols < 1 || log_b < 1 || log_b > 62 || num_digits < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + DG_BLOCK - 1) / DG_BLOCK);
  balanced_digits_kernel<<<grid, DG_BLOCK, 0, stream>>>(
      x, out, n, cols, row_stride, digit_stride, log_b, num_digits);
  return (int)cudaGetLastError();
}

// out[e] (n elements) <- sum_j d_j b^j mod p, digit j of element e at
// d + (e / cols) row_stride + j digit_stride + e % cols, by Horner's rule.
int lt_digit_recompose(const u64 *d, u64 *out, long long n, long long cols,
                       long long row_stride, long long digit_stride,
                       long long b, int num_digits, cudaStream_t stream) {
  if (n < 1 || cols < 1 || b < 2 || num_digits < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + DG_BLOCK - 1) / DG_BLOCK);
  digit_recompose_kernel<<<grid, DG_BLOCK, 0, stream>>>(
      d, out, n, cols, row_stride, digit_stride, (u64)b, num_digits);
  return (int)cudaGetLastError();
}

// out (batch, 24) <- the mod-p sums over the n rows of f (batch, n, 24):
// groups blocks a witness of rows_per_group rows each, their partials in
// partial (batch, groups, 24, 3), then one block a witness adds them.
int lt_row_sums(const u64 *f, u64 *partial, u64 *out, int batch, long long n,
                int groups, long long rows_per_group, cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || n < 1 || groups < 1 ||
      (long long)groups * rows_per_group < n)
    return (int)cudaErrorInvalidValue;
  row_sums_partial_kernel<<<dim3(groups, batch), RS_BLOCK, 0, stream>>>(
      f, partial, n, rows_per_group);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_sums_final_kernel<<<batch, RS_BLOCK, 0, stream>>>(partial, out,
                                                         groups);
  return (int)cudaGetLastError();
}

}  // extern "C"
