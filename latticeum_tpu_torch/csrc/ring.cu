// CRT and ICRT of R_q = F_q[X]/(X^24 - X^12 + 1), for sm_90a.
//
// Replace the XLA functions crt (latticeum_tpu/ring/rq.py:61) and icrt
// (:98): the butterfly networks of the reference (ntt.rs:135-319, the
// port's host/ring/ref_impl.py), three butterfly stages and the
// (de)homogenisation of the Fq3 slots.  Both maps are F_q-linear and exact,
// so for canonical input they give the same bits as the dense 24 x 24
// matvec of the plain-torch twins (ring/rq.py crt_twin, icrt_twin).
//
// Layout: (rows, 24) uint64, contiguous, canonical values.  One thread per
// ring element, its 24 values in registers: crt is 48 constant multiplies
// and 85 adds or subtracts, icrt 72 and 85.  A thread's 24 values are 192
// contiguous bytes, so a warp reading them straight would load 32 rows at
// a 192-byte stride; instead the block's rows go through shared memory,
// read and written by consecutive threads at consecutive addresses, each
// row at a stride of 25 words (odd: a half-warp's 8-byte accesses fall
// into 16 different bank pairs).
//
// The constants (ref_impl ROOTS[0..23], KAPPA, EIGHT_INV, FOUR_INV) come as
// a device array that ring/rq.py uploads once per device.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define RING_BLOCK 128
#define ROW_STRIDE 25

namespace {

enum { C_KAPPA = 24, C_EIGHT_INV = 25, C_FOUR_INV = 26, N_CONSTS = 27 };

__device__ __forceinline__ u64 gl_neg(u64 a) { return gl_sub(0ULL, a); }

// a, b <- a + w b, a - w b
__device__ __forceinline__ void bfly(u64 &a, u64 &b, u64 w) {
  const u64 wb = gl_mul(b, w);
  const u64 s = gl_add(a, wb);
  b = gl_sub(a, wb);
  a = s;
}

// a, b <- a + b, w (a - b)
__device__ __forceinline__ void ibfly(u64 &a, u64 &b, u64 w) {
  const u64 s = gl_add(a, b);
  b = gl_mul(gl_sub(a, b), w);
  a = s;
}

// ref_impl.crt: stage 1 splits X^24 - X^12 + 1 at z = ROOTS[4], stages 2
// and 3 halve with ROOTS[2], [10] and [1], [7], [5], [11]; then
// _homogenize.
__device__ __forceinline__ void crt24(u64 (&c)[24], const u64 *R) {
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const u64 a = c[i], b = c[12 + i];
    const u64 zb = gl_mul(b, R[4]);
    c[i] = gl_add(a, zb);
    c[12 + i] = gl_sub(gl_add(a, b), zb);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    bfly(c[i], c[6 + i], R[2]);
    bfly(c[12 + i], c[18 + i], R[10]);
  }
  const int base3[4] = {0, 6, 12, 18}, root3[4] = {1, 7, 5, 11};
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      bfly(c[base3[g] + i], c[base3[g] + 3 + i], R[root3[g]]);
  c[4] = gl_neg(c[4]);
  c[7] = gl_mul(c[7], R[2]);
  c[8] = gl_mul(c[8], R[4]);
  c[10] = gl_mul(c[10], R[6]);
  c[11] = gl_mul(c[11], R[12]);
  const int hb[4] = {12, 15, 18, 21}, h1[4] = {3, 11, 7, 15},
            h2[4] = {1, 5, 3, 7};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const u64 c1 = c[hb[g] + 1];
    c[hb[g] + 1] = gl_mul(c[hb[g] + 2], R[h1[g]]);
    c[hb[g] + 2] = gl_mul(c1, R[h2[g]]);
  }
}

// ref_impl.icrt: _dehomogenize, the inverse stages with ROOTS[23], [17],
// [19], [13], then [22], [14], then the stage-1 inverse with KAPPA,
// EIGHT_INV and FOUR_INV.
__device__ __forceinline__ void icrt24(u64 (&c)[24], const u64 *R) {
  c[4] = gl_neg(c[4]);
  c[7] = gl_mul(c[7], R[22]);
  c[8] = gl_mul(c[8], R[20]);
  c[10] = gl_mul(c[10], R[18]);
  c[11] = gl_mul(c[11], R[12]);
  const int hb[4] = {12, 15, 18, 21}, h1[4] = {23, 19, 21, 17},
            h2[4] = {21, 13, 17, 9};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const u64 c1 = c[hb[g] + 1];
    c[hb[g] + 1] = gl_mul(c[hb[g] + 2], R[h1[g]]);
    c[hb[g] + 2] = gl_mul(c1, R[h2[g]]);
  }
  const int base3[4] = {0, 6, 12, 18}, root3[4] = {23, 17, 19, 13};
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ibfly(c[base3[g] + i], c[base3[g] + 3 + i], R[root3[g]]);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    ibfly(c[i], c[6 + i], R[22]);
    ibfly(c[12 + i], c[18 + i], R[14]);
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const u64 a = c[i], b = c[12 + i];
    const u64 kd = gl_mul(gl_sub(a, b), R[C_KAPPA]);
    c[i] = gl_mul(gl_sub(gl_add(a, b), kd), R[C_EIGHT_INV]);
    c[12 + i] = gl_mul(kd, R[C_FOUR_INV]);
  }
}

}  // namespace

template <bool INVERSE>
__global__ void __launch_bounds__(RING_BLOCK)
    crt_kernel(const u64 *__restrict__ x, u64 *__restrict__ out,
               long long n, const u64 *__restrict__ consts) {
  __shared__ u64 stage[RING_BLOCK * ROW_STRIDE];
  __shared__ u64 R[N_CONSTS];
  const long long row0 = (long long)blockIdx.x * RING_BLOCK;
  const int rows = (int)min((long long)RING_BLOCK, n - row0);
  const int words = rows * 24;
  if (threadIdx.x < N_CONSTS) R[threadIdx.x] = consts[threadIdx.x];
  const u64 *src = x + row0 * 24;
  for (int k = threadIdx.x; k < words; k += RING_BLOCK)
    stage[(k / 24) * ROW_STRIDE + k % 24] = src[k];
  __syncthreads();
  if (threadIdx.x < rows) {
    u64 *row = stage + threadIdx.x * ROW_STRIDE;
    u64 c[24];
#pragma unroll
    for (int i = 0; i < 24; ++i) c[i] = row[i];
    if (INVERSE)
      icrt24(c, R);
    else
      crt24(c, R);
#pragma unroll
    for (int i = 0; i < 24; ++i) row[i] = c[i];
  }
  __syncthreads();
  u64 *dst = out + row0 * 24;
  for (int k = threadIdx.x; k < words; k += RING_BLOCK)
    dst[k] = stage[(k / 24) * ROW_STRIDE + k % 24];
}

extern "C" {

// out (n, 24) <- crt (inverse 0) or icrt (inverse 1) of x (n, 24), n >= 1;
// consts the N_CONSTS constants on the device.  Returns the cudaError_t of
// the launch.
int lt_crt(const u64 *x, u64 *out, long long n, int inverse,
           const u64 *consts, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + RING_BLOCK - 1) / RING_BLOCK);
  if (inverse)
    crt_kernel<true><<<blocks, RING_BLOCK, 0, stream>>>(x, out, n, consts);
  else
    crt_kernel<false><<<blocks, RING_BLOCK, 0, stream>>>(x, out, n, consts);
  return (int)cudaGetLastError();
}

}  // extern "C"
