// Ring multiply-accumulate of NTT-form rings, for sm_90a.
//
// Replaces two XLA functions of the JAX main path
// (latticeum_tpu/zkvm/accel_nifs.py):
//   - fold_prove's f0_fn (:796): f0[r] = sum_i rho_i * f_i[r] over the
//     2K witnesses f_i (nf rings each) and their ring challenges rho_i,
//     slot-wise Fq3 products summed over i (the sum mode);
//   - dec_prove's batch_fn (:499), row-constant commits and y0
//     (:508-517): cm_k[r] = tot_k * rows[r] (the product mode, one output
//     a term) and y0 = cm - sum_k b^k cm_k (the sum mode with a base).
// The wrappers and the plain-torch twins are in ring/rq.py (ring_mac,
// ring_mul_each).
//
// Layout: rings (rows, 24) uint64, slot s at [3s, 3s + 3), canonical.  One
// thread a (row, slot): its three words are contiguous, so a warp reads 768
// contiguous bytes of a term.  The constants c (n, 24) go into shared
// memory once a block, with w c1 and w c2 (w = 2^40) beside them, up to
// RM_TERMS terms at a time.
//
// What bounds it: the bytes.  f0 reads 2K = 30 terms of 98,815 rings (569
// MB) and writes 19 MB; its products are 9 64x64 -> 128-bit multiply-adds
// a term and slot (fq3_mac_w, unreduced into 192-bit sums, one reduction
// an output), well under the bytes' time.  So the design is a plain
// stream: many threads (790,520 for f0), every term's three loads
// independent of the sums, the term loop unrolled so several terms' loads
// are in flight.  The terms come from one or two base pointers (the two
// dec batches where they lie, not a concatenated copy).

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define RM_BLOCK 256
#define RM_TERMS 64  // constants in shared memory at a time

namespace {

// SUM: out[r] = base[r] - sum_i c_i x_i[r] (base null: the sum itself),
// term i at xa + i x_step for i < n_a, else xb + (i - n_a) x_step.  Else
// out[i][r] = c_i x[r] (x = xa, one term read for every i).
template <bool SUM>
__global__ void __launch_bounds__(RM_BLOCK)
    ring_mac_kernel(const u64 *__restrict__ xa, const u64 *__restrict__ xb,
                    int n_a, long long x_step, const u64 *__restrict__ c,
                    int n, const u64 *__restrict__ base,
                    u64 *__restrict__ out, long long rows) {
  __shared__ u64 cs[RM_TERMS * 8 * 5];  // (term, slot): c0 c1 c2 wc1 wc2
  const long long g = (long long)blockIdx.x * RM_BLOCK + threadIdx.x;
  const bool live = g < rows * 8;
  const int s = (int)(g & 7);
  U192 acc[3];
  zero192(acc);
  Fq3 x{0ULL, 0ULL, 0ULL};
  if (!SUM && live) x = Fq3{xa[3 * g], xa[3 * g + 1], xa[3 * g + 2]};
  for (int i0 = 0; i0 < n; i0 += RM_TERMS) {
    const int m = n - i0 < RM_TERMS ? n - i0 : RM_TERMS;
    __syncthreads();
    for (int k = threadIdx.x; k < m * 8; k += RM_BLOCK) {
      const u64 *ck = c + 3 * (8LL * i0 + k);
      cs[5 * k] = ck[0];
      cs[5 * k + 1] = ck[1];
      cs[5 * k + 2] = ck[2];
      cs[5 * k + 3] = gl_mul_w(ck[1]);
      cs[5 * k + 4] = gl_mul_w(ck[2]);
    }
    __syncthreads();
    if (!live) continue;
    if (SUM) {
#pragma unroll 6
      for (int k = 0; k < m; ++k) {
        const int i = i0 + k;
        const u64 *xi = (i < n_a ? xa + i * x_step : xb + (i - n_a) * x_step)
                        + 3 * g;
        const u64 *cw = cs + 5 * (8 * k + s);
        fq3_mac_w(acc, cw[0], cw[1], cw[2], cw[3], cw[4],
                  Fq3{xi[0], xi[1], xi[2]});
      }
    } else {
      for (int k = 0; k < m; ++k) {
        const u64 *cw = cs + 5 * (8 * k + s);
        U192 p[3];
        zero192(p);
        fq3_mac_w(p, cw[0], cw[1], cw[2], cw[3], cw[4], x);
        const Fq3 v = reduce3(p);
        u64 *o = out + ((i0 + k) * rows * 8 + g) * 3;
        o[0] = v.c0;
        o[1] = v.c1;
        o[2] = v.c2;
      }
    }
  }
  if (!SUM || !live) return;
  Fq3 v = reduce3(acc);
  if (base != nullptr)
    v = fq3_sub(Fq3{base[3 * g], base[3 * g + 1], base[3 * g + 2]}, v);
  out[3 * g] = v.c0;
  out[3 * g + 1] = v.c1;
  out[3 * g + 2] = v.c2;
}

}  // namespace

extern "C" {

// sum != 0: out (rows, 24) = [base -] sum_{i < n} c_i x_i, the terms x_i
// (rows, 24) at xa + i x_step (i < n_a) and xb + (i - n_a) x_step; base may
// be null.  sum == 0: out (n, rows, 24), out[i] = c_i xa; xb and base null.
int lt_ring_mac(const u64 *xa, const u64 *xb, int n_a, long long x_step,
                const u64 *c, int n, const u64 *base, u64 *out,
                long long rows, int sum, cudaStream_t stream) {
  if (rows < 1 || n < 0 || n_a < 0 || n_a > n ||
      (!sum && (xb != nullptr || base != nullptr)))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((rows * 8 + RM_BLOCK - 1) / RM_BLOCK);
  if (sum)
    ring_mac_kernel<true><<<grid, RM_BLOCK, 0, stream>>>(
        xa, xb, n_a, x_step, c, n, base, out, rows);
  else
    ring_mac_kernel<false><<<grid, RM_BLOCK, 0, stream>>>(
        xa, xb, n_a, x_step, c, n, base, out, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
