// The four sum-check comb kernels of the IVC fold step, for sm_90a.
//
// Replace the Pallas kernels of latticeum_tpu/zkvm/pallas_comb.py:
//   fold_round0_kernel  <- fold_round0_pallas   (pallas_comb.py:117)
//   fold_roundr_kernel  <- fold_roundr_pallas   (pallas_comb.py:176)
//   lin_round0_kernel   <- lin_round0_pallas    (pallas_comb.py:317)
//   lin_roundr_kernel   <- lin_roundr_pallas    (pallas_comb.py:365)
// The wrappers and the plain-torch twins are in zkvm/comb.py, which states
// what each kernel computes.
//
// Layout: t-layout int64/uint64 tensors (rows, 24, width), ring position
// 3*slot + comp, hypercube on the minor axis.  A round pairs column x with
// column x + q.  Thread (x, slot) = (blockIdx.x * BLOCK + threadIdx.x,
// blockIdx.y): neighbouring threads read neighbouring columns (coalesced),
// and each thread walks every row of its slot, so each input element is read
// from device memory once and the per-point sums never leave registers.
//
// What bounds them on the card: the per-element work is a chain of
// 64x64 -> 128-bit modular multiplies (integer IMAD throughput), not bytes:
// the fold comb does ~25 Fq3 products per (row, slot, column) and reads 48
// bytes there; the lin comb ~60 per (column, slot) over 125 rows.  The design
// keeps every intermediate in registers, templates the point count so the
// per-point accumulators stay in registers, and fuses the round-r fold (the
// folded array is written once to a fresh output, never re-read).
//
// Cross-block sums: the TPU grid runs in order and carries the sums across
// grid steps.  Here each block reduces its threads (warp shuffles, then
// shared memory) and writes partial sums (blocks, npts, 24); a second kernel
// adds the partials.  Field addition is associative mod p, so the order of
// either pass cannot change a bit of the result.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define BLOCK 128
#define WARPS (BLOCK / 32)

namespace {

__device__ __forceinline__ Fq3 load3(const u64 *__restrict__ p, long long stride,
                                     long long x) {
  return Fq3{p[x], p[stride + x], p[2 * stride + x]};
}

__device__ __forceinline__ void store3(u64 *__restrict__ p, long long stride,
                                       long long x, const Fq3 &v) {
  p[x] = v.c0;
  p[stride + x] = v.c1;
  p[2 * stride + x] = v.c2;
}

// Block-reduce acc[t] (3 comps each) and write this block's partial sums
// for ring slot `slot`: partial[(blockIdx.x * NPTS + t) * 24 + 3 * slot + c].
template <int NPTS>
__device__ __forceinline__ void store_partials(const Fq3 (&acc)[NPTS],
                                               u64 *__restrict__ partial,
                                               int slot) {
  __shared__ u64 red[WARPS][NPTS * 3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NPTS; ++t) {
    u64 v[3] = {acc[t].c0, acc[t].c1, acc[t].c2};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      u64 a = v[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a = gl_add(a, __shfl_down_sync(0xffffffffu, a, off));
      if (lane == 0) red[warp][t * 3 + k] = a;
    }
  }
  __syncthreads();
  if (threadIdx.x < NPTS * 3) {
    u64 a = 0ULL;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = gl_add(a, red[w][threadIdx.x]);
    const int t = threadIdx.x / 3;
    const int k = threadIdx.x % 3;
    partial[((long long)blockIdx.x * NPTS + t) * 24 + 3 * slot + k] = a;
  }
}

// v0/v1 of one row at column x.  Round 0 reads X (width 2q) directly; a
// round-r kernel folds X (width 4q) at r and writes the folded F (width 2q).
template <bool FOLD>
__device__ __forceinline__ void row_pair(const u64 *__restrict__ X,
                                         u64 *__restrict__ F, long long q,
                                         long long row, int slot, long long x,
                                         const Fq3 &r, Fq3 &v0, Fq3 &v1) {
  if (FOLD) {
    const long long W = 4 * q;
    const u64 *xr = X + (row * 24 + 3 * slot) * W;
    const Fq3 a = load3(xr, W, x);
    const Fq3 b = load3(xr, W, 2 * q + x);
    const Fq3 c = load3(xr, W, q + x);
    const Fq3 d = load3(xr, W, 3 * q + x);
    v0 = fq3_add(a, fq3_mul(r, fq3_sub(b, a)));
    v1 = fq3_add(c, fq3_mul(r, fq3_sub(d, c)));
    u64 *fr = F + (row * 24 + 3 * slot) * (2 * q);
    store3(fr, 2 * q, x, v0);
    store3(fr, 2 * q, q + x, v1);
  } else {
    const long long W = 2 * q;
    const u64 *xr = X + (row * 24 + 3 * slot) * W;
    v0 = load3(xr, W, x);
    v1 = load3(xr, W, q + x);
  }
}

// Fold comb: acc[t] = Tb(x) * sum_rows mu_row * f_t * prod_{b<b_small}
// (f_t^2 - b^2) with f_t = v0 + t (v1 - v0); round 0 skips t = 0, 1.
template <int NPTS, bool FOLD>
__device__ __forceinline__ void fold_body(const u64 *__restrict__ X,
                                          u64 *__restrict__ F,
                                          const u64 *__restrict__ Tb,
                                          const u64 *__restrict__ mu,
                                          u64 *__restrict__ partial, int rows,
                                          long long q, Fq3 r, int b_small) {
  const int slot = blockIdx.y;
  const long long x = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const int pt0 = FOLD ? 0 : 2;
  Fq3 acc[NPTS];
#pragma unroll
  for (int t = 0; t < NPTS; ++t) acc[t] = fq3_zero();
  if (x < q) {
    for (int row = 0; row < rows; ++row) {
      Fq3 v0, v1;
      row_pair<FOLD>(X, F, q, row, slot, x, r, v0, v1);
      const Fq3 m = Fq3{mu[3 * row], mu[3 * row + 1], mu[3 * row + 2]};
      const Fq3 step = fq3_sub(v1, v0);
      const Fq3 mstep = fq3_mul(m, step);
      Fq3 f = v0;
      Fq3 mf = fq3_mul(m, v0);
#pragma unroll
      for (int t = 0; t < NPTS; ++t) {
        if (t >= pt0) {
          const Fq3 fsq = fq3_square(f);
          Fq3 ev = mf;
          for (int b = 1; b < b_small; ++b) {
            const Fq3 fac =
                Fq3{gl_sub(fsq.c0, (u64)(b * b)), fsq.c1, fsq.c2};
            ev = fq3_mul(ev, fac);
          }
          acc[t] = fq3_add(acc[t], ev);
        }
        f = fq3_add(f, step);
        mf = fq3_add(mf, mstep);
      }
    }
    const Fq3 tb = load3(Tb + (long long)3 * slot * q, q, x);
#pragma unroll
    for (int t = 0; t < NPTS; ++t) acc[t] = fq3_mul(acc[t], tb);
  }
  store_partials<NPTS>(acc, partial, slot);
}

// Lin comb: acc[t] = Tc(x) * sum_i sign_i prod_{j in S_i} f_t[j].  The
// multisets come as CSR (set_off, set_idx); every row is in some multiset
// (checked by the wrapper), so the round-r fold writes every row of F.
template <int NPTS, bool FOLD>
__device__ __forceinline__ void lin_body(const u64 *__restrict__ X,
                                         u64 *__restrict__ F,
                                         const u64 *__restrict__ Tc,
                                         const int *__restrict__ set_off,
                                         const int *__restrict__ set_idx,
                                         const int *__restrict__ set_sign,
                                         int nsets, u64 *__restrict__ partial,
                                         long long q, Fq3 r) {
  const int slot = blockIdx.y;
  const long long x = (long long)blockIdx.x * BLOCK + threadIdx.x;
  Fq3 acc[NPTS];
#pragma unroll
  for (int t = 0; t < NPTS; ++t) acc[t] = fq3_zero();
  if (x < q) {
    for (int i = 0; i < nsets; ++i) {
      const int k0 = set_off[i];
      const int k1 = set_off[i + 1];
      Fq3 prod[NPTS];
      for (int k = k0; k < k1; ++k) {
        Fq3 v0, v1;
        row_pair<FOLD>(X, F, q, set_idx[k], slot, x, r, v0, v1);
        const Fq3 step = fq3_sub(v1, v0);
        Fq3 f = v0;
#pragma unroll
        for (int t = 0; t < NPTS; ++t) {
          if (k == k0) {
            prod[t] = f;
          } else {
            prod[t] = fq3_mul(prod[t], f);
          }
          f = fq3_add(f, step);
        }
      }
      if (set_sign[i] > 0) {
#pragma unroll
        for (int t = 0; t < NPTS; ++t) acc[t] = fq3_add(acc[t], prod[t]);
      } else {
#pragma unroll
        for (int t = 0; t < NPTS; ++t) acc[t] = fq3_sub(acc[t], prod[t]);
      }
    }
    const Fq3 tc = load3(Tc + (long long)3 * slot * q, q, x);
#pragma unroll
    for (int t = 0; t < NPTS; ++t) acc[t] = fq3_mul(acc[t], tc);
  }
  store_partials<NPTS>(acc, partial, slot);
}

}  // namespace

template <int NPTS>
__global__ void __launch_bounds__(BLOCK)
    fold_round0_kernel(const u64 *__restrict__ X, const u64 *__restrict__ Tb,
                       const u64 *__restrict__ mu, u64 *__restrict__ partial,
                       int rows, long long q, int b_small) {
  fold_body<NPTS, false>(X, nullptr, Tb, mu, partial, rows, q, fq3_zero(),
                         b_small);
}

template <int NPTS>
__global__ void __launch_bounds__(BLOCK)
    fold_roundr_kernel(const u64 *__restrict__ X, u64 *__restrict__ F,
                       const u64 *__restrict__ Tb, const u64 *__restrict__ mu,
                       u64 *__restrict__ partial, int rows, long long q, Fq3 r,
                       int b_small) {
  fold_body<NPTS, true>(X, F, Tb, mu, partial, rows, q, r, b_small);
}

template <int NPTS>
__global__ void __launch_bounds__(BLOCK)
    lin_round0_kernel(const u64 *__restrict__ X, const u64 *__restrict__ Tc,
                      const int *__restrict__ set_off,
                      const int *__restrict__ set_idx,
                      const int *__restrict__ set_sign, int nsets,
                      u64 *__restrict__ partial, long long q) {
  lin_body<NPTS, false>(X, nullptr, Tc, set_off, set_idx, set_sign, nsets,
                        partial, q, fq3_zero());
}

template <int NPTS>
__global__ void __launch_bounds__(BLOCK)
    lin_roundr_kernel(const u64 *__restrict__ X, u64 *__restrict__ F,
                      const u64 *__restrict__ Tc,
                      const int *__restrict__ set_off,
                      const int *__restrict__ set_idx,
                      const int *__restrict__ set_sign, int nsets,
                      u64 *__restrict__ partial, long long q, Fq3 r) {
  lin_body<NPTS, true>(X, F, Tc, set_off, set_idx, set_sign, nsets, partial,
                       q, r);
}

// Second pass: out[k] = sum over blocks of partial[b][k], k < nvals.
__global__ void __launch_bounds__(BLOCK)
    reduce_partials_kernel(const u64 *__restrict__ partial,
                           u64 *__restrict__ out, long long nblocks,
                           int nvals) {
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  if (k >= nvals) return;
  u64 a = 0ULL;
  for (long long b = 0; b < nblocks; ++b) a = gl_add(a, partial[b * nvals + k]);
  out[k] = a;
}

static cudaError_t reduce_partials(const u64 *partial, u64 *out,
                                   long long nblocks, int npts,
                                   cudaStream_t stream) {
  const int nvals = npts * 24;
  reduce_partials_kernel<<<(nvals + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      partial, out, nblocks, nvals);
  return cudaGetLastError();
}

static dim3 comb_grid(long long q) {
  return dim3((unsigned)((q + BLOCK - 1) / BLOCK), 8);
}

// Point counts instantiated: the fold comb has npts = 2 b_small (b_small
// 1..4), the lin comb npts = deg(q) + 1 (1..12).
#define LT_DISPATCH_FOLD(NPTS_VALUE, CASE_BODY)                              \
  switch (NPTS_VALUE) {                                                      \
    CASE_BODY(2) CASE_BODY(4) CASE_BODY(6) CASE_BODY(8)                      \
    default:                                                                 \
      return (int)cudaErrorInvalidValue;                                     \
  }

#define LT_DISPATCH_LIN(NPTS_VALUE, CASE_BODY)                               \
  switch (NPTS_VALUE) {                                                      \
    CASE_BODY(1) CASE_BODY(2) CASE_BODY(3) CASE_BODY(4) CASE_BODY(5)         \
    CASE_BODY(6) CASE_BODY(7) CASE_BODY(8) CASE_BODY(9) CASE_BODY(10)        \
    CASE_BODY(11) CASE_BODY(12)                                              \
    default:                                                                 \
      return (int)cudaErrorInvalidValue;                                     \
  }

extern "C" {

// Every entry point returns the cudaError_t of its launches (0 = success).

const char *lt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int lt_fold_round0(const u64 *X, const u64 *Tb, const u64 *mu, u64 *partial,
                   u64 *out, int rows, long long q, int b_small,
                   cudaStream_t stream) {
  const int npts = 2 * b_small;
#define LT_CASE(N)                                                           \
  case N:                                                                    \
    fold_round0_kernel<N><<<comb_grid(q), BLOCK, 0, stream>>>(               \
        X, Tb, mu, partial, rows, q, b_small);                               \
    break;
  LT_DISPATCH_FOLD(npts, LT_CASE)
#undef LT_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partial, out, comb_grid(q).x, npts, stream);
}

int lt_fold_roundr(const u64 *X, u64 *F, const u64 *Tb, const u64 *mu,
                   u64 *partial, u64 *out, int rows, long long q, u64 r0,
                   u64 r1, u64 r2, int b_small, cudaStream_t stream) {
  const int npts = 2 * b_small;
  const Fq3 r = Fq3{r0, r1, r2};
#define LT_CASE(N)                                                           \
  case N:                                                                    \
    fold_roundr_kernel<N><<<comb_grid(q), BLOCK, 0, stream>>>(               \
        X, F, Tb, mu, partial, rows, q, r, b_small);                         \
    break;
  LT_DISPATCH_FOLD(npts, LT_CASE)
#undef LT_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partial, out, comb_grid(q).x, npts, stream);
}

int lt_lin_round0(const u64 *X, const u64 *Tc, const int *set_off,
                  const int *set_idx, const int *set_sign, int nsets,
                  u64 *partial, u64 *out, long long q, int npts,
                  cudaStream_t stream) {
#define LT_CASE(N)                                                           \
  case N:                                                                    \
    lin_round0_kernel<N><<<comb_grid(q), BLOCK, 0, stream>>>(                \
        X, Tc, set_off, set_idx, set_sign, nsets, partial, q);               \
    break;
  LT_DISPATCH_LIN(npts, LT_CASE)
#undef LT_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partial, out, comb_grid(q).x, npts, stream);
}

int lt_lin_roundr(const u64 *X, u64 *F, const u64 *Tc, const int *set_off,
                  const int *set_idx, const int *set_sign, int nsets,
                  u64 *partial, u64 *out, long long q, u64 r0, u64 r1, u64 r2,
                  int npts, cudaStream_t stream) {
  const Fq3 r = Fq3{r0, r1, r2};
#define LT_CASE(N)                                                           \
  case N:                                                                    \
    lin_roundr_kernel<N><<<comb_grid(q), BLOCK, 0, stream>>>(                \
        X, F, Tc, set_off, set_idx, set_sign, nsets, partial, q, r);         \
    break;
  LT_DISPATCH_LIN(npts, LT_CASE)
#undef LT_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partial, out, comb_grid(q).x, npts, stream);
}

}  // extern "C"
