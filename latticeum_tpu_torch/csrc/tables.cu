// The fold step's eq tables and the fold head's alpha-pass, for sm_90a.
//
// Both replace functions that the JAX package computes in XLA, with no
// Pallas kernel; the wrappers and the plain-torch twins are in
// zkvm/tables.py, which states the layouts.
//
// eq_table_kernel (replaces latticeum_tpu/zkvm/accel.py:141
//   DeviceEngine.eq_table, one jit of up to 17 doublings): the eq table
//   eq(point, x) over rows = 2^n_dbl hypercube rows, each an Fq3 value
//   written to all 8 NTT slots.  Row j is
//       f[0] * prod_{k < n_dbl} f[1 + 2k + bit_k(j)]
//   for the factor table f the wrapper uploads: f[0] the product of
//   (1 - r) over the skipped top variables, f[1 + 2k + b] the factor of
//   index bit k at value b ((1 - r_v, r_v) of the variable v that bit k
//   stands for: v = k in the standard layout, v = n_dbl - 1 - k in the
//   bit-reversed t-layout, so both layouts are the same product over a
//   reordered table).  Field multiplication is exact, so the order of the
//   factors does not change a bit of the result.
//   What bounds it: the bytes written (rows x 24 x 8; 25.2 MB at 2^17
//   rows, 7.5 us at 3.35 TB/s).  A thread per row forming its own product
//   would do n_dbl Fq3 multiplies a row, about as many instructions as the
//   card issues in the time of the bytes.  So a block takes 2^EQ_LOW = 256
//   consecutive rows j = base + t, whose product splits as
//       hi(base) * A(t mod 16) * B(t / 16),
//   hi = f[0] times the factors of bits >= EQ_LOW of base, A and B the
//   factors of bits 0-3 and 4-7: after the factor table is staged in
//   shared memory, warp 0 forms the 16 A's and 16 B's (a lane each, 4
//   multiplies), warp 1 hi (a lane per bit, then a butterfly of 5
//   shuffle-and-multiply levels), and every thread multiplies its three,
//   about 3 multiplies a row in all.  Every block runs that set-up before
//   it writes, so its depth (about 8 dependent multiplies) is added to the
//   time of the bytes once.  Then every thread writes: in the t-layout
//   (24, rows) a thread per row writes each of its 24 values, a warp 32
//   neighbouring words; in the standard layout (rows, 24) the block's rows
//   are 24 x 256 contiguous words, which the threads write in turn,
//   neighbouring threads neighbouring words.
//   The first design (thread 0 forming hi alone, then 8 levels of
//   doubling in shared memory, the factors read from device memory on
//   that chain) spent more time in that set-up than in its writes
//   (PERF.md, the kernel table).
//
// head_alpha_kernel (replaces the alpha-pass of
//   latticeum_tpu/zkvm/accel_nifs.py:997 DeviceNifs._build_head, one jit):
//       c1[3s + c, col] = sum_{idx < half} alpha[idx] * tail[idx][s][col]
//       c2[3s + c, col] = sum_{idx >= half} alpha[idx] * tail[idx][s][col]
//   component c of the Fq3 products, for the t-layout f_hat tail
//   (2 half, 24, m) and the alpha powers (2 half, 3).  One thread owns one
//   (slot, column); both halves come out of the one pass over the tail.  A
//   warp reads 32 neighbouring columns of one tail row, each value once.
//   The sums are linear, so nothing is reduced per term: with w = 2^40,
//       d0 = a0 x0 + (w a2) x1 + (w a1) x2
//       d1 = a1 x0 + a0 x1     + (w a2) x2
//       d2 = a2 x0 + a1 x1     + a0 x2
//   the 3 products a term of each component added, full 128-bit, into a
//   192-bit sum (U192, mac192), which is reduced once an output.  The
//   block forms w a1 and w a2 of every alpha once into shared memory (6
//   words an alpha, so three 16-byte broadcast loads a term).
//   What bounds it: the tail's bytes (2.26 GB at 90 x 24 x 2^17, 0.68 ms at
//   3.35 TB/s); 9 multiply-adds a term are fewer instructions than the
//   card issues in that time, where a canonical Fq3 multiply and add a
//   term (about 330 ALU instructions) would bind it to the ALU at 1.8 ms.
//   On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's tables phase):
//   0.95 ms.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

using namespace lt;

#define EQ_LOW 8
#define EQ_THREADS (1 << EQ_LOW)
#define EQ_MAX_DBL 30
#define HA_THREADS 256
#define HA_MAX_HALF 256  // 12 half words of shared memory

namespace {

__device__ __forceinline__ Fq3 fq3_one() { return Fq3{1ULL, 0ULL, 0ULL}; }

__device__ __forceinline__ Fq3 shared3(const u64 *p) {
  return Fq3{p[0], p[1], p[2]};
}

__device__ __forceinline__ void put3(u64 *p, const Fq3 &v) {
  p[0] = v.c0;
  p[1] = v.c1;
  p[2] = v.c2;
}

__device__ __forceinline__ Fq3 shfl_xor3(const Fq3 &v, int d) {
  return Fq3{__shfl_xor_sync(0xffffffffu, v.c0, d),
             __shfl_xor_sync(0xffffffffu, v.c1, d),
             __shfl_xor_sync(0xffffffffu, v.c2, d)};
}

__global__ void __launch_bounds__(EQ_THREADS)
    eq_table_kernel(const u64 *__restrict__ f, u64 *__restrict__ out,
                    int n_dbl, int t_layout) {
  __shared__ u64 fs[3 * (1 + 2 * EQ_MAX_DBL)];
  __shared__ u64 ab[3 * 32];  // A(0..15), then B(0..15)
  __shared__ u64 hi[3];
  __shared__ u64 tab[3 * EQ_THREADS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int low = n_dbl < EQ_LOW ? n_dbl : EQ_LOW;
  const int nr = 1 << low;  // rows of this block
  const long long base = (long long)blockIdx.x << EQ_LOW;
  for (int i = tid; i < 3 * (1 + 2 * n_dbl); i += EQ_THREADS) fs[i] = f[i];
  __syncthreads();
  if (warp == 0) {
    const int k0 = lane < 16 ? 0 : 4, u = lane & 15;
    Fq3 v = fq3_one();
    for (int k = k0; k < k0 + 4 && k < low; ++k)
      v = fq3_mul(v, shared3(fs + 3 * (1 + 2 * k + ((u >> (k - k0)) & 1))));
    put3(ab + 3 * lane, v);
  } else if (warp == 1) {
    const int k = EQ_LOW + lane;
    Fq3 v = k < n_dbl ? shared3(fs + 3 * (1 + 2 * k + ((base >> k) & 1)))
                      : fq3_one();
    for (int d = 16; d; d >>= 1) v = fq3_mul(v, shfl_xor3(v, d));
    if (lane == 0) put3(hi, fq3_mul(v, shared3(fs)));
  }
  __syncthreads();
  if (tid < nr)
    put3(tab + 3 * tid,
         fq3_mul(fq3_mul(shared3(ab + 3 * (tid & 15)),
                         shared3(ab + 3 * (16 + (tid >> 4)))),
                 shared3(hi)));
  __syncthreads();
  if (t_layout) {
    if (tid < nr) {
      const long long rows = 1LL << n_dbl;
      u64 *o = out + base + tid;
#pragma unroll
      for (int c = 0; c < 24; ++c) o[c * rows] = tab[3 * tid + c % 3];
    }
  } else {
    u64 *o = out + 24 * base;
    for (int w = tid; w < 24 * nr; w += EQ_THREADS)
      o[w] = tab[3 * (w / 24) + w % 3];
  }
}

__global__ void __launch_bounds__(HA_THREADS)
    head_alpha_kernel(const u64 *__restrict__ tail,
                      const u64 *__restrict__ alpha, u64 *__restrict__ c1,
                      u64 *__restrict__ c2, int half, long long m) {
  // per alpha: a0, a1, a2, w a1, w a2, 0
  extern __shared__ __align__(16) u64 a_sh[];
  for (int i = threadIdx.x; i < 2 * half; i += HA_THREADS) {
    const u64 a1 = alpha[3 * i + 1], a2 = alpha[3 * i + 2];
    u64 *o = a_sh + 6 * i;
    o[0] = alpha[3 * i];
    o[1] = a1;
    o[2] = a2;
    o[3] = gl_mul_w(a1);
    o[4] = gl_mul_w(a2);
    o[5] = 0;
  }
  __syncthreads();
  const long long col = (long long)blockIdx.x * HA_THREADS + threadIdx.x;
  if (col >= m) return;
  const int s = blockIdx.y;
  const long long row = 24 * m;
  const u64 *x = tail + 3 * s * m + col;
  const ulonglong2 *a2v = reinterpret_cast<const ulonglong2 *>(a_sh);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    U192 d0{0, 0, 0}, d1{0, 0, 0}, d2{0, 0, 0};
#pragma unroll 4
    for (int i = h * half; i < (h + 1) * half; ++i) {
      const u64 *xi = x + i * row;
      const u64 x0 = __ldg(xi), x1 = __ldg(xi + m), x2 = __ldg(xi + 2 * m);
      const ulonglong2 p = a2v[3 * i], q = a2v[3 * i + 1],
                       r = a2v[3 * i + 2];
      // p = (a0, a1), q = (a2, w a1), r = (w a2, 0)
      mac192(d0, p.x, x0);
      mac192(d0, r.x, x1);
      mac192(d0, q.y, x2);
      mac192(d1, p.y, x0);
      mac192(d1, p.x, x1);
      mac192(d1, r.x, x2);
      mac192(d2, q.x, x0);
      mac192(d2, p.y, x1);
      mac192(d2, p.x, x2);
    }
    u64 *o = (h ? c2 : c1) + 3 * s * m + col;
    o[0] = reduce192(d0);
    o[m] = reduce192(d1);
    o[2 * m] = reduce192(d2);
  }
}

}  // namespace

extern "C" {

// Both entry points return the cudaError_t of their launch (0 = success).

int lt_eq_table(const u64 *f, u64 *out, int n_dbl, int t_layout,
                cudaStream_t stream) {
  if (n_dbl < 0 || n_dbl > EQ_MAX_DBL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = n_dbl > EQ_LOW ? 1u << (n_dbl - EQ_LOW) : 1u;
  eq_table_kernel<<<blocks, EQ_THREADS, 0, stream>>>(f, out, n_dbl,
                                                     t_layout);
  return (int)cudaGetLastError();
}

int lt_head_alpha(const u64 *tail, const u64 *alpha, u64 *c1, u64 *c2,
                  int half, long long m, cudaStream_t stream) {
  if (half < 1 || half > HA_MAX_HALF || m < 1 ||
      (m + HA_THREADS - 1) / HA_THREADS > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + HA_THREADS - 1) / HA_THREADS), 8);
  head_alpha_kernel<<<grid, HA_THREADS, 12 * half * sizeof(u64), stream>>>(
      tail, alpha, c1, c2, half, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
