// Poseidon2 width-8 over Goldilocks for sm_90a: the batched permutation
// (perm8_kernel) and the rate-4 overwrite sponge of whole rows in one
// launch (sponge8_kernel).
//
// Replaces the Pallas kernel of latticeum_tpu/parallel/pallas_kernels.py:109
// (make_perm8_kernel / perm8_pallas), the JAX package's batched form of
// crypto/poseidon2.py::perm8, and the loop of one perm8 launch per absorb of
// crypto/poseidon2.py::hash_rows_narrow (:100-119).  The wrappers and the
// plain-torch twins are in crypto/poseidon2.py.  perm8: (n, 8) u64 states in,
// a fresh (n, 8) array out.  sponge8: (n, L) field values in, (n, 4) digests
// out, each row's ceil(L / 4) absorbs in a loop with the state in registers.
//
// One permutation: the initial external linear layer, 4 external rounds
// (8 s-boxes x^7, linear layer), 22 internal rounds (one s-box, then the
// diagonal-plus-ones matrix), 4 external rounds.  That is 520 Goldilocks
// multiplies and 722 gl_add calls against 128 bytes of state read and
// written.  Built for sm_90a, the straight-line one-thread form is 26,145
// SASS instructions per state (7,045 IMAD, 18,903 integer ALU; cuobjdump,
// chip_smoke.py counts them): with the card full it is bound by the ALU
// pipe (9.3 us at n = 8192 on 132 SMs at 1.98 GHz).
//
// What bounds it at the prover's shapes is latency and occupancy, not ALU
// throughput.  The trees run perm8 at n = 1024 and 8192 (leaf absorbs of
// the 1 MB and 8 MB page trees), at n = 512 ... 1 (levels) and n <= 80
// (code tree).  With one thread per state, n = 8192 is 256 warps, one or
// two per SM: each warp waits on its own dependent chain, about 5.5 clocks
// per instruction, and a launch took 72 us at n = 1024 and at n = 8192
// alike (NVIDIA H100 80GB HBM3, 700.00 W; CUDA graph and profiler agree),
// 12.8 % of the bound.  The sponge issued one such launch per absorb, 64
// for a 1 MB VM's pages.
//
// The design: one state over S lanes of a warp, S in {1, 2, 4, 8}, 8 / S
// elements a lane, so a launch has S times the warps and each lane's chain
// is shorter.  The external layer exchanges values inside the lane group
// with __shfl_sync: M4 is circulant, d_i = t + s_i + 2 s_{i+1} with t the
// quad's sum (a butterfly), and the column sums pair the two halves with one
// xor-(S/2) shuffle.  In the internal rounds the lane that holds s[0] runs
// its s-box, then the group sums all 8 elements by a butterfly.  S = 1 is
// the port's first, one-thread kernel, kept so that one run compares the
// forms.  (A second form, with s[0] copied into every lane of the group so
// that its s-box overlaps the butterfly, was 6-19 % slower at every S > 1:
// the repeated s-boxes cost more than the overlap saved.)
// The round loops stay loops (P8_ROUNDS below): unrolled, a lane's code was
// 7,000-26,000 SASS instructions, 110-420 KB, and the warps waited on
// instruction fetch (the one-thread kernel took 0.0715 and 0.0720 ms at
// n = 1024 and 8192 unrolled, 0.0299 and 0.0303 as loops); as loops it is
// 900-4,300.  Lanes past n take part in every shuffle with their loads and
// stores masked.  Blocks are sized at launch (256 down to 32 threads) so
// that a launch has at least two blocks per SM where it can.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, CUDA graph of
// 50 launches, the profiler's kernel mean within 3 %):
//   perm8 ms   n = 512    4096     8192     16384    65536    524288
//   S = 1        0.0293   0.0301   0.0303   0.0308   0.0948   0.7020
//   S = 2        0.0191   0.0193   0.0195   0.0304   0.1042   0.8100
//   S = 4        0.0137   0.0139   0.0206   0.0370   0.1332   1.0266
//   S = 8        0.0123   0.0160   0.0277   0.0503   0.1908   1.4671
//   bound        0.00058  0.0046   0.0092   0.0185   0.0740   0.5917
// At n <= 2048 every launch of the fastest form takes about 0.012 ms, the
// latency of one lane group's chain; the levels of a 1 MB tree (n <= 512)
// run at under 5 % of their bound.  sponge8, 256 words a row: 0.660 ms at
// 1024 and 2048 rows (S = 8), 0.807 at 4096 (S = 4), 1.135 at 8192
// (S = 2), 1.793 at 16384 (S = 1), against 2.02-2.12 ms for 64 launches
// of the one-thread perm8.  Up to 8192 rows each is within 2 % of one row
// alone through the same form, the chain of 64 dependent absorbs, so the
// chain sets the time (11 % of the bound at 1024 rows, 52 % at 8192).
// crypto/poseidon2.py::kernel_lanes picks S by n for both kernels;
// PERF.md section 6 has every form at every shape.
//
// The round constants come from the caller as one device array of 94 u64
// (crypto/poseidon2.py builds it from host/crypto/consts.py, the single
// source of truth): [0, 32) the 4 x 8 initial external constants,
// [32, 64) the 4 x 8 terminal ones, [64, 86) the 22 internal ones,
// [86, 94) the internal diagonal.  Each block copies them to shared memory.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define P8_MAX_BLOCK 256
#define P8_MIN_BLOCK 32
#define P8_EXT_INIT 0
#define P8_EXT_TERM 32
#define P8_INTERNAL 64
#define P8_DIAG 86
#define P8_NCONST 94
#define P8_FULL 0xffffffffu

// The round loops stay loops (see the note above).  One build unrolls
// them, for measurement only: P8_STRAIGHT_LINE (the one-lane kernel alone,
// whose SASS chip_smoke.py counts as the work of one permutation).
#ifdef P8_STRAIGHT_LINE
#define P8_ROUNDS _Pragma("unroll")
#else
#define P8_ROUNDS _Pragma("unroll 1")
#endif

namespace {

// M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on s[o..o+3] (the addition
// chain of Plonky3's apply_mat4: 9 additions and 2 doublings).
template <int N>
__device__ __forceinline__ void m4(u64 (&s)[N], int o) {
  const u64 t01 = gl_add(s[o], s[o + 1]);
  const u64 t23 = gl_add(s[o + 2], s[o + 3]);
  const u64 t0123 = gl_add(t01, t23);
  const u64 t01123 = gl_add(t0123, s[o + 1]);
  const u64 t01233 = gl_add(t0123, s[o + 3]);
  const u64 d3 = gl_add(t01233, gl_add(s[o], s[o]));
  const u64 d1 = gl_add(t01123, gl_add(s[o + 2], s[o + 2]));
  const u64 d0 = gl_add(t01123, t01);
  const u64 d2 = gl_add(t01233, t23);
  s[o] = d0;
  s[o + 1] = d1;
  s[o + 2] = d2;
  s[o + 3] = d3;
}

// The external linear layer on a state spread over S lanes (lane g of the
// group holds elements g * 8/S ... g * 8/S + 8/S - 1): M4 on each half of
// 4, then each element plus the sum of itself and its partner in the other
// half.
template <int S>
__device__ __forceinline__ void mds_light8(u64 (&s)[8 / S], int lane) {
  if constexpr (S == 1) {
    m4(s, 0);
    m4(s, 4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const u64 sum = gl_add(s[k], s[k + 4]);
      s[k] = gl_add(s[k], sum);
      s[k + 4] = gl_add(s[k + 4], sum);
    }
  } else if constexpr (S == 2) {
    m4(s, 0);                          // a lane holds a whole quad
  } else if constexpr (S == 4) {
    // a lane holds s_i, s_{i+1} (i = 0 or 2 of its quad); its partner
    // (lane ^ 1) the other two.  d_i = t + s_i + 2 s_{i+1}.
    const u64 pair = gl_add(s[0], s[1]);
    const u64 t = gl_add(pair, __shfl_xor_sync(P8_FULL, pair, 1));
    const u64 next = __shfl_xor_sync(P8_FULL, s[0], 1);
    const u64 d0 = gl_add(gl_add(t, s[0]), gl_add(s[1], s[1]));
    const u64 d1 = gl_add(gl_add(t, s[1]), gl_add(next, next));
    s[0] = d0;
    s[1] = d1;
  } else {
    // a lane holds one element s_i of its quad of lanes
    u64 t = gl_add(s[0], __shfl_xor_sync(P8_FULL, s[0], 1));
    t = gl_add(t, __shfl_xor_sync(P8_FULL, t, 2));
    const u64 next =
        __shfl_sync(P8_FULL, s[0], (lane & ~3) | ((lane + 1) & 3));
    s[0] = gl_add(gl_add(t, s[0]), gl_add(next, next));
  }
  if constexpr (S > 1) {
#pragma unroll
    for (int j = 0; j < 8 / S; ++j) {
      const u64 other = __shfl_xor_sync(P8_FULL, s[j], S / 2);
      s[j] = gl_add(s[j], gl_add(s[j], other));
    }
  }
}

template <int S>
__device__ __forceinline__ void external_round(u64 (&s)[8 / S],
                                               const u64 *rc, int g,
                                               int lane) {
#pragma unroll
  for (int j = 0; j < 8 / S; ++j)
    s[j] = gl_pow7(gl_add(s[j], rc[g * (8 / S) + j]));
  mds_light8<S>(s, lane);
}

// The group's sum of one value a lane holds (xor butterfly over S lanes).
template <int S>
__device__ __forceinline__ u64 group_sum(u64 v) {
#pragma unroll
  for (int m = 1; m < S; m <<= 1)
    v = gl_add(v, __shfl_xor_sync(P8_FULL, v, m));
  return v;
}

// One permutation of the state held by this lane group.  `k` holds the 94
// constants, `d` this lane's diagonal entries, g the lane's index in its
// group, lane its index in the warp.
template <int S>
__device__ __forceinline__ void permute(u64 (&s)[8 / S], const u64 *k,
                                        const u64 (&d)[8 / S], int g,
                                        int lane) {
  constexpr int E = 8 / S;
  mds_light8<S>(s, lane);
  P8_ROUNDS
  for (int r = 0; r < 4; ++r)
    external_round<S>(s, k + P8_EXT_INIT + 8 * r, g, lane);
  P8_ROUNDS
  for (int r = 0; r < 22; ++r) {
    if (g == 0) s[0] = gl_pow7(gl_add(s[0], k[P8_INTERNAL + r]));
    u64 tot = s[0];
#pragma unroll
    for (int j = 1; j < E; ++j) tot = gl_add(tot, s[j]);
    tot = group_sum<S>(tot);
#pragma unroll
    for (int j = 0; j < E; ++j) s[j] = gl_add(gl_mul(s[j], d[j]), tot);
  }
  P8_ROUNDS
  for (int r = 0; r < 4; ++r)
    external_round<S>(s, k + P8_EXT_TERM + 8 * r, g, lane);
}

// Copy the constants to shared memory and this lane's diagonal entries to
// registers.
template <int S>
__device__ __forceinline__ void load_consts(u64 *k, u64 (&d)[8 / S],
                                            const u64 *__restrict__ consts,
                                            int g) {
  for (int i = threadIdx.x; i < P8_NCONST; i += blockDim.x) k[i] = consts[i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8 / S; ++j) d[j] = k[P8_DIAG + g * (8 / S) + j];
}

// Threads per block: the largest of 256, 128, 64, 32 that still gives two
// blocks per SM, else 32.
int block_threads(long long threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  int bt = P8_MAX_BLOCK;
  while (bt > P8_MIN_BLOCK && (threads + bt - 1) / bt < 2LL * sms) bt /= 2;
  return bt;
}

}  // namespace

template <int S>
__global__ void __launch_bounds__(P8_MAX_BLOCK)
    perm8_kernel(const u64 *__restrict__ in, u64 *__restrict__ out,
                 const u64 *__restrict__ consts, long long n) {
  constexpr int E = 8 / S;
  __shared__ u64 k[P8_NCONST];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x % S;
  u64 d[E];
  load_consts<S>(k, d, consts, g);
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / S;
  const bool valid = row < n;
  u64 s[E];
#pragma unroll
  for (int j = 0; j < E; ++j) s[j] = valid ? in[row * 8 + g * E + j] : 0ULL;
  permute<S>(s, k, d, g, lane);
  if (valid) {
#pragma unroll
    for (int j = 0; j < E; ++j) out[row * 8 + g * E + j] = s[j];
  }
}

// Row i of `rows` (n, L): state = 0; for each absorb of w = min(4, L - pos)
// words, state[0:w] = rows[i, pos:pos+w] (overwrite, state[w:8] kept), then
// permute; digest = state[0:4].  The next absorb's words are loaded before
// the permutation so that their latency hides behind it.
template <int S>
__global__ void __launch_bounds__(P8_MAX_BLOCK)
    sponge8_kernel(const u64 *__restrict__ rows, u64 *__restrict__ out,
                   const u64 *__restrict__ consts, long long n, long long L) {
  constexpr int E = 8 / S;
  __shared__ u64 k[P8_NCONST];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x % S;
  u64 d[E];
  load_consts<S>(k, d, consts, g);
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / S;
  const bool valid = row < n;
  const u64 *src = rows + (valid ? row : 0) * L;
  u64 s[E], w[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    s[j] = 0ULL;
    const int e = g * E + j;
    w[j] = (valid && e < 4 && e < L) ? src[e] : 0ULL;
  }
  for (long long pos = 0; pos < L; pos += 4) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = g * E + j;
      if (e < 4 && pos + e < L) s[j] = w[j];
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = g * E + j;
      if (valid && e < 4 && pos + 4 + e < L) w[j] = src[pos + 4 + e];
    }
    permute<S>(s, k, d, g, lane);
  }
  if (valid) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = g * E + j;
      if (e < 4) out[row * 4 + e] = s[j];
    }
  }
}

#ifdef P8_STRAIGHT_LINE
template __global__ void perm8_kernel<1>(const u64 *, u64 *, const u64 *,
                                         long long);
#else
namespace {

template <int S>
int launch_perm8(const u64 *in, u64 *out, const u64 *consts, long long n,
                 cudaStream_t stream) {
  const int bt = block_threads(n * S);
  const unsigned blocks = (unsigned)((n * S + bt - 1) / bt);
  perm8_kernel<S><<<blocks, bt, 0, stream>>>(in, out, consts, n);
  return (int)cudaGetLastError();
}

template <int S>
int launch_sponge8(const u64 *rows, u64 *out, const u64 *consts, long long n,
                   long long L, cudaStream_t stream) {
  const int bt = block_threads(n * S);
  const unsigned blocks = (unsigned)((n * S + bt - 1) / bt);
  sponge8_kernel<S><<<blocks, bt, 0, stream>>>(rows, out, consts, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

#define P8_DISPATCH(fn, lanes, ...)                                 \
  switch (lanes) {                                                  \
    case 1: return fn<1>(__VA_ARGS__);                              \
    case 2: return fn<2>(__VA_ARGS__);                              \
    case 4: return fn<4>(__VA_ARGS__);                              \
    case 8: return fn<8>(__VA_ARGS__);                              \
    default: return (int)cudaErrorInvalidValue;                     \
  }

extern "C" {

// Each returns the cudaError_t of the launch (0 = success).  `lanes` is S.
int lt_perm8(const u64 *in, u64 *out, const u64 *consts, long long n,
             int lanes, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  P8_DISPATCH(launch_perm8, lanes, in, out, consts, n, stream)
}

int lt_sponge8(const u64 *rows, u64 *out, const u64 *consts, long long n,
               long long L, int lanes, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  P8_DISPATCH(launch_sponge8, lanes, rows, out, consts, n, L, stream)
}

}  // extern "C"
#endif  // P8_STRAIGHT_LINE
