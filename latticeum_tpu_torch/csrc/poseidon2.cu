// Batched Poseidon2 width-8 permutation over Goldilocks, for sm_90a.
//
// Replaces the Pallas kernel of latticeum_tpu/parallel/pallas_kernels.py:109
// (make_perm8_kernel / perm8_pallas), the JAX package's batched form of
// crypto/poseidon2.py::perm8.  The wrapper and the plain-torch twin are in
// crypto/poseidon2.py; the sponge and the Merkle levels built on it stay in
// torch there.  This kernel computes the permutation only: (n, 8) u64
// states in, a fresh (n, 8) array out.
//
// One permutation: the initial external linear layer, 4 external rounds
// (8 s-boxes x^7, linear layer), 22 internal rounds (one s-box, then the
// diagonal-plus-ones matrix), 4 external rounds.  That is 520 Goldilocks
// multiplies (8 x 8 x 4 in the s-boxes of the external rounds, 22 x (4 + 8)
// in the internal ones) and 722 gl_add calls (9 x 34 in the linear layers,
// of them 36 doublings; 64 round-constant additions; 22 x 16 in the
// internal rounds), against 128 bytes of state read and written.
//
// What bounds it on the card: the integer ALU, not bytes.  Built for
// sm_90a the kernel is 26,145 SASS instructions per state (cuobjdump;
// chip_smoke.py counts them): 7,045 IMAD on the FMA pipe and 18,903
// integer ALU instructions, each pipe 64 lanes per SM per clock.  At
// n = 8192 (the 8 MB memory tree's leaf level) the ALU takes at least
// 9.3 us at 132 SMs x 1.98 GHz, against 0.3 us for the 1 MiB moved.  The
// design keeps the whole state in registers, one thread per state, and
// reads the 94 round constants from shared memory (every thread of a warp
// reads the same word: a broadcast).  At n = 8192 only 64 blocks of 128
// threads run, one warp per scheduler on 64 SMs: each warp waits on its
// own dependent chain, and a launch takes about 72 us at n = 1024 and at
// n = 8192 alike (H100 80GB HBM3 at 700 W, the kernel's duration in a
// torch.profiler trace); with the card full (n = 524288) it reaches about
// 65 % of the bound.  Making it fast at the tree's shapes (several states per
// thread in flight, or the 64 sponge absorbs of a page fused into one
// launch) is later work.
//
// The round constants come from the caller as one device array of 94 u64
// (crypto/poseidon2.py builds it from host/crypto/consts.py, the single
// source of truth): [0, 32) the 4 x 8 initial external constants,
// [32, 64) the 4 x 8 terminal ones, [64, 86) the 22 internal ones,
// [86, 94) the internal diagonal.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define P8_BLOCK 128
#define P8_EXT_INIT 0
#define P8_EXT_TERM 32
#define P8_INTERNAL 64
#define P8_DIAG 86
#define P8_NCONST 94

namespace {

__device__ __forceinline__ u64 sbox7(u64 x) {
  const u64 x2 = gl_mul(x, x);
  const u64 x4 = gl_mul(x2, x2);
  const u64 x6 = gl_mul(x4, x2);
  return gl_mul(x6, x);
}

// M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on s[o..o+3] (the addition
// chain of Plonky3's apply_mat4: 9 additions and 2 doublings).
__device__ __forceinline__ void m4(u64 (&s)[8], int o) {
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

// The external linear layer: M4 on each half, then add the column sums.
__device__ __forceinline__ void mds_light8(u64 (&s)[8]) {
  m4(s, 0);
  m4(s, 4);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const u64 sum = gl_add(s[k], s[k + 4]);
    s[k] = gl_add(s[k], sum);
    s[k + 4] = gl_add(s[k + 4], sum);
  }
}

__device__ __forceinline__ void external_round(u64 (&s)[8],
                                               const u64 *__restrict__ rc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = sbox7(gl_add(s[i], rc[i]));
  mds_light8(s);
}

}  // namespace

__global__ void __launch_bounds__(P8_BLOCK)
    perm8_kernel(const u64 *__restrict__ in, u64 *__restrict__ out,
                 const u64 *__restrict__ consts, long long n) {
  __shared__ u64 k[P8_NCONST];
  for (int i = threadIdx.x; i < P8_NCONST; i += P8_BLOCK) k[i] = consts[i];
  __syncthreads();
  const long long row = (long long)blockIdx.x * P8_BLOCK + threadIdx.x;
  if (row >= n) return;
  u64 s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = in[row * 8 + i];

  mds_light8(s);
#pragma unroll
  for (int r = 0; r < 4; ++r) external_round(s, k + P8_EXT_INIT + 8 * r);
#pragma unroll
  for (int r = 0; r < 22; ++r) {
    s[0] = sbox7(gl_add(s[0], k[P8_INTERNAL + r]));
    u64 tot = s[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) tot = gl_add(tot, s[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = gl_add(gl_mul(s[i], k[P8_DIAG + i]), tot);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) external_round(s, k + P8_EXT_TERM + 8 * r);

#pragma unroll
  for (int i = 0; i < 8; ++i) out[row * 8 + i] = s[i];
}

extern "C" {

// Returns the cudaError_t of the launch (0 = success).
int lt_perm8(const u64 *in, u64 *out, const u64 *consts, long long n,
             cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + P8_BLOCK - 1) / P8_BLOCK);
  perm8_kernel<<<blocks, P8_BLOCK, 0, stream>>>(in, out, consts, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
