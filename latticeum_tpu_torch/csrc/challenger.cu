// The Poseidon2 width-16 duplex challenger and the tail of a chained
// sum-check round, for sm_90a.
//
// Replaces the JAX package's device Fiat-Shamir, plain XLA there with no
// Pallas kernel: the challenger of latticeum_tpu/zkvm/accel_dev_fs.py
// (perm16_dev, challenger_step, :56-172; _eqf_dev, :175) and the small
// kernels it chains after each round's comb in
// latticeum_tpu/zkvm/accel_rounds.py (_make_weight_lin, _make_weight_fold,
// :303-356; _make_chal_fn, :358; _eupd_fn, _eupd3_fn, :372-391).  The
// wrappers and the plain-torch twins are in crypto/challenger.py, which
// states what round_tail computes.
//
// round_tail_kernel: one launch per sum-check round, one block.  Its
// threads first build the round message, a thread per (point, slot): the
// round's sums extended to the message points by the Lagrange rows and
// weighted by E_k * eqf(point_k, t), summed over the tables (or the sums as
// they are, unweighted).  The message goes to msgs[r] and to shared memory
// beside the pending values.  Then one warp runs the challenger over them
// (full 12-value chunks overwrite state[0:12] and permute, the rest is
// duplexed once more, the challenge is lanes 11, 10, 9, then two chunks of
// the tiled challenge), and a thread per table updates E.
//
// What bounds it: a serial chain.  A round observes L = pending + 24 n_msg
// values, ceil(L / 12) + 2 permutations (13 for a production fold round,
// 21 for a lin round), each 30 rounds of dependent 64-bit modular
// multiplies; the message and E are a few hundred multiplies spread over
// the threads.  The work of the permutations is tiny against the card
// (chip_smoke.py counts one permutation's SASS in the straight-line
// one-thread form of the CH_STRAIGHT_LINE build); one chain cannot fill it,
// so the design shortens the chain.  One warp holds the state, lane i (and
// lane i + 16, a copy) element i: with the whole state in one lane, the
// lane would issue the straight-line form's 52,000 instructions a
// permutation, at most one a clock, which is slower than the chain.  So
// each round's s-boxes run side by side and the linear layers are
// shuffles.  What is on the chain (permute16 below):
//  * the s-box at multiply depth 3 (x^2; x^3 and x^4; x^7);
//  * in an internal round, the sum of elements 1 ... 15 runs as a
//    butterfly beside the s-box of element 0, which every lane computes
//    (no divergent branch) and one shuffle broadcasts, so the round is the
//    s-box, one multiply and two adds;
//  * the linear layers add without reducing: a sum is kept as a 96-bit
//    integer (three 32-bit words, one carry chain a step) and folded mod p
//    once, so a butterfly level is a shuffle and three dependent adds;
//    values between rounds stay below 2^64 but not canonical (gl_mul takes
//    any u64), and only the permutation's output is made canonical;
//  * the next round's constant is read from shared memory one round ahead
//    and added inside the fold.
// The 22 internal rounds are unrolled and the external round loops stay
// loops: on an NVIDIA H100 80GB HBM3 at 700 W a fold round took 0.1224 ms
// with every loop kept, 0.1076, 0.1040 and 0.1031 ms with the internal
// loop unrolled 2, 11 and 22 times, and 0.1072 ms with the external loops
// unrolled as well (the permutations alone 0.0977 to 0.0958 ms).  One warp
// runs this code, so it does not meet the instruction-cache limit that
// made unrolled perm8, with many warps, 2.4x slower (csrc/poseidon2.cu).
// The first design (one element a lane, the s-box in lane 0 behind a
// branch, then a 4-level butterfly of canonical adds; the constants read
// on the chain) took 11.9 us a permutation on the same card.
// perm16_chain_kernel runs n permutations of one state and nothing else:
// its time at a round's count is the latency floor of this design.
//
// The constants come from the caller as one device array of 166 u64
// (crypto/challenger.py builds it from host/crypto/consts.py): [0, 64) the
// 4 x 16 initial external constants, [64, 128) the terminal ones,
// [128, 150) the 22 internal ones, [150, 166) the internal diagonal.  Each
// launch lays them out per lane in shared memory (load_consts).

#include <cuda_runtime.h>

#include "challenger.cuh"
#include "field.cuh"

using namespace lt;

#ifdef CH_STRAIGHT_LINE
// One permutation as straight-line code in one thread, for measurement
// only: chip_smoke.py counts its SASS as the work of one permutation.
namespace {

__device__ __forceinline__ void mds16(u64 (&s)[CH_WIDTH]) {
#pragma unroll
  for (int o = 0; o < CH_WIDTH; o += 4) {
    const u64 t = gl_add(gl_add(s[o], s[o + 1]), gl_add(s[o + 2], s[o + 3]));
    u64 d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const u64 nx = s[o + ((i + 1) & 3)];
      d[i] = gl_add(gl_add(t, s[o + i]), gl_add(nx, nx));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[o + i] = d[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const u64 col =
        gl_add(gl_add(s[i], s[i + 4]), gl_add(s[i + 8], s[i + 12]));
#pragma unroll
    for (int o = 0; o < CH_WIDTH; o += 4) s[o + i] = gl_add(s[o + i], col);
  }
}

__device__ __forceinline__ void external(u64 (&s)[CH_WIDTH], const u64 *rc) {
#pragma unroll
  for (int i = 0; i < CH_WIDTH; ++i) s[i] = gl_pow7(gl_add(s[i], rc[i]));
  mds16(s);
}

}  // namespace

extern "C" __global__ void perm16_straight_kernel(
    u64 *st, const u64 *__restrict__ k) {
  u64 s[CH_WIDTH];
#pragma unroll
  for (int i = 0; i < CH_WIDTH; ++i) s[i] = st[CH_WIDTH * threadIdx.x + i];
  mds16(s);
#pragma unroll
  for (int r = 0; r < 4; ++r) external(s, k + CH_EXT_INIT + CH_WIDTH * r);
#pragma unroll
  for (int r = 0; r < 22; ++r) {
    s[0] = gl_pow7(gl_add(s[0], k[CH_INTERNAL + r]));
    u64 tot = s[0];
#pragma unroll
    for (int i = 1; i < CH_WIDTH; ++i) tot = gl_add(tot, s[i]);
#pragma unroll
    for (int i = 0; i < CH_WIDTH; ++i)
      s[i] = gl_add(gl_mul(s[i], k[CH_DIAG + i]), tot);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) external(s, k + CH_EXT_TERM + CH_WIDTH * r);
#pragma unroll
  for (int i = 0; i < CH_WIDTH; ++i) st[CH_WIDTH * threadIdx.x + i] = s[i];
}

#else

#define RT_THREADS 128
#define RT_MAX_TABLES 3
#define RT_MAX_MSG 16
#define RT_MAX_ROWS 16
#define RT_MAX_PENDING 11

namespace {

__device__ __forceinline__ Fq3 load3(const u64 *p) {
  return Fq3{p[0], p[1], p[2]};
}

__device__ __forceinline__ void store3(u64 *p, const Fq3 &v) {
  p[0] = v.c0;
  p[1] = v.c1;
  p[2] = v.c2;
}

// eqf(b, t) = b (2t - 1) + (1 - t) at the integer point t >= 0.
__device__ __forceinline__ Fq3 eqf_t(const Fq3 &b, int t) {
  const u64 s = t == 0 ? P - 1 : (u64)(2 * t - 1);
  const u64 c = t <= 1 ? (u64)(1 - t) : P - (u64)(t - 1);
  return Fq3{gl_add(gl_mul(b.c0, s), c), gl_mul(b.c1, s), gl_mul(b.c2, s)};
}

// eqf(b, r) = 1 - b - r + 2br.
__device__ __forceinline__ Fq3 eqf_at(const Fq3 &b, const Fq3 &r) {
  const Fq3 br = fq3_mul(b, r);
  const Fq3 one = Fq3{1ULL, 0ULL, 0ULL};
  return fq3_add(fq3_sub(fq3_sub(one, b), r), fq3_add(br, br));
}

}  // namespace

// sums (rows, 24); weighted: lag (tables, n_msg, rows), points
// (tables, nv, 3), E (tables, 3) updated in place.  state (16,) updated in
// place; pend (npend,), which may be row r - 1 of chals; msgs
// (nv, n_msg, 24) and chals (nv, 3) get row r.
__global__ void __launch_bounds__(RT_THREADS)
    round_tail_kernel(const u64 *__restrict__ sums,
                      const u64 *__restrict__ lag,
                      const u64 *__restrict__ points, u64 *E, u64 *state,
                      const u64 *pend, u64 *msgs, u64 *chals,
                      const u64 *__restrict__ consts, int tables, int n_msg,
                      int rows, int npend, int nv, int r, int weighted) {
  __shared__ u64 kt[CH_TABLE];
  __shared__ u64 buf[RT_MAX_PENDING + 24 * RT_MAX_MSG];
  __shared__ Fq3 w[RT_MAX_TABLES * RT_MAX_MSG];
  __shared__ u64 chal[3];
  const int tid = threadIdx.x;
  load_consts(kt, consts);
  for (int i = tid; i < npend; i += blockDim.x) buf[i] = pend[i];
  if (weighted) {
    for (int i = tid; i < tables * n_msg; i += blockDim.x) {
      const int tb = i / n_msg;
      const Fq3 b = load3(points + ((long long)tb * nv + r) * 3);
      w[i] = fq3_mul(load3(E + 3 * tb), eqf_t(b, i % n_msg));
    }
  }
  __syncthreads();

  u64 *msg = msgs + (long long)r * n_msg * 24;
  for (int i = tid; i < n_msg * 8; i += blockDim.x) {
    const int t = i >> 3;
    const int slot = i & 7;
    Fq3 acc;
    if (weighted) {
      acc = fq3_zero();
      for (int tb = 0; tb < tables; ++tb) {
        const u64 *l = lag + ((long long)tb * n_msg + t) * rows;
        Fq3 v = fq3_zero();
        for (int j = 0; j < rows; ++j) {
          const u64 lj = l[j];
          if (lj == 0ULL) continue;
          const Fq3 sj = load3(sums + j * 24 + 3 * slot);
          v = Fq3{gl_add(v.c0, gl_mul(lj, sj.c0)),
                  gl_add(v.c1, gl_mul(lj, sj.c1)),
                  gl_add(v.c2, gl_mul(lj, sj.c2))};
        }
        acc = fq3_add(acc, fq3_mul(w[tb * n_msg + t], v));
      }
    } else {
      acc = load3(sums + t * 24 + 3 * slot);
    }
    store3(buf + npend + t * 24 + 3 * slot, acc);
    store3(msg + t * 24 + 3 * slot, acc);
  }
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    const int e = lane & 15;
    const u64 diag = consts[CH_DIAG + e];
    u64 s = state[e];
    const int L = npend + 24 * n_msg;
    // the absorbs: full chunks, then the rest (none when L % 12 == 0: the
    // last chunk's duplex refilled the output buffer, so the sample pops
    // without another permutation); then two chunks of the tiled
    // challenge.  One loop, so the permutation's code is one copy.
    const int nabs = (L + CH_RATE - 1) / CH_RATE;
    u64 c0 = 0, c1 = 0, c2 = 0, ce = 0;
    for (int c = 0; c < nabs + 2; ++c) {
      if (c == nabs) {                  // the sample, warp-uniform
        c0 = __shfl_sync(CH_FULL, s, 11);
        c1 = __shfl_sync(CH_FULL, s, 10);
        c2 = __shfl_sync(CH_FULL, s, 9);
        ce = e % 3 == 0 ? c0 : (e % 3 == 1 ? c1 : c2);
      }
      if (c < nabs) {
        if (e < min(CH_RATE, L - CH_RATE * c)) s = buf[CH_RATE * c + e];
      } else if (e < CH_RATE) {
        s = ce;
      }
      s = permute16(s, kt, diag, lane);
    }
    if (lane < CH_WIDTH) state[lane] = s;
    if (lane == 0) {
      chal[0] = c0;
      chal[1] = c1;
      chal[2] = c2;
      store3(chals + 3 * r, Fq3{c0, c1, c2});
    }
  }
  __syncthreads();

  if (weighted && tid < tables) {
    const Fq3 b = load3(points + ((long long)tid * nv + r) * 3);
    store3(E + 3 * tid, fq3_mul(load3(E + 3 * tid),
                                eqf_at(b, Fq3{chal[0], chal[1], chal[2]})));
  }
}

// n permutations of one state (16,), in place, by one warp.
__global__ void __launch_bounds__(32)
    perm16_chain_kernel(u64 *state, const u64 *__restrict__ consts, int n) {
  __shared__ u64 kt[CH_TABLE];
  load_consts(kt, consts);
  __syncthreads();
  const int lane = threadIdx.x;
  const u64 diag = consts[CH_DIAG + (lane & 15)];
  u64 s = state[lane & 15];
  for (int i = 0; i < n; ++i) s = permute16(s, kt, diag, lane);
  if (lane < CH_WIDTH) state[lane] = s;
}

extern "C" {

// Each returns the cudaError_t of its launch (0 = success).
int lt_round_tail(const u64 *sums, const u64 *lag, const u64 *points, u64 *E,
                  u64 *state, const u64 *pend, u64 *msgs, u64 *chals,
                  const u64 *consts, int tables, int n_msg, int rows,
                  int npend, int nv, int r, int weighted,
                  cudaStream_t stream) {
  if (n_msg < 1 || n_msg > RT_MAX_MSG || npend < 0 ||
      npend > RT_MAX_PENDING || r < 0 || r >= nv ||
      (weighted && (tables < 1 || tables > RT_MAX_TABLES || rows < 1 ||
                    rows > RT_MAX_ROWS)) ||
      (!weighted && rows != n_msg))
    return (int)cudaErrorInvalidValue;
  round_tail_kernel<<<1, RT_THREADS, 0, stream>>>(
      sums, lag, points, E, state, pend, msgs, chals, consts, tables, n_msg,
      rows, npend, nv, r, weighted);
  return (int)cudaGetLastError();
}

int lt_perm16_chain(u64 *state, const u64 *consts, int n,
                    cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  perm16_chain_kernel<<<1, 32, 0, stream>>>(state, consts, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // CH_STRAIGHT_LINE
