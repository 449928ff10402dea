// The lin sum-check's reconstruction tail in one launch, for sm_90a.
//
// Replaces a function that the JAX package computes in XLA, with no Pallas
// kernel: the reconstruction rounds of a truncated lin stack in
// latticeum_tpu/zkvm/accel_dev_fs.py:212 run_fixed_phase_dev (:314-353),
// the Mz rows folded into column 0 of a 2^(nv - r) wide table under the eq
// row of the remaining betas, then nv - r unfactored rounds, each followed
// by the duplex challenger.  The wrapper and the plain-torch twin are
// zkvm/comb.py lin_recon_tail and lin_recon_tail_twin, which state what it
// computes.
//
// lin_recon_tail_kernel: one thread-block cluster of RC_CLUSTER = 8 blocks,
// block s the ring slot s (3 of the 24 values of every row).
//  * Set-up: each block folds its slot of the Mz rows at chals[r - 1] into
//    column 0 of its table (zero past it), builds the eq row of the betas
//    (t-layout: column x is prod_k of beta_{n-1-k} or 1 - beta_{n-1-k} by
//    bit k of x) and stages the multisets (CSR, signs or its slot of the
//    ring constants) in shared memory.  The table, (t + 1) x 3 x 2^(nv-r)
//    words (126 x 3 x 8 x 8 B = 24 KB on the main path), stays in shared
//    memory for the whole launch and is folded in place at each challenge:
//    after the first loads no round reads device memory.
//  * A round (width w = 2h): its work items are (point t, column x,
//    multiset group g), the npts x h (t, x) pairs each split over G =
//    RC_THREADS / (npts h) groups (at most the multiset count).  The
//    multisets are dealt to the groups in order of size, largest first,
//    round robin, so a thread's product chains are about even (the zkVM's
//    52 multisets have sizes 7 (7 of them), 4, 3, 2, 1: a group of 14
//    multiplies at most 8 values a point).  A thread forms sum_i c_i
//    prod_{j in S_i} f_t[j](x), f_t = v0 + t (v1 - v0), times the eq row
//    at (t, x); one warp a point adds its items (shuffles), times the
//    scale, and writes the value to msgs[k] and, through distributed
//    shared memory, into block 0's buffer behind the pending values.  One
//    owner a sum, no atomics.
//  * The challenger, inside the launch: after a cluster barrier, warp 0 of
//    block 0 runs round_tail_kernel's unweighted absorb and sample loop
//    (csrc/challenger.cu) with permute16 of csrc/challenger.cuh, its state
//    held in registers from round to round; it writes chals[k], and the
//    challenge into its shared memory, where after a second cluster barrier
//    every block reads it and folds its table.  After round nv - 1 each
//    block folds its rows once more and writes them to final, the eq row
//    times the scale.
//
// What bounds it: a serial chain.  Each round's challenge needs its
// message, and the next round's sums need the challenge, so the round
// tails' permutations (ceil(L / 12) + 2 a round, L = 3 + 24 npts: 21 on the
// main path, 63 in all) are on the chain, each about 7 us of dependent
// 64-bit multiplies and shuffles (csrc/challenger.cu).  The design puts the
// whole tail in one launch so that nothing but the permutations and the
// rounds' own work lies on the chain: no launch gaps, no round trip of the
// sums, the table or the challenge through device memory.  Its floor is
// perm16_chain at the tail's permutations.  On an NVIDIA H100 80GB HBM3 at
// 700 W, at the main path's shape (scripts/recon_trials.py builds and
// times these variants): 0.5547 ms against that floor's 0.4476 ms; built
// without the permutations 0.0831 ms, without the sums 0.5036 ms, without
// both 0.0343 ms.  So the sums take about 0.051 ms (0.075 ms with the
// multisets in index order: a round waits for its longest product
// chains), the set-up, barriers and folds about 0.030 ms, and the
// permutations run about 6 % slower here than in perm16_chain; two
// product chains a thread (0.5650), a non-inlined challenger (0.5574), a
// block barrier for block 0's idle warps (0.5554), the challenge read
// once a block (0.5567) and blocks of 1024 threads (0.5814) were no
// faster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "challenger.cuh"
#include "field.cuh"

using namespace lt;
namespace cg = cooperative_groups;

#define RC_CLUSTER 8        // blocks a launch, one a ring slot
#define RC_THREADS 512
#define RC_MAX_PTS 12       // message points (comb.MAX_LIN_PTS)
#define RC_MAX_ROUNDS 5     // table width at most 32: npts h <= RC_THREADS
#define RC_MAX_PENDING 11

namespace {

// Row j of the table T (rows, 3, W) at column x, as an Fq3 value.
__device__ __forceinline__ Fq3 tget(const u64 *T, int W, int j, int x) {
  const u64 *p = T + (long long)j * 3 * W + x;
  return Fq3{p[0], p[W], p[2 * W]};
}

__device__ __forceinline__ void tput(u64 *T, int W, int j, int x,
                                     const Fq3 &v) {
  u64 *p = T + (long long)j * 3 * W + x;
  p[0] = v.c0;
  p[W] = v.c1;
  p[2 * W] = v.c2;
}

__device__ __forceinline__ Fq3 get3(const u64 *p) {
  return Fq3{p[0], p[1], p[2]};
}

__device__ __forceinline__ void put3(u64 *p, const Fq3 &v) {
  p[0] = v.c0;
  p[1] = v.c1;
  p[2] = v.c2;
}

// v0 + t (v1 - v0) of row j: v0 at column x, v1 at column h + x.
__device__ __forceinline__ Fq3 at_point(const u64 *T, int W, int j, int x,
                                        int h, u64 t) {
  const Fq3 v0 = tget(T, W, j, x);
  const Fq3 d = fq3_sub(tget(T, W, j, h + x), v0);
  return fq3_add(v0, Fq3{gl_mul(d.c0, t), gl_mul(d.c1, t), gl_mul(d.c2, t)});
}

__device__ __forceinline__ Fq3 shfl_down3(const Fq3 &v, int d) {
  return Fq3{__shfl_down_sync(CH_FULL, v.c0, d),
             __shfl_down_sync(CH_FULL, v.c1, d),
             __shfl_down_sync(CH_FULL, v.c2, d)};
}

// The dynamic shared memory of a launch: the table (rows, 3, W), the ring
// constants of the block's slot (nsets, 3) where given, then the CSR
// offsets, indices, signs and the order of the multisets by size.
__host__ __device__ __forceinline__ size_t rc_smem_bytes(int rows, int W,
                                                         int nsets, int nnz,
                                                         bool ring) {
  return 8 * ((size_t)rows * 3 * W + (ring ? 3 * (size_t)nsets : 0)) +
         4 * ((size_t)nsets + 1 + nnz + 2 * (size_t)nsets);
}

}  // namespace

// mz (t_rows, 24, 2) folded at chals[r - 1], or (t_rows, 24, 1) at r = 0;
// betas (nv - r, 3); scale (3,); state (16,) updated; pend (npend,) what
// round r observes first (the exported input at r = 0, chals[r - 1]
// after); msgs (nv, npts, 24) and chals (nv, 3) get rows r .. nv - 1;
// final (t_rows + 1, 24).
__global__ void __cluster_dims__(RC_CLUSTER, 1, 1)
    __launch_bounds__(RC_THREADS)
    lin_recon_tail_kernel(const u64 *__restrict__ mz, int t_rows,
                          const u64 *__restrict__ betas,
                          const u64 *__restrict__ scale, u64 *state,
                          const u64 *pend, int npend, u64 *msgs, u64 *chals,
                          const u64 *__restrict__ consts,
                          const int *__restrict__ set_off,
                          const int *__restrict__ set_idx,
                          const int *__restrict__ set_sign,
                          const u64 *__restrict__ set_c, int nsets, int nnz,
                          int npts, int nv, int r, u64 *__restrict__ final) {
  extern __shared__ __align__(16) u64 rc_smem[];
  __shared__ u64 kt[CH_TABLE];                          // block 0
  __shared__ u64 buf[RC_MAX_PENDING + 24 * RC_MAX_PTS];  // block 0
  __shared__ u64 chal[3];                                // block 0
  __shared__ Fq3 part[RC_THREADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int slot = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = t_rows + 1, nr = nv - r, W = 1 << nr;
  const bool ring = set_c != nullptr;
  u64 *T = rc_smem;
  u64 *cs = T + (size_t)rows * 3 * W;
  int *off = (int *)(cs + (ring ? 3 * nsets : 0));
  int *idx = off + nsets + 1;
  int *sgn = idx + nnz;
  int *order = sgn + nsets;

  // -- set-up: the multisets, the table, the challenger's constants
  for (int i = tid; i <= nsets; i += RC_THREADS) off[i] = set_off[i];
  for (int i = tid; i < nnz; i += RC_THREADS) idx[i] = set_idx[i];
  for (int i = tid; i < nsets; i += RC_THREADS) {
    if (ring)
      put3(cs + 3 * i, get3(set_c + (long long)i * 24 + 3 * slot));
    else
      sgn[i] = set_sign[i];
  }
  const Fq3 rho0 = r ? get3(chals + 3 * (r - 1)) : fq3_zero();
  for (int i = tid; i < t_rows * W; i += RC_THREADS) {
    const int j = i >> nr, x = i & (W - 1);
    Fq3 v = fq3_zero();
    if (x == 0) {
      const u64 *m = mz + ((long long)j * 24 + 3 * slot) * (r ? 2 : 1);
      if (r) {
        const Fq3 a = Fq3{m[0], m[2], m[4]};
        const Fq3 b = Fq3{m[1], m[3], m[5]};
        v = fq3_add(a, fq3_mul(rho0, fq3_sub(b, a)));
      } else {
        v = get3(m);
      }
    }
    tput(T, W, j, x, v);
  }
  for (int x = tid; x < W; x += RC_THREADS) {
    Fq3 e = Fq3{1ULL, 0ULL, 0ULL};
    for (int k = 0; k < nr; ++k) {
      const Fq3 b = get3(betas + 3 * (nr - 1 - k));
      e = fq3_mul(e, (x >> k) & 1 ? b
                                  : fq3_sub(Fq3{1ULL, 0ULL, 0ULL}, b));
    }
    tput(T, W, t_rows, x, e);
  }
  u64 s = 0ULL, diag = 0ULL;
  const bool chain = slot == 0 && warp == 0;
  if (slot == 0) {
    load_consts(kt, consts);
    for (int i = tid; i < npend; i += RC_THREADS) buf[i] = pend[i];
    if (chain) {
      s = state[lane & 15];
      diag = consts[CH_DIAG + (lane & 15)];
    }
  }
  __syncthreads();
  // the multisets by size, largest first (ties by index): order[rank] = i
  for (int i = tid; i < nsets; i += RC_THREADS) {
    const int si = off[i + 1] - off[i];
    int rank = 0;
    for (int i2 = 0; i2 < nsets; ++i2) {
      const int s2 = off[i2 + 1] - off[i2];
      rank += s2 > si || (s2 == si && i2 < i);
    }
    order[rank] = i;
  }
  // every block of the cluster runs before any reads another's memory
  cluster.sync();

  u64 *buf0 = cluster.map_shared_rank(buf, 0);
  const u64 *chal0 = cluster.map_shared_rank(chal, 0);
  const Fq3 sc = get3(scale);
  for (int k = r; k < nv; ++k) {
    const int h = (W >> (k - r)) >> 1, npairs = npts * h;
    int G = RC_THREADS / npairs;
    G = G < 1 ? 1 : (G > nsets ? nsets : G);
    if (tid < npairs * G) {
      const int g = tid % G, p = tid / G, x = p % h;
      const u64 t = (u64)(p / h);
      Fq3 acc = fq3_zero();
      for (int rk = g; rk < nsets; rk += G) {
        const int i = order[rk];
        Fq3 prod = at_point(T, W, idx[off[i]], x, h, t);
        for (int kk = off[i] + 1; kk < off[i + 1]; ++kk)
          prod = fq3_mul(prod, at_point(T, W, idx[kk], x, h, t));
        if (ring)
          acc = fq3_add(acc, fq3_mul(prod, get3(cs + 3 * i)));
        else if (sgn[i] > 0)
          acc = fq3_add(acc, prod);
        else
          acc = fq3_sub(acc, prod);
      }
      part[tid] = fq3_mul(acc, at_point(T, W, t_rows, x, h, t));
    }
    __syncthreads();
    const int npk = k == r ? npend : 3;
    if (warp < npts) {  // point t = warp: its h G items are part[t h G ...]
      const int n = h * G;
      Fq3 a = fq3_zero();
      for (int u = lane; u < n; u += 32) a = fq3_add(a, part[warp * n + u]);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) a = fq3_add(a, shfl_down3(a, d));
      if (lane == 0) {
        const Fq3 m = fq3_mul(a, sc);
        put3(msgs + ((long long)k * npts + warp) * 24 + 3 * slot, m);
        put3(buf0 + npk + warp * 24 + 3 * slot, m);
      }
    }
    cluster.sync();
    if (chain) {
      // round_tail_kernel's unweighted absorb and sample (challenger.cu)
      const int e = lane & 15;
      const int L = npk + 24 * npts;
      const int nabs = (L + CH_RATE - 1) / CH_RATE;
      u64 c0 = 0, c1 = 0, c2 = 0, ce = 0;
      for (int c = 0; c < nabs + 2; ++c) {
        if (c == nabs) {
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
      if (lane == 0) {
        const Fq3 cv = Fq3{c0, c1, c2};
        put3(chals + 3 * k, cv);
        put3(chal, cv);
        put3(buf, cv);  // what the next round observes first
      }
      if (k == nv - 1 && lane < CH_WIDTH) state[lane] = s;
    }
    cluster.sync();
    const Fq3 rho = get3(chal0);
    if (k < nv - 1) {  // fold in place: columns x < h
      for (int i = tid; i < rows * h; i += RC_THREADS) {
        const int j = i / h, x = i % h;
        const Fq3 a = tget(T, W, j, x);
        tput(T, W, j, x,
             fq3_add(a, fq3_mul(rho, fq3_sub(tget(T, W, j, h + x), a))));
      }
      __syncthreads();
    } else {           // the final rows, the eq row scaled
      for (int j = tid; j < rows; j += RC_THREADS) {
        const Fq3 a = tget(T, W, j, 0);
        Fq3 v = fq3_add(a, fq3_mul(rho, fq3_sub(tget(T, W, j, 1), a)));
        if (j == t_rows) v = fq3_mul(v, sc);
        put3(final + (long long)j * 24 + 3 * slot, v);
      }
    }
  }
  cluster.sync();  // block 0's challenge stays until every block read it
}

extern "C" {

// Returns the cudaError_t of the launch (0 = success).  The dynamic shared
// memory attribute is set before every launch: it belongs to a device.
int lt_lin_recon_tail(const u64 *mz, int t_rows, const u64 *betas,
                      const u64 *scale, u64 *state, const u64 *pend,
                      int npend, u64 *msgs, u64 *chals, const u64 *consts,
                      const int *set_off, const int *set_idx,
                      const int *set_sign, const u64 *set_c, int nsets,
                      int nnz, int npts, int nv, int r, u64 *final,
                      cudaStream_t stream) {
  const int nr = nv - r;
  if (t_rows < 1 || nsets < 1 || nnz < 1 || npts < 1 || npts > RC_MAX_PTS ||
      r < 0 || nr < 1 || nr > RC_MAX_ROUNDS || npend < 0 ||
      npend > RC_MAX_PENDING || (set_sign == nullptr) == (set_c == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      rc_smem_bytes(t_rows + 1, 1 << nr, nsets, nnz, set_c != nullptr);
  const cudaError_t set = cudaFuncSetAttribute(
      lin_recon_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (set != cudaSuccess) return (int)set;
  lin_recon_tail_kernel<<<RC_CLUSTER, RC_THREADS, smem, stream>>>(
      mz, t_rows, betas, scale, state, pend, npend, msgs, chals, consts,
      set_off, set_idx, set_sign, set_c, nsets, nnz, npts, nv, r, final);
  return (int)cudaGetLastError();
}

}  // extern "C"
