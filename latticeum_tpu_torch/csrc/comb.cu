// The four sum-check comb kernels of the IVC fold step, for sm_90a.
//
// Replace the Pallas kernels of latticeum_tpu/zkvm/pallas_comb.py:
//   fold_round0_kernel  <- fold_round0_pallas   (pallas_comb.py:117)
//   fold_roundr_kernel  <- fold_roundr_pallas   (pallas_comb.py:176)
//   lin_round0_kernel   <- lin_round0_pallas    (pallas_comb.py:317)
//   lin_roundr_kernel   <- lin_roundr_pallas    (pallas_comb.py:365)
// and the XLA half of the fold round, the c terms and the eq pair sums
// around the Pallas tail comb (accel_rounds.py:403 _make_round_pallas),
// with the lin rounds' eq pair sums and the fold sum-check's end:
//   fold_c_kernel, pair_sum_kernel, fold_c_end_kernel
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
// adds the partials (fold_c_kernel adds them inside a thread-block cluster
// instead).  Field addition is associative mod p, so the order of either
// pass cannot change a bit of the result.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;
namespace cg = cooperative_groups;

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

// Lin comb: acc[t] = Tc(x) * sum_i c_i prod_{j in S_i} f_t[j].  The
// multisets come as CSR (set_off, set_idx); every row is in some multiset
// (checked by the wrapper), so the round-r fold writes every row of F.
// The constants c_i are +-1 signs (set_sign, RING false: the zkVM's CCS),
// or rings (set_c, RING true: (nsets, 24) slot-major values, one Fq3
// multiply a multiset where the signed form adds or subtracts).
template <int NPTS, bool FOLD, bool RING>
__device__ __forceinline__ void lin_body(const u64 *__restrict__ X,
                                         u64 *__restrict__ F,
                                         const u64 *__restrict__ Tc,
                                         const int *__restrict__ set_off,
                                         const int *__restrict__ set_idx,
                                         const int *__restrict__ set_sign,
                                         const u64 *__restrict__ set_c,
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
      if (RING) {
        const u64 *c = set_c + (long long)i * 24 + 3 * slot;
        const Fq3 ci = Fq3{c[0], c[1], c[2]};
#pragma unroll
        for (int t = 0; t < NPTS; ++t)
          acc[t] = fq3_add(acc[t], fq3_mul(prod[t], ci));
      } else if (set_sign[i] > 0) {
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
                       u64 *__restrict__ partial, int rows, long long q,
                       const u64 *__restrict__ r3, int b_small) {
  fold_body<NPTS, true>(X, F, Tb, mu, partial, rows, q,
                        Fq3{r3[0], r3[1], r3[2]}, b_small);
}

template <int NPTS, bool RING>
__global__ void __launch_bounds__(BLOCK)
    lin_round0_kernel(const u64 *__restrict__ X, const u64 *__restrict__ Tc,
                      const int *__restrict__ set_off,
                      const int *__restrict__ set_idx,
                      const int *__restrict__ set_sign,
                      const u64 *__restrict__ set_c, int nsets,
                      u64 *__restrict__ partial, long long q) {
  lin_body<NPTS, false, RING>(X, nullptr, Tc, set_off, set_idx, set_sign,
                              set_c, nsets, partial, q, fq3_zero());
}

template <int NPTS, bool RING>
__global__ void __launch_bounds__(BLOCK)
    lin_roundr_kernel(const u64 *__restrict__ X, u64 *__restrict__ F,
                      const u64 *__restrict__ Tc,
                      const int *__restrict__ set_off,
                      const int *__restrict__ set_idx,
                      const int *__restrict__ set_sign,
                      const u64 *__restrict__ set_c, int nsets,
                      u64 *__restrict__ partial, long long q,
                      const u64 *__restrict__ r3) {
  lin_body<NPTS, true, RING>(X, F, Tc, set_off, set_idx, set_sign, set_c,
                             nsets, partial, q, Fq3{r3[0], r3[1], r3[2]});
}

// One fold round's c terms and eq pair sums.  The eq rows eq (3, 24, w),
// each row contiguous at row stride eq_rs, are pair-summed into Tn (3, 24,
// h), h = w / 2:
//     Tn[i][x] = eq[i][x] + eq[i][h + x].
// The two c rows are read as they are (c_in (2, 24, w), row stride c_rs)
// or, with FOLD, folded at r first (c_in (2, 24, 2w) -> c_out (2, 24, w),
// c[x] = c_in[x] + r (c_in[w + x] - c_in[x])), and
//     sums[j]     = sum_{x < h} Tn[j][x] * c[j][x]        (j = 0, 1)
//     sums[2 + j] = sum_{x < h} Tn[j][x] * c[j][h + x]
// slot-wise, (4, 24): the rows [c1 at 0, c2 at 0, c1 at 1, c2 at 1] of the
// round's sums, where round_tail reads them.  The strided rows let the
// first round read the fold head's interleaved rows [eq, c, eq, c, eq]
// where they lie.
//
// What bounds it: the bytes (round 0 at m = 2^17 reads 125 MB and writes
// 38 MB).  The first design (a thread a column of a slot, its four Fq3
// sums unreduced, the loads straight into registers, the last block to
// take a per-device ticket adding every block's partials) took 185
// registers, so two blocks of 128 fitted an SM, and a thread's loads of
// the next columns waited for the products of this one: 45 % of the bound;
// and two launches in flight on one card shared the ticket.  This one:
// - Work: one block-row (blockIdx.y = 2 slot + j) a slot and c row j, so a
//   thread keeps two Fq3 sums (six U192), not four.  Row j's block-row
//   pair-sums eq row j; eq row 2, which has no products, goes to the
//   block-row of j = 0 on a block's even tiles and of j = 1 on its odd
//   ones, so every block reads the same bytes.
// - Loads: every row slice a tile needs goes into shared memory through
//   the TMA unit (cp.async.bulk, one thread issues a tile's 12 to 24
//   slices of 2 KB, completing on the stage's mbarrier), FC_STAGES tiles in
//   a ring: the next FC_STAGES - 1 tiles are in flight while the block
//   works on this one, at no cost in registers, and a barrier a tile frees
//   the stage the next copies refill.  Where a slice is not 16-byte
//   aligned (odd row strides, w / 2 odd) each thread copies its own column
//   by cp.async instead, 8 bytes a row, and waits on its own groups.
// - The sums across blocks: the FC_CLUSTER blocks of a block-row form one
//   thread-block cluster; each adds its threads' reduced sums (shuffles,
//   then shared memory), and after a cluster barrier the cluster's first
//   block reads the others' through distributed shared memory and writes
//   the six values.  No state outlives a launch and none is shared between
//   launches: two launches in flight (two streams, a replayed graph) cannot
//   meet.  One launch a round.
// - The grid: 16 block-rows x FC_CLUSTER blocks, one an SM.  The card
//   places a cluster on the SMs of one GPC; on the H100 at most 15
//   clusters of 8 (or of 7) find one free SM a block, so 16 clusters of 8
//   put two blocks on eight SMs, and the kernel waits for those (0.073
//   ms at round 0, against 0.064 with clusters of 6).  Clusters of 6 fit
//   17 times: 96 blocks on 96 SMs.  More stages (4) or blocks of 512
//   threads ran no faster, cp.async in place of the TMA 15 % slower
//   (scripts/fold_c_trials.py builds and times each of these).
#define FC_CLUSTER 6
#define FC_TW 256  // threads a block = columns a tile
#define FC_STAGES 3

__device__ __forceinline__ unsigned smem_addr(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async8(u64 *dst, const u64 *src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long *bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long *bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long *bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// A bulk copy (the TMA unit), global -> this block's shared memory,
// completing on bar: 16-byte aligned addresses, a multiple of 16 bytes.
__device__ __forceinline__ void bulk_copy(u64 *dst, const u64 *src,
                                          unsigned bytes,
                                          unsigned long long *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The rows of one stage, FC_TW words each: eq row j at x and h + x (comps
// 0-2, then 3-5), eq row 2 likewise, then c row j at x and h + x or,
// folded, at x, w + x, h + x, w + h + x.
enum { FC_E = 0, FC_Q = 6, FC_C = 12 };

template <bool FOLD>
__host__ __device__ constexpr int fc_rows() {
  return FC_C + (FOLD ? 12 : 6);
}

template <bool FOLD>
__host__ __device__ constexpr int fc_smem_bytes() {
  return FC_STAGES * fc_rows<FOLD>() * FC_TW * 8;
}

template <bool FOLD, bool BULK>
__global__ void __cluster_dims__(FC_CLUSTER, 1, 1) __launch_bounds__(FC_TW)
    fold_c_kernel(const u64 *__restrict__ c_in, long long c_rs,
                  const u64 *__restrict__ eq, long long eq_rs,
                  const u64 *__restrict__ r3, u64 *__restrict__ c_out,
                  u64 *__restrict__ tn, u64 *__restrict__ sums, long long w) {
  constexpr int NR = fc_rows<FOLD>();
  extern __shared__ __align__(128) u64 fc_ring[];  // [FC_STAGES][NR][FC_TW]
  __shared__ unsigned long long full[FC_STAGES];   // BULK: a stage's copies
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slot = blockIdx.y >> 1, j = blockIdx.y & 1;
  const int tid = threadIdx.x;
  const long long h = w >> 1;
  const long long W = FOLD ? 2 * w : w;
  const long long ntiles = (h + FC_TW - 1) / FC_TW;
  const u64 *ej = eq + j * eq_rs + 3LL * slot * w;
  const u64 *e2 = eq + 2 * eq_rs + 3LL * slot * w;
  const u64 *cj = c_in + j * c_rs + 3LL * slot * W;
  if (BULK) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < FC_STAGES; ++s) mbar_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // eq row 2 goes with this block-row on every other tile of the block
  auto q_tile = [&](long long t) { return ((t / FC_CLUSTER) & 1) == j; };

  // the copies of tile t into stage s: BULK one thread issues each row's
  // slice, else each thread copies its own column of every row
  auto issue = [&](long long t, int s) {
    if (t >= ntiles) return;
    const long long x0 = t * FC_TW;
    if (BULK ? tid != 0 : x0 + tid >= h) return;
    const bool q = q_tile(t);
    const unsigned bytes =
        (unsigned)(8 * (h - x0 < FC_TW ? h - x0 : (long long)FC_TW));
    u64 *sb = fc_ring + (long long)s * NR * FC_TW;
    if (BULK) mbar_expect(&full[s], (NR - (q ? 0 : 6)) * bytes);
    auto copy = [&](int row, const u64 *src) {
      if (BULK)
        bulk_copy(sb + row * FC_TW, src + x0, bytes, &full[s]);
      else
        cp_async8(sb + row * FC_TW + tid, src + x0 + tid);
    };
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      copy(FC_E + k, ej + k * w);
      copy(FC_E + 3 + k, ej + k * w + h);
      if (q) {
        copy(FC_Q + k, e2 + k * w);
        copy(FC_Q + 3 + k, e2 + k * w + h);
      }
      const u64 *c = cj + k * W;
      copy(FC_C + k, c);
      if (FOLD) {
        copy(FC_C + 3 + k, c + w);
        copy(FC_C + 6 + k, c + h);
        copy(FC_C + 9 + k, c + w + h);
      } else {
        copy(FC_C + 3 + k, c + h);
      }
    }
  };

  U192 acc[2][3];
  zero192(acc[0]);
  zero192(acc[1]);
  const Fq3 r = FOLD ? Fq3{r3[0], r3[1], r3[2]} : fq3_zero();
  long long t_next = rank;
#pragma unroll
  for (int s = 0; s < FC_STAGES - 1; ++s) {
    issue(t_next, s);
    if (!BULK) cp_async_commit();
    t_next += FC_CLUSTER;
  }
  int s_use = 0, s_next = FC_STAGES - 1;
  unsigned parity = 0;
  for (long long t = rank; t < ntiles; t += FC_CLUSTER) {
    // BULK: every thread is done with stage s_next (its last tile) before
    // the copies refill it
    if (BULK) __syncthreads();
    issue(t_next, s_next);
    t_next += FC_CLUSTER;
    s_next = s_next + 1 == FC_STAGES ? 0 : s_next + 1;
    if (BULK) {
      mbar_wait(&full[s_use], parity);
    } else {
      cp_async_commit();
      cp_async_wait<FC_STAGES - 1>();
    }
    const long long x = t * FC_TW + tid;
    if (x < h) {
      const u64 *sb = fc_ring + (long long)s_use * NR * FC_TW + tid;
      auto at = [&](int row) { return sb[row * FC_TW]; };
      const Fq3 T{gl_add(at(FC_E), at(FC_E + 3)),
                  gl_add(at(FC_E + 1), at(FC_E + 4)),
                  gl_add(at(FC_E + 2), at(FC_E + 5))};
      store3(tn + (j * 24LL + 3 * slot) * h, h, x, T);
      if (q_tile(t))
        store3(tn + (2 * 24LL + 3 * slot) * h, h, x,
               Fq3{gl_add(at(FC_Q), at(FC_Q + 3)),
                   gl_add(at(FC_Q + 1), at(FC_Q + 4)),
                   gl_add(at(FC_Q + 2), at(FC_Q + 5))});
      Fq3 v0, v1;
      if (FOLD) {
        const Fq3 a{at(FC_C), at(FC_C + 1), at(FC_C + 2)};
        const Fq3 b{at(FC_C + 3), at(FC_C + 4), at(FC_C + 5)};
        const Fq3 a1{at(FC_C + 6), at(FC_C + 7), at(FC_C + 8)};
        const Fq3 b1{at(FC_C + 9), at(FC_C + 10), at(FC_C + 11)};
        v0 = fq3_add(a, fq3_mul(r, fq3_sub(b, a)));
        v1 = fq3_add(a1, fq3_mul(r, fq3_sub(b1, a1)));
        u64 *co = c_out + (j * 24LL + 3 * slot) * w;
        store3(co, w, x, v0);
        store3(co, w, h + x, v1);
      } else {
        v0 = Fq3{at(FC_C), at(FC_C + 1), at(FC_C + 2)};
        v1 = Fq3{at(FC_C + 3), at(FC_C + 4), at(FC_C + 5)};
      }
      fq3_mac(acc[0], T, v0);
      fq3_mac(acc[1], T, v1);
    }
    if (++s_use == FC_STAGES) {
      s_use = 0;
      parity ^= 1u;
    }
  }
  if (!BULK) cp_async_wait<0>();

  // the block's six sums, then the cluster's in its first block
  __shared__ u64 red[FC_TW / 32][6];
  __shared__ u64 blk[6];
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int v = 0; v < 6; ++v) {
    u64 a = reduce192(acc[v / 3][v % 3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a = gl_add(a, __shfl_down_sync(0xffffffffu, a, off));
    if (lane == 0) red[warp][v] = a;
  }
  __syncthreads();
  if (tid < 6) {
    u64 a = 0ULL;
#pragma unroll
    for (int wp = 0; wp < FC_TW / 32; ++wp) a = gl_add(a, red[wp][tid]);
    blk[tid] = a;
  }
  cluster.sync();
  if (rank == 0 && tid < 6) {
    u64 a = 0ULL;
#pragma unroll
    for (int b = 0; b < FC_CLUSTER; ++b)
      a = gl_add(a, *cluster.map_shared_rank(&blk[tid], b));
    sums[((tid / 3) * 2 + j) * 24 + 3 * slot + tid % 3] = a;
  }
  cluster.sync();  // every block's shared memory lives until it was read
}

// fold_c_kernel's shared memory above 48 KB, allowed on the current device
// before every launch (the attribute belongs to a device, and one process
// may launch on several), then one launch.
template <bool FOLD, bool BULK>
static cudaError_t fold_c_launch(const u64 *c_in, long long c_rs,
                                 const u64 *eq, long long eq_rs,
                                 const u64 *r3, u64 *c_out, u64 *tn,
                                 u64 *sums, long long w,
                                 cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      fold_c_kernel<FOLD, BULK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fc_smem_bytes<FOLD>());
  if (set != cudaSuccess) return set;
  fold_c_kernel<FOLD, BULK>
      <<<dim3(FC_CLUSTER, 16), FC_TW, fc_smem_bytes<FOLD>(), stream>>>(
          c_in, c_rs, eq, eq_rs, r3, c_out, tn, sums, w);
  return cudaGetLastError();
}

// The lin rounds' eq pair sums alone: eq (n_eq, 24, w), each row contiguous
// at row stride eq_rs -> tn (n_eq, 24, h), one thread an output.
__global__ void __launch_bounds__(BLOCK)
    pair_sum_kernel(const u64 *__restrict__ eq, long long eq_rs, int n_eq,
                    u64 *__restrict__ tn, long long w) {
  const long long h = w >> 1;
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n_eq * 24LL * h) return;
  const long long x = i % h, rk = i / h;
  const u64 *e = eq + (rk / 24) * eq_rs + (rk % 24) * w;
  tn[i] = gl_add(e[x], e[h + x]);
}

// The fold sum-check's end, one thread per (row, slot, x < w) of out (5 +
// n_t, 24, w): rows 0, 2, 4 the eq rows (3, 24, w; row stride eq_rs) times
// their weights scale (3, 3); rows 1, 3 the c rows (2, 24, 2w; row stride
// c_rs) folded at r; rows 5 .. the tail rows t_in (n_t, 24, 2w), contiguous,
// folded at r.
__global__ void __launch_bounds__(BLOCK)
    fold_c_end_kernel(const u64 *__restrict__ c_in, long long c_rs,
                      const u64 *__restrict__ eq, long long eq_rs,
                      const u64 *__restrict__ t_in, int n_t,
                      const u64 *__restrict__ r3,
                      const u64 *__restrict__ scale, u64 *__restrict__ out,
                      long long w) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (5LL + n_t) * 8 * w) return;
  const long long x = i % w;
  const int slot = (int)((i / w) % 8);
  const int row = (int)(i / (8 * w));
  Fq3 v;
  if (row < 5 && row % 2 == 0) {
    const int k = row / 2;
    const u64 *e = eq + k * eq_rs + 3LL * slot * w;
    v = fq3_mul(load3(e, w, x),
                Fq3{scale[3 * k], scale[3 * k + 1], scale[3 * k + 2]});
  } else {
    const long long W = 2 * w;
    const u64 *src = (row < 5 ? c_in + (row / 2) * c_rs
                              : t_in + (row - 5) * 24LL * W) +
                     3LL * slot * W;
    const Fq3 a = load3(src, W, x), b = load3(src, W, w + x);
    v = fq3_add(a, fq3_mul(Fq3{r3[0], r3[1], r3[2]}, fq3_sub(b, a)));
  }
  store3(out + (row * 24LL + 3 * slot) * w, w, x, v);
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
                   u64 *partial, u64 *out, int rows, long long q,
                   const u64 *r3, int b_small, cudaStream_t stream) {
  const int npts = 2 * b_small;
#define LT_CASE(N)                                                           \
  case N:                                                                    \
    fold_roundr_kernel<N><<<comb_grid(q), BLOCK, 0, stream>>>(               \
        X, F, Tb, mu, partial, rows, q, r3, b_small);                        \
    break;
  LT_DISPATCH_FOLD(npts, LT_CASE)
#undef LT_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partial, out, comb_grid(q).x, npts, stream);
}

// The lin entry points take the constants as signs (set_sign, set_c null)
// or as rings (set_c, set_sign null).
int lt_lin_round0(const u64 *X, const u64 *Tc, const int *set_off,
                  const int *set_idx, const int *set_sign, const u64 *set_c,
                  int nsets, u64 *partial, u64 *out, long long q, int npts,
                  cudaStream_t stream) {
#define LT_CASE(N)                                                           \
  case N:                                                                    \
    if (set_c)                                                               \
      lin_round0_kernel<N, true><<<comb_grid(q), BLOCK, 0, stream>>>(        \
          X, Tc, set_off, set_idx, set_sign, set_c, nsets, partial, q);      \
    else                                                                     \
      lin_round0_kernel<N, false><<<comb_grid(q), BLOCK, 0, stream>>>(       \
          X, Tc, set_off, set_idx, set_sign, set_c, nsets, partial, q);      \
    break;
  LT_DISPATCH_LIN(npts, LT_CASE)
#undef LT_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partial, out, comb_grid(q).x, npts, stream);
}

int lt_lin_roundr(const u64 *X, u64 *F, const u64 *Tc, const int *set_off,
                  const int *set_idx, const int *set_sign, const u64 *set_c,
                  int nsets, u64 *partial, u64 *out, long long q,
                  const u64 *r3, int npts, cudaStream_t stream) {
#define LT_CASE(N)                                                           \
  case N:                                                                    \
    if (set_c)                                                               \
      lin_roundr_kernel<N, true><<<comb_grid(q), BLOCK, 0, stream>>>(        \
          X, F, Tc, set_off, set_idx, set_sign, set_c, nsets, partial, q,    \
          r3);                                                               \
    else                                                                     \
      lin_roundr_kernel<N, false><<<comb_grid(q), BLOCK, 0, stream>>>(       \
          X, F, Tc, set_off, set_idx, set_sign, set_c, nsets, partial, q,    \
          r3);                                                               \
    break;
  LT_DISPATCH_LIN(npts, LT_CASE)
#undef LT_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partial, out, comb_grid(q).x, npts, stream);
}

// One fold round's c terms and eq pair sums (fold_c_kernel): r3 null reads
// c_in (2, 24, w), else folds c_in (2, 24, 2w) at r3 into c_out.  The rows
// go through the TMA unit where every row slice is 16-byte aligned (row
// strides and w / 2 even, base pointers 16-byte aligned), else through
// cp.async, 8 bytes a thread.
int lt_fold_c_round(const u64 *c_in, long long c_rs, const u64 *eq,
                    long long eq_rs, const u64 *r3, u64 *c_out, u64 *tn,
                    u64 *sums, long long w, cudaStream_t stream) {
  if (w < 2 || w % 2) return (int)cudaErrorInvalidValue;
  const bool bulk =
      ((unsigned long long)c_in | (unsigned long long)eq) % 16 == 0 &&
      c_rs % 2 == 0 && eq_rs % 2 == 0 && w % 4 == 0;
  // two instantiations, not a run-time flag: with the flag, both paths in
  // one kernel took more registers and ran round 0 slower (PERF.md, PR 11)
  cudaError_t (*launch)(const u64 *, long long, const u64 *, long long,
                        const u64 *, u64 *, u64 *, u64 *, long long,
                        cudaStream_t) =
      r3 ? (bulk ? fold_c_launch<true, true> : fold_c_launch<true, false>)
         : (bulk ? fold_c_launch<false, true> : fold_c_launch<false, false>);
  return (int)launch(c_in, c_rs, eq, eq_rs, r3, c_out, tn, sums, w, stream);
}

// The pair sums alone (pair_sum_kernel): eq (n_eq, 24, w), row stride
// eq_rs -> tn (n_eq, 24, w / 2).
int lt_pair_sum(const u64 *eq, long long eq_rs, int n_eq, u64 *tn,
                long long w, cudaStream_t stream) {
  if (w < 2 || w % 2 || n_eq < 1) return (int)cudaErrorInvalidValue;
  const long long n = n_eq * 24LL * (w / 2);
  pair_sum_kernel<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(
      eq, eq_rs, n_eq, tn, w);
  return (int)cudaGetLastError();
}

// The fold sum-check's end (fold_c_end_kernel).
int lt_fold_c_end(const u64 *c_in, long long c_rs, const u64 *eq,
                  long long eq_rs, const u64 *t_in, int n_t, const u64 *r3,
                  const u64 *scale, u64 *out, long long w,
                  cudaStream_t stream) {
  if (w < 1 || n_t < 0) return (int)cudaErrorInvalidValue;
  const long long n = (5LL + n_t) * 8 * w;
  fold_c_end_kernel<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0,
                      stream>>>(c_in, c_rs, eq, eq_rs, t_in, n_t, r3, scale,
                                out, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
