// Sorted-COO (CSR) segment sums of the CCS matrices, for sm_90a.
//
// Replace the COO matvecs that the JAX package computes in XLA, with no
// Pallas kernel: DeviceEngine.matvecs (latticeum_tpu/zkvm/accel.py:117) and
// its t-layout form lin_g_t (zkvm/accel_nifs.py:437), the M^T eq stack eqT
// (accel_nifs.py:634) and the challenged-z part of _build_head
// (accel_nifs.py:997, "challenged z per COO entry").  The wrapper and the
// plain-torch twin are coo_matvec and coo_matvec_twin in zkvm/accel.py,
// which state the layouts.  Entry e of segment s (off[s] <= e < off[s+1])
// adds
//     vals[e] * y(e),   y(e) = x[gather[e]]
// or, in the head mode,
//     y(e) = sum_{i < nwit} zeta[i][mats[e]] * z_i[gather[e]],
// slot by slot: vals[e] a base-field scalar or (RING) a ring, zeta an Fq3
// scalar per witness and matrix, x and z_i rings (24 values, slot-major).
// Segment s = blk * per + pos lands at (blk, pos) of an output laid out
// (blk, per, 24) or, in the t-layout, (blk, 24, per).  Every segment is
// written, an empty one as zero; the head mode adds its sums to the output
// (the fold head's c row) and leaves empty segments as they are.
//
// What bounds it: the bytes.  At production (t = 125, n = 19,768, nnz =
// 67,990, scalar values) M^T eq writes t n rings (474 MB) and M z t 2^14
// (393 MB), nearly all of them empty segments; the products are a few per
// output written.  The head mode reads 15 witnesses' gathered rows and
// touches only its 10,361 non-empty rows of 2^17.
//
// Design: every (segment, slot) has one owner, which sums its products
// unreduced in U192 (mac192) and reduces once; nothing is added with
// atomics, and no output is read back except in the head mode.  An owner
// is 1, 4 or 32 lanes, each taking every 1st, 4th or 32nd of the
// segment's work items (an entry; in the head mode an (entry, witness)
// pair), their reduced sums added by warp shuffles (and shared memory).
//   * Light segments (items <= COO_LIGHT) of the plain modes: one thread
//     a slot, eight neighbouring threads a segment, so a warp covers four
//     neighbouring segments and writes 768 contiguous bytes in the
//     standard layout, 24 full 32-byte sectors in the t-layout.  These
//     blocks cover every segment, so empty ones are written as zero.
//   * Light segments of the head mode: a warp a segment, 4 lanes a slot,
//     over the non-empty segments only.  With one thread a slot, a
//     4-entry row was 60 items on one thread's chain of gathered loads,
//     and blocks over all 2^17 rows ran those chains wave after wave: 10 %
//     of the bound (0.508 ms on an NVIDIA H100 80GB HBM3 at 700 W).
//   * Heavy segments (items > COO_LIGHT): the transpose map has columns of
//     z that up to 704 entries read (the constant 1), the head rows up to
//     53 entries x 15 witnesses; a block each, 32 lanes a slot, at most 25
//     items a lane at production.
// The heavy and the head's light segments come from a list of the
// non-empty segments sorted by entries (built once per segment map): the
// heavy ones first, so the wrapper passes their count and light owners
// skip exactly those.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define COO_GROUPS 32                  // light plain segments a block
#define COO_THREADS (8 * COO_GROUPS)   // a thread a slot
#define COO_WARPS (COO_THREADS / 32)   // light head segments a block
#define COO_LIGHT 64                   // most items of a light segment

namespace {

struct CooArgs {
  const int *off, *gather, *mats, *by_size;
  const u64 *vals, *x, *zeta;
  u64 *out;
  long long nseg, per, light_blocks;
  long long x_rows;  // rows of one witness's z (head mode)
  int n_heavy, n_full, nwit, t, t_layout;
};

// acc += the product of item (e, i): vals[e] * x[gather[e]], or in the
// head mode (vals[e] * zeta[i][mats[e]]) * z_i[gather[e]], for the
// owner's slot.
template <bool HEAD, bool RING>
__device__ __forceinline__ void item(const CooArgs &a, int e, int i,
                                     int slot, U192 (&acc)[3]) {
  const long long g = a.gather[e];
  if (!HEAD) {
    const u64 *xr = a.x + g * 24 + 3 * slot;
    const Fq3 x{xr[0], xr[1], xr[2]};
    if (RING) {
      const u64 *v = a.vals + (long long)e * 24 + 3 * slot;
      fq3_mac(acc, Fq3{v[0], v[1], v[2]}, x);
    } else {
      const u64 v = a.vals[e];
      mac192(acc[0], v, x.c0);
      mac192(acc[1], v, x.c1);
      mac192(acc[2], v, x.c2);
    }
    return;
  }
  const u64 *zt = a.zeta + 3 * ((long long)i * a.t + a.mats[e]);
  const Fq3 zeta{zt[0], zt[1], zt[2]};
  Fq3 c;
  if (RING) {
    const u64 *v = a.vals + (long long)e * 24 + 3 * slot;
    c = fq3_mul(Fq3{v[0], v[1], v[2]}, zeta);
  } else {
    const u64 v = a.vals[e];
    c = Fq3{gl_mul(v, zeta.c0), gl_mul(v, zeta.c1), gl_mul(v, zeta.c2)};
  }
  const u64 *z = a.x + ((long long)i * a.x_rows + g) * 24 + 3 * slot;
  fq3_mac(acc, c, Fq3{z[0], z[1], z[2]});
}

// The items lane, lane + L, lane + 2L, ... of entries [e0, e1), nwit
// items an entry.
template <bool HEAD, bool RING>
__device__ __forceinline__ void items(const CooArgs &a, int e0, int e1,
                                      int lane, int L, int slot,
                                      U192 (&acc)[3]) {
  const int de = L / a.nwit, di = L % a.nwit;
  int e = e0 + lane / a.nwit, i = lane % a.nwit;
#pragma unroll 4
  for (; e < e1;) {
    item<HEAD, RING>(a, e, i, slot, acc);
    e += de;
    i += di;
    if (i >= a.nwit) {
      i -= a.nwit;
      ++e;
    }
  }
}

// Component k of slot `slot` of segment s.
__device__ __forceinline__ u64 *out_at(const CooArgs &a, long long s,
                                       int slot, int k) {
  if (!a.t_layout) return a.out + s * 24 + 3 * slot + k;
  const long long blk = s / a.per, pos = s - blk * a.per;
  return a.out + (blk * 24 + 3 * slot + k) * a.per + pos;
}

template <bool HEAD>
__device__ __forceinline__ void put(u64 *o, u64 v) {
  *o = HEAD ? gl_add(*o, v) : v;
}

// The owner's sum of component k, over the lanes of its warp that hold
// its slot (lanes 8 apart: xor 8, 16 adds 4 lanes; with `four` false the
// thread is the owner).
__device__ __forceinline__ u64 warp_sum(const U192 &acc, bool four) {
  u64 v = reduce192(acc);
  if (four) {
    v = gl_add(v, __shfl_xor_sync(0xffffffffu, v, 8));
    v = gl_add(v, __shfl_xor_sync(0xffffffffu, v, 16));
  }
  return v;
}

template <bool HEAD, bool RING>
__global__ void __launch_bounds__(COO_THREADS) coo_kernel(const CooArgs a) {
  const int slot = threadIdx.x & 7;
  U192 acc[3];
  zero192(acc);
  if (blockIdx.x < a.light_blocks && !HEAD) {
    const long long s =
        (long long)blockIdx.x * COO_GROUPS + (threadIdx.x >> 3);
    if (s >= a.nseg) return;
    const int e0 = a.off[s], e1 = a.off[s + 1];
    if (e1 - e0 > COO_LIGHT) return;  // a heavy block's
    items<HEAD, RING>(a, e0, e1, 0, 1, slot, acc);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      put<HEAD>(out_at(a, s, slot, k), warp_sum(acc[k], false));
    return;
  }
  if (blockIdx.x < a.light_blocks) {  // HEAD: a warp a segment
    const int w = a.n_heavy + blockIdx.x * COO_WARPS + (threadIdx.x >> 5);
    if (w >= a.n_full) return;  // the whole warp
    const long long s = a.by_size[w];
    items<HEAD, RING>(a, a.off[s], a.off[s + 1], (threadIdx.x >> 3) & 3, 4,
                      slot, acc);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const u64 v = warp_sum(acc[k], true);
      if ((threadIdx.x & 31) < 8) put<HEAD>(out_at(a, s, slot, k), v);
    }
    return;
  }
  // A heavy segment: thread (lane, slot), lane = threadIdx.x / 8.
  __shared__ u64 red[COO_WARPS][24];
  const long long s = a.by_size[blockIdx.x - a.light_blocks];
  items<HEAD, RING>(a, a.off[s], a.off[s + 1], threadIdx.x >> 3,
                    COO_THREADS / 8, slot, acc);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const u64 v = warp_sum(acc[k], true);
    if ((threadIdx.x & 31) < 8) red[threadIdx.x >> 5][3 * slot + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 24) {
    u64 v = 0ULL;
#pragma unroll
    for (int w = 0; w < COO_WARPS; ++w) v = gl_add(v, red[w][threadIdx.x]);
    put<HEAD>(out_at(a, s, threadIdx.x / 3, threadIdx.x % 3), v);
  }
}

}  // namespace

extern "C" {

// The segment sums into `out` (see the file's head): zeta null for the
// plain modes (x (rows, 24)), else the head mode over nwit witnesses (x
// (nwit, x_rows, 24), zeta (nwit, t, 3)), added to out; ring: vals (nnz,
// 24), else (nnz,); by_size: the n_full non-empty segments, the n_heavy
// whose items (entries x nwit) exceed COO_LIGHT first.  Returns the
// cudaError_t of the launch.
int lt_coo_matvec(const int *off, const int *gather, const int *mats,
                  const u64 *vals, const int *by_size, int n_heavy,
                  int n_full, long long nseg, long long per, const u64 *x,
                  long long x_rows, const u64 *zeta, int nwit, int t,
                  int ring, int t_layout, u64 *out, cudaStream_t stream) {
  const bool head = zeta != nullptr;
  const long long light =
      head ? (n_full - n_heavy + COO_WARPS - 1) / COO_WARPS
           : (nseg + COO_GROUPS - 1) / COO_GROUPS;
  if (nseg < 1 || per < 1 || nseg % per || n_heavy < 0 || n_full < n_heavy ||
      light + n_heavy > 0x7FFFFFFFLL || (head && nwit < 1))
    return (int)cudaErrorInvalidValue;
  const CooArgs a{off,   gather, mats,    by_size,          vals,
                  x,     zeta,   out,     nseg,             per,
                  light, x_rows, n_heavy, n_full, head ? nwit : 1,
                  t,     t_layout};
  const unsigned grid = (unsigned)(light + n_heavy);
  if (grid == 0) return (int)cudaSuccess;
  if (head) {
    if (ring)
      coo_kernel<true, true><<<grid, COO_THREADS, 0, stream>>>(a);
    else
      coo_kernel<true, false><<<grid, COO_THREADS, 0, stream>>>(a);
  } else {
    if (ring)
      coo_kernel<false, true><<<grid, COO_THREADS, 0, stream>>>(a);
    else
      coo_kernel<false, false><<<grid, COO_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
