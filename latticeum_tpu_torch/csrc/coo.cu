// Sorted-COO (CSR) segment sums of the CCS matrices, for sm_90a.
//
// Replace the COO matvecs that the JAX package computes in XLA, with no
// Pallas kernel: DeviceEngine.matvecs (latticeum_tpu/zkvm/accel.py:117) and
// its t-layout form lin_g_t (zkvm/accel_nifs.py:437) and the M^T eq stack
// eqT (accel_nifs.py:634), by coo_kernel; the challenged-z part of
// _build_head (accel_nifs.py:997, "challenged z per COO entry"), by
// coo_head_kernel.  The wrappers and the plain-torch twin are coo_matvec,
// coo_head and coo_matvec_twin in zkvm/accel.py, which state the layouts.
//
// coo_kernel.  Entry e of segment s (off[s] <= e < off[s+1]) adds
//     vals[e] * x[gather[e]],
// slot by slot: vals[e] a base-field scalar or (RING) a ring, x rings (24
// values, slot-major).  Segment s = blk * per + pos lands at (blk, pos) of
// an output laid out (blk, per, 24) or, in the t-layout, (blk, 24, per).
// Every segment is written, an empty one as zero.
//
// What bounds it: the bytes.  At production (t = 125, n = 19,768, nnz =
// 67,990, scalar values) M^T eq writes t n rings (474 MB) and M z t 2^14
// (393 MB), nearly all of them empty segments; the products are a few per
// output written.
//
// Design: every (segment, slot) has one owner, which sums its products
// unreduced in U192 (mac192) and reduces once; nothing is added with
// atomics, and no output is read back.  An owner is 1 or 32 lanes, each
// taking every 1st or 32nd of the segment's entries, their reduced sums
// added by warp shuffles and shared memory.
//   * Light segments (entries <= COO_LIGHT): one thread a slot, eight
//     neighbouring threads a segment, so a warp covers four neighbouring
//     segments and writes 768 contiguous bytes in the standard layout, 24
//     full 32-byte sectors in the t-layout.  These blocks cover every
//     segment, so empty ones are written as zero.
//   * Heavy segments (entries > COO_LIGHT): the transpose map has columns
//     of z that up to 704 entries read (the constant 1); a block each, 32
//     lanes a slot, at most 22 entries a lane at production.
// The heavy segments come from a list of the non-empty segments sorted by
// entries (built once per segment map), the heavy ones first, so the
// wrapper passes their count and light owners skip exactly those.
//
// coo_head_kernel, the fold head's two c rows in one launch.  Witness i of
// row r (i < nwit, z_{r,i} and zeta_{r,i} at r * nwit + i) and entry e of
// segment s add
//     vals[e] * y_r(e),   y_r(e) = sum_{i < nwit} zeta_{r,i}[mats[e]] *
//                                  z_{r,i}[gather[e]]
// slot by slot (zeta an Fq3 scalar per witness and matrix) to position s
// of row r's output, laid out (24, per) in the t-layout; empty segments
// stay as they are.
//
// What bounds it: the bytes, the z rows read once (122 MB for both rows
// at production), and nearly as much the products: y_r(e) depends on the
// entry only through (mats[e], gather[e]), and the 67,990 entries hold
// 35,753 distinct pairs, each 8 slots x 15 unreduced Fq3 products (9
// mac192) of zeta and z a row.  This kernel forms y for every entry, 1.9
// times the products the function needs, and gathers 15 x 192 bytes of
// z an entry and row (391 MB for both rows).  Only 10,361 of the 2^17
// positions are non-empty.
//
// Design, in the order the arithmetic needs: per entry and slot the
// nwit products sum unreduced in U192 and reduce once (y), then take the
// value (3 mac192 for a scalar, an Fq3 product for a ring) into the
// segment's U192 sum, which reduces once an output.  zeta of the row,
// with w c1 and w c2 formed once per (matrix, witness) and not per slot,
// is staged in shared memory (5 words x t x nwit: 75 KB at production).
// The work is balanced by entries, each of which costs nwit items: grid
// (G, 2), G blocks a c row as many as fill the card once; block b takes
// the segments whose first entry lies in [b nnz / G, (b + 1) nnz / G),
// found by binary search over the non-empty segments' first entries
// (nz_off, built once per segment map), so no segment crosses a block.  The
// block's entries are cut into HEAD_LANES runs of equal length (+-1),
// crossing segments; a run is 8 threads, one a slot, and the runs of a
// warp step through their entries together, so an entry's products and
// its reduction are in step across the warp.  A run's segments that
// begin and end in it are added to the output by the run; its first
// segment, where it began in an earlier run, goes to shared memory, and
// the run that began a segment which goes on past its end adds those
// pieces of the runs after it and writes the sum.  So every output has
// one owner, nothing is added with atomics and no state crosses a launch.
// No load waits on the arithmetic: a thread loads the z of HEAD_GROUP
// witnesses while it multiplies the group before (the next entry's first
// group during an entry's last), reads the next entry's row, matrix and
// value an entry ahead, and reads the output of a segment when it begins
// it.  With the z loads taken out, the launch took 98 % of its time
// (scripts/coo_head_trials.py): the products set it.  One block of
// HEAD_THREADS an SM (about 160 registers a thread; held to two blocks,
// the registers spill).  Runs walk the segments in position order; the
// bit-reversed positions of non-empty rows lie 8 words apart or more, so
// no order would write two outputs into one sector.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace lt;

#define COO_GROUPS 32                  // light segments a block
#define COO_THREADS (8 * COO_GROUPS)   // a thread a slot
#define COO_WARPS (COO_THREADS / 32)
#define COO_LIGHT 64                   // most entries of a light segment
#define HEAD_LANES 48                  // entry runs a head block
#define HEAD_THREADS (8 * HEAD_LANES)  // a thread a run and slot
#define HEAD_GROUP 5                   // witnesses whose z load together
#define HEAD_MIN_BLOCKS 1              // head blocks an SM, for registers

namespace {

struct CooArgs {
  const int *off, *gather, *by_size;
  const u64 *vals, *x;
  u64 *out;
  long long nseg, per, light_blocks;
  int t_layout;
};

// acc += vals[e] * x[gather[e]], the owner's slot.
template <bool RING>
__device__ __forceinline__ void entry(const CooArgs &a, int e, int slot,
                                      U192 (&acc)[3]) {
  const u64 *xr = a.x + 24LL * a.gather[e] + 3 * slot;
  const Fq3 x{xr[0], xr[1], xr[2]};
  if (RING) {
    const u64 *v = a.vals + 24LL * e + 3 * slot;
    fq3_mac(acc, Fq3{v[0], v[1], v[2]}, x);
  } else {
    const u64 v = a.vals[e];
    mac192(acc[0], v, x.c0);
    mac192(acc[1], v, x.c1);
    mac192(acc[2], v, x.c2);
  }
}

// The entries lane, lane + L, lane + 2L, ... of [e0, e1): four a trip,
// each after the first behind its own bound check.  As a loop the
// compiler counts and unrolls, M z ran 9 % slower; with the loads of four
// entries issued before their products, 74 registers a thread and 60 %
// slower (scripts/coo_head_trials.py on an NVIDIA H100).
template <bool RING>
__device__ __forceinline__ void entries(const CooArgs &a, int e0, int e1,
                                        int lane, int L, int slot,
                                        U192 (&acc)[3]) {
#pragma unroll 1
  for (int e = e0 + lane; e < e1; e += 4 * L) {
    entry<RING>(a, e, slot, acc);
#pragma unroll
    for (int u = 1; u < 4; ++u)
      if (e + u * L < e1) entry<RING>(a, e + u * L, slot, acc);
  }
}

// Slot `slot` of segment s <- v, its three components written together
// once all are reduced (24 contiguous bytes in the standard layout;
// written as each was reduced, the first some 90 instructions before the
// others, M^T eq ran 28 % slower).
__device__ __forceinline__ void put3(const CooArgs &a, long long s,
                                     int slot, const u64 (&v)[3]) {
  if (!a.t_layout) {
    u64 *o = a.out + s * 24 + 3 * slot;
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
    return;
  }
  const long long blk = s / a.per, pos = s - blk * a.per;
  u64 *o = a.out + (blk * 24 + 3 * slot) * a.per + pos;
  o[0] = v[0];
  o[a.per] = v[1];
  o[2 * a.per] = v[2];
}

template <bool RING>
__global__ void __launch_bounds__(COO_THREADS) coo_kernel(const CooArgs a) {
  const int slot = threadIdx.x & 7;
  U192 acc[3];
  zero192(acc);
  u64 v[3];
  if (blockIdx.x < a.light_blocks) {
    const long long s =
        (long long)blockIdx.x * COO_GROUPS + (threadIdx.x >> 3);
    if (s >= a.nseg) return;
    const int e0 = a.off[s], e1 = a.off[s + 1];
    if (e1 - e0 > COO_LIGHT) return;  // a heavy block's
    entries<RING>(a, e0, e1, 0, 1, slot, acc);
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = reduce192(acc[k]);
    put3(a, s, slot, v);
    return;
  }
  // A heavy segment: thread (lane, slot), lane = threadIdx.x / 8; a
  // slot's 4 lanes of a warp (8 apart) add by shuffles, then the warps.
  __shared__ u64 red[COO_WARPS][24];
  const long long s = a.by_size[blockIdx.x - a.light_blocks];
  entries<RING>(a, a.off[s], a.off[s + 1], threadIdx.x >> 3,
                COO_THREADS / 8, slot, acc);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = reduce192(acc[k]);
    v[k] = gl_add(v[k], __shfl_xor_sync(0xffffffffu, v[k], 8));
    v[k] = gl_add(v[k], __shfl_xor_sync(0xffffffffu, v[k], 16));
    if ((threadIdx.x & 31) < 8) red[threadIdx.x >> 5][3 * slot + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x >= 8) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = 0ULL;
#pragma unroll
    for (int w = 0; w < COO_WARPS; ++w)
      v[k] = gl_add(v[k], red[w][3 * threadIdx.x + k]);
  }
  put3(a, s, threadIdx.x, v);
}


struct HeadArgs {
  const int *nz, *nz_off, *gather, *mats;
  const u64 *vals, *z, *zeta;
  u64 *out0, *out1;
  long long z_rows, per;
  int n_nz, nwit, t;
};

// The first k in [lo, hi] with nz_off[k] >= e (hi if there is none).
__device__ __forceinline__ int first_at(const int *nz_off, int lo, int hi,
                                        long long e) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (nz_off[mid] < e)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The three components of one slot's output at position pos.
__device__ __forceinline__ Fq3 out_get(const u64 *out, long long per,
                                       int pos) {
  const u64 *o = out + pos;
  return Fq3{o[0], o[per], o[2 * per]};
}

__device__ __forceinline__ void out_put(u64 *out, long long per, int pos,
                                        const Fq3 &v) {
  u64 *o = out + pos;
  o[0] = v.c0;
  o[per] = v.c1;
  o[2 * per] = v.c2;
}

// z of witnesses i0 .. i0 + HEAD_GROUP - 1 (those below K) at row g, one
// slot: zw points at witness 0's row 0 of this row's witnesses and slot.
__device__ __forceinline__ void load_group(Fq3 (&buf)[HEAD_GROUP],
                                           const u64 *zw, long long zs,
                                           int g, int i0, int K) {
  const u64 *zr = zw + 24LL * g + zs * i0;
#pragma unroll
  for (int j = 0; j < HEAD_GROUP; ++j, zr += zs)
    if (i0 + j < K) buf[j] = Fq3{zr[0], zr[1], zr[2]};
}

template <bool RING>
__device__ __forceinline__ Fq3 load_val(const HeadArgs &a, int e, int slot) {
  if (RING) {
    const u64 *v = a.vals + 24LL * e + 3 * slot;
    return Fq3{v[0], v[1], v[2]};
  }
  return Fq3{a.vals[e], 0ULL, 0ULL};
}

template <bool RING>
__global__ void __launch_bounds__(HEAD_THREADS, HEAD_MIN_BLOCKS)
    coo_head_kernel(const HeadArgs a) {
  extern __shared__ u64 smem[];
  const int K = a.nwit, row = blockIdx.y;
  const long long nnz = a.nz_off[a.n_nz], G = gridDim.x, b = blockIdx.x;
  const int ka = first_at(a.nz_off, 0, a.n_nz, nnz * b / G);
  const int kb = first_at(a.nz_off, ka, a.n_nz, nnz * (b + 1) / G);
  if (ka == kb) return;  // the whole block: no segment begins here
  // The row's zeta, (t, nwit) x (c0, c1, c2, w c1, w c2); then the runs'
  // first pieces, (HEAD_LANES, 24).
  u64 *zt = smem, *piece = smem + 5LL * a.t * K;
  const u64 *zeta = a.zeta + 3LL * row * K * a.t;
  for (int q = threadIdx.x; q < a.t * K; q += HEAD_THREADS) {
    const int mt = q / K, i = q - mt * K;
    const u64 *src = zeta + 3 * ((long long)i * a.t + mt);
    u64 *d = zt + 5 * q;
    d[0] = src[0];
    d[1] = src[1];
    d[2] = src[2];
    d[3] = gl_mul_w(src[1]);
    d[4] = gl_mul_w(src[2]);
  }
  __syncthreads();
  const int slot = threadIdx.x & 7, lane = threadIdx.x >> 3;
  const int ea = a.nz_off[ka];
  const long long n_e = a.nz_off[kb] - ea;
  const int e0 = ea + (int)(n_e * lane / HEAD_LANES);
  const int e1 = ea + (int)(n_e * (lane + 1) / HEAD_LANES);
  const long long zs = a.z_rows * 24;  // one witness's z
  const u64 *zw = a.z + zs * row * K + 3 * slot;
  u64 *out = (row ? a.out1 : a.out0) + 3 * slot * a.per;
  bool tail = false;  // this run began a segment that goes on past it
  int tk = 0;
  Fq3 tv{0ULL, 0ULL, 0ULL}, to = tv;
  if (e0 < e1) {
    int k = first_at(a.nz_off, ka, kb, e0 + 1LL) - 1;  // e0's segment
    const bool open = a.nz_off[k] < e0;  // it began in an earlier run
    int next = a.nz_off[k + 1];
    // The output of a segment this run begins, read well before it is
    // written.
    Fq3 o = open ? tv : out_get(out, a.per, a.nz[k]);
    bool first = true;
    U192 sum[3], y[3];
    zero192(sum);
    zero192(y);
    // The run's items as groups of witnesses of one entry, each group's z
    // loaded while the one before it is multiplied; the next entry's
    // row, matrix and value read one entry ahead.
    int e = e0, g = a.gather[e], mt = a.mats[e];
    int gn = 0, mn = 0;
    if (e + 1 < e1) {
      gn = a.gather[e + 1];
      mn = a.mats[e + 1];
    }
    Fq3 v = load_val<RING>(a, e, slot);
    Fq3 cur[HEAD_GROUP], nxt[HEAD_GROUP];
    load_group(cur, zw, zs, g, 0, K);
    for (;;) {
      for (int i0 = 0; i0 < K; i0 += HEAD_GROUP) {
        if (i0 + HEAD_GROUP < K)
          load_group(nxt, zw, zs, g, i0 + HEAD_GROUP, K);
        else if (e + 1 < e1)
          load_group(nxt, zw, zs, gn, 0, K);
        const u64 *zc = zt + 5 * (mt * K + i0);
#pragma unroll
        for (int j = 0; j < HEAD_GROUP; ++j, zc += 5)
          if (i0 + j < K)
            fq3_mac_w(y, zc[0], zc[1], zc[2], zc[3], zc[4], cur[j]);
#pragma unroll
        for (int j = 0; j < HEAD_GROUP; ++j) cur[j] = nxt[j];
      }
      // Entry e is done: y, then its value into the segment's sum.
      const Fq3 yv = reduce3(y);
      zero192(y);
      if (RING) {
        fq3_mac(sum, v, yv);
      } else {
        mac192(sum[0], v.c0, yv.c0);
        mac192(sum[1], v.c0, yv.c1);
        mac192(sum[2], v.c0, yv.c2);
      }
      const bool done = e + 1 == next;  // the segment's last entry
      if (done || e + 1 == e1) {
        const Fq3 s = reduce3(sum);
        zero192(sum);
        if (first && open) {
          u64 *p = piece + 24 * lane + 3 * slot;
          p[0] = s.c0;
          p[1] = s.c1;
          p[2] = s.c2;
        } else if (done) {
          out_put(out, a.per, a.nz[k],
                  Fq3{gl_add(o.c0, s.c0), gl_add(o.c1, s.c1),
                      gl_add(o.c2, s.c2)});
        } else {
          tail = true;
          tk = k;
          tv = s;
          to = o;
        }
        first = false;
        if (done && e + 1 < e1) {
          next = a.nz_off[++k + 1];
          o = out_get(out, a.per, a.nz[k]);
        }
      }
      if (++e == e1) break;
      g = gn;
      mt = mn;
      v = load_val<RING>(a, e, slot);
      if (e + 1 < e1) {
        gn = a.gather[e + 1];
        mn = a.mats[e + 1];
      }
    }
  }
  __syncthreads();
  if (!tail) return;
  // The runs after this one that begin inside segment tk hold its pieces.
  const int end = a.nz_off[tk + 1];
  for (int j = lane + 1; j < HEAD_LANES; ++j) {
    const int f = ea + (int)(n_e * j / HEAD_LANES);
    if (f >= end) break;
    if (ea + (int)(n_e * (j + 1) / HEAD_LANES) == f) continue;  // empty run
    const u64 *p = piece + 24 * j + 3 * slot;
    tv = Fq3{gl_add(tv.c0, p[0]), gl_add(tv.c1, p[1]), gl_add(tv.c2, p[2])};
  }
  out_put(out, a.per, a.nz[tk],
          Fq3{gl_add(to.c0, tv.c0), gl_add(to.c1, tv.c1),
              gl_add(to.c2, tv.c2)});
}

// coo_head_kernel's shared memory above 48 KB, allowed on the current
// device before every launch (the attribute belongs to a device), then one
// launch of as many blocks for each of the two rows as fill the card once
// (at most one a non-empty segment).
template <bool RING>
cudaError_t head_launch(const HeadArgs &a, int sms, long long smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coo_head_kernel<RING>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, coo_head_kernel<RING>, HEAD_THREADS, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * sms / 2;
  if (grid > a.n_nz) grid = a.n_nz;
  if (grid < 1) grid = 1;
  coo_head_kernel<RING><<<dim3((unsigned)grid, 2),
                              HEAD_THREADS, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plain segment sums into `out` (see the file's head): x (rows, 24);
// ring: vals (nnz, 24), else (nnz,); by_size: the n_full non-empty
// segments, the n_heavy with more than COO_LIGHT entries first.  Returns
// the cudaError_t of the launch.
int lt_coo_matvec(const int *off, const int *gather, const u64 *vals,
                  const int *by_size, int n_heavy, int n_full,
                  long long nseg, long long per, const u64 *x, int ring,
                  int t_layout, u64 *out, cudaStream_t stream) {
  const long long light = (nseg + COO_GROUPS - 1) / COO_GROUPS;
  if (nseg < 1 || per < 1 || nseg % per || n_heavy < 0 ||
      n_full < n_heavy || light + n_heavy > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const CooArgs a{off, gather, by_size, vals, x, out, nseg, per, light,
                  t_layout};
  const unsigned grid = (unsigned)(light + n_heavy);
  if (ring)
    coo_kernel<true><<<grid, COO_THREADS, 0, stream>>>(a);
  else
    coo_kernel<false><<<grid, COO_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The fold head's challenged-z sums (see the file's head), added into
// the two c rows out0 and out1, each (24, per): nz (n_nz,) the non-empty
// segments in position order, nz_off (n_nz + 1,) their first entries and
// nnz; z (2 nwit, z_rows, 24), zeta (2 nwit, t, 3); ring: vals (nnz,
// 24), else (nnz,).  Returns the cudaError_t of the launch.
int lt_coo_head(const int *nz, const int *nz_off, int n_nz,
                const int *gather, const int *mats, const u64 *vals,
                int ring, const u64 *z, long long z_rows, const u64 *zeta,
                int nwit, int t, long long per, u64 *out0, u64 *out1,
                cudaStream_t stream) {
  if (n_nz < 0 || nwit < 1 || t < 1 || per < 1 || out0 == nullptr ||
      out1 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_nz == 0) return (int)cudaSuccess;
  const long long smem = 8LL * (5LL * t * nwit + 24 * HEAD_LANES);
  int dev = 0, sms = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > most) return (int)cudaErrorInvalidValue;
  const HeadArgs a{nz,   nz_off, gather, mats, vals, z,    zeta,
                   out0, out1,   z_rows, per,  n_nz, nwit, t};
  return (int)(ring ? head_launch<true>(a, sms, smem, stream)
                    : head_launch<false>(a, sms, smem, stream));
}

}  // extern "C"
