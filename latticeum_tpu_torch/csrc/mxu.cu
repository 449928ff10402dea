// The digit-plane kernels of the evaluation claims, for sm_90a.
//
// The JAX package computes its ring contractions (latticeum_tpu/field/mxu.py
// ring_contract) in XLA, with no Pallas kernel: the digit split
// (digit_planes, mxu.py:45, plus the plane layout of ring_contract), one
// int8 dot_general per slot, and the recombination (_recombine, mxu.py:91).
// Here the product is torch._int_mm (cuBLASLt int8 on the tensor cores) and
// the two steps around it are these kernels.  The wrappers and the
// plain-torch twins are in field/mxu.py, which states the layouts.
//
// digit_split_kernel: u64 values -> balanced base-256 int8 digits.  One
//   thread per ring element (row j, column) of the padded planes, a grid
//   row per ring row and a grid layer per chunk, so no index is divided.
//   It reads the element's 24 values through two strides, so the standard
//   layout (rows, n, 24) (192 contiguous bytes a thread) and the t-layout
//   (rows, 24, n) (each value coalesced over the warp) are read in place,
//   with no transposed copy, and each byte of the input once.  It writes
//   27 plane rows in each of the 8 slot blocks; neighbouring threads take
//   neighbouring columns, so every byte row is coalesced.  Columns past the
//   data get zero digits, and the last grid row zeroes the padding plane
//   rows.  Bound: bytes (8 read, 9 written per value).
// plane_recombine_kernel: one chunk's int32 plane products O (8, ra, rb)
//   into out (t, kb, 24).  Output (j, k, slot, comp) sums 3 component
//   pairs (i, i2) x 81 plane products O[slot, 27 j + 9 i + dA,
//   27 k + 9 i2 + dB] into exact int64 sums per digit weight 2^{8(dA+dB)}
//   (|sum| < 2^36), evaluates them in base 256 by Horner's rule mod p
//   (times the nonresidue W = 2^40 where i + i2 >= 3) and adds the result
//   to the running sum of the earlier chunks.  Bound: bytes (the int32
//   products read once, out read and written); its arithmetic is a few
//   field operations per output.
//   Every product lands in exactly one output, so nothing is reused: what
//   matters is that each is read in a coalesced load.  A block takes one
//   (slot, j) and a group of up to RC_KG = 8 ring columns k: it copies the
//   27 plane rows of j over the group's 27 kg columns (27 rows of up to 864
//   contiguous bytes, a thread per column) into shared memory, then a
//   thread per (k, comp, i) sums its 81 products and runs its Horner chain,
//   and a thread per (k, comp) adds the three into out.  The same kernel
//   serves the wide shapes (kb = 15, 30: 2 or 4 blocks per (slot, j)) and
//   the skinny ones (kb = 1: one block per (slot, j) with a 27 x 27 tile).
//   The first design took one thread per output; neighbouring lanes read
//   products of 8 slots 11 MB apart and 3 column blocks, about 24 sectors
//   of 32 bytes per load for 4 bytes of each.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

using namespace lt;

#define BLOCK 256
#define NPLANES 9
#define RC_THREADS 256  // at least 27 RC_KG (a tile row) and 9 RC_KG
#define RC_KG 8

namespace {

__global__ void __launch_bounds__(BLOCK)
    digit_split_kernel(const u64 *__restrict__ x, int8_t *__restrict__ planes,
                       int rows, int n, long long s_row, int s_col, int s_pos,
                       int rows_pad, int n_pad, int chunk) {
  const int c0 = blockIdx.z * chunk;
  const int width = min(chunk, n_pad - c0);
  const int cc = blockIdx.x * BLOCK + threadIdx.x;  // column in the chunk
  if (cc >= width) return;
  const int j = blockIdx.y;
  const long long slot = (long long)rows_pad * width;  // one slot's block
  int8_t *out = planes + 8LL * rows_pad * c0 + cc;
  if (j == rows) {  // the padding plane rows of every slot
    for (int s = 0; s < 8; ++s)
      for (int r = 3 * NPLANES * rows; r < rows_pad; ++r)
        out[s * slot + r * width] = 0;
    return;
  }
  const int col = c0 + cc;
  const bool live = col < n;
  const u64 *xj = x + j * s_row + (long long)col * s_col;
  out += (long long)(3 * NPLANES * j) * width;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const u64 v = live ? xj[(3 * s + i) * s_pos] : 0ULL;
      int8_t *o = out + (NPLANES * i) * width;
      int carry = 0;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int b = (int)((v >> (8 * d)) & 0xFFULL) + carry;
        carry = b > 127;
        o[d * width] = (int8_t)(b - 256 * carry);
      }
      o[8 * width] = (int8_t)carry;
    }
    out += slot;
  }
}

__device__ __forceinline__ u64 signed_to_field(long long v) {
  return v >= 0 ? (u64)v : P - (u64)(-v);
}

// a * 256 mod p: the shift's high byte times 2^64, reduced.
__device__ __forceinline__ u64 gl_mul_256(u64 a) {
  return gl_reduce128(a << 8, a >> 56);
}

__global__ void __launch_bounds__(RC_THREADS)
    plane_recombine_kernel(const int *__restrict__ O, u64 *__restrict__ out,
                           int kb, long long ra, long long rb) {
  __shared__ int tile[3 * NPLANES * 3 * NPLANES * RC_KG];
  __shared__ u64 part[9 * RC_KG];
  const int s = blockIdx.z, j = blockIdx.y, k0 = blockIdx.x * RC_KG;
  const int kg = min(RC_KG, kb - k0);
  const int w = 3 * NPLANES * kg;  // tile columns
  const int tid = threadIdx.x;
  const int *src = O + ((long long)s * ra + 3LL * NPLANES * j) * rb +
                   3LL * NPLANES * k0;
  if (tid < w) {
#pragma unroll
    for (int r = 0; r < 3 * NPLANES; ++r) tile[r * w + tid] = src[r * rb + tid];
  }
  __syncthreads();
  if (tid < 9 * kg) {  // (k, comp, i): the pair (i, i2) lands in comp
    const int k = tid / 9, comp = tid / 3 % 3, i = tid % 3;
    const int i2 = (comp - i + 3) % 3;
    const int *blk = tile + NPLANES * i * w + 3 * NPLANES * k + NPLANES * i2;
    long long d[2 * NPLANES - 1];
#pragma unroll
    for (int e = 0; e < 2 * NPLANES - 1; ++e) d[e] = 0;
#pragma unroll
    for (int a = 0; a < NPLANES; ++a) {
#pragma unroll
      for (int b = 0; b < NPLANES; ++b) d[a + b] += blk[a * w + b];
    }
    u64 h = 0ULL;
#pragma unroll
    for (int e = 2 * NPLANES - 2; e >= 0; --e)
      h = gl_add(gl_mul_256(h), signed_to_field(d[e]));
    part[tid] = i + i2 >= 3 ? gl_mul_w(h) : h;  // Y^3 = W
  }
  __syncthreads();
  if (tid < 3 * kg) {  // (k, comp)
    const int k = tid / 3, comp = tid % 3;
    u64 *o = out + ((long long)j * kb + k0 + k) * 24 + 3 * s + comp;
    *o = gl_add(*o, gl_add(gl_add(part[3 * tid], part[3 * tid + 1]),
                           part[3 * tid + 2]));
  }
}

}  // namespace

extern "C" {

// Both entry points return the cudaError_t of their launch (0 = success).

int lt_digit_split(const u64 *x, int8_t *planes, int rows, int n,
                   long long s_row, int s_col, int s_pos, int rows_pad,
                   int n_pad, int chunk, cudaStream_t stream) {
  const dim3 grid((unsigned)((chunk + BLOCK - 1) / BLOCK), (unsigned)rows + 1,
                  (unsigned)((n_pad + chunk - 1) / chunk));
  digit_split_kernel<<<grid, BLOCK, 0, stream>>>(
      x, planes, rows, n, s_row, s_col, s_pos, rows_pad, n_pad, chunk);
  return (int)cudaGetLastError();
}

int lt_plane_recombine(const int *O, u64 *out, long long t, long long kb,
                       long long ra, long long rb, cudaStream_t stream) {
  if (t < 1 || t > 65535 || kb < 1 || kb > (1LL << 30) ||
      ra < 3 * NPLANES * t || rb < 3 * NPLANES * kb)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((kb + RC_KG - 1) / RC_KG), (unsigned)t, 8);
  plane_recombine_kernel<<<grid, RC_THREADS, 0, stream>>>(O, out, (int)kb,
                                                          ra, rb);
  return (int)cudaGetLastError();
}

}  // extern "C"
