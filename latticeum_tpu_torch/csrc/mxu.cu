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
// plane_recombine_kernel: one thread per output (row j, column k, slot s,
//   component c).  It sums its 3 component pairs x 81 plane products into
//   17 exact int64 sums per digit weight 2^{8e}, e = dA + dB (and 17 more
//   where the nonresidue W = 2^40 applies; |sum| < 2^37), then evaluates
//   both in base 256 by Horner's rule mod p and adds the result to the
//   running sum of the earlier chunks.  Bound: bytes (the int32 products,
//   read once); its arithmetic is 34 field multiply-adds per output.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

using namespace lt;

#define BLOCK 256
#define NPLANES 9

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

__global__ void __launch_bounds__(BLOCK)
    plane_recombine_kernel(const int *__restrict__ O, u64 *__restrict__ out,
                           long long t, long long kb, long long ra,
                           long long rb) {
  const long long idx = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (idx >= t * kb * 24) return;
  const int pos = (int)(idx % 24);
  const long long k = idx / 24 % kb;
  const long long j = idx / 24 / kb;
  const int s = pos / 3, comp = pos % 3;
  const int *Os = O + (long long)s * ra * rb;
  long long s1[2 * NPLANES - 1], sw[2 * NPLANES - 1];
#pragma unroll
  for (int e = 0; e < 2 * NPLANES - 1; ++e) s1[e] = sw[e] = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i2 = (comp - i + 3) % 3;  // the pair (i, i2) lands in comp
    const bool w = i + i2 >= 3;         // Y^3 = W
    const int *blk = Os + ((3 * j + i) * NPLANES) * rb + (3 * k + i2) * NPLANES;
#pragma unroll
    for (int a = 0; a < NPLANES; ++a) {
#pragma unroll
      for (int b = 0; b < NPLANES; ++b) {
        const long long v = blk[a * rb + b];
        s1[a + b] += w ? 0 : v;
        sw[a + b] += w ? v : 0;
      }
    }
  }
  u64 h1 = 0ULL, hw = 0ULL;
#pragma unroll
  for (int e = 2 * NPLANES - 2; e >= 0; --e) {
    h1 = gl_add(gl_mul(h1, 256ULL), signed_to_field(s1[e]));
    hw = gl_add(gl_mul(hw, 256ULL), signed_to_field(sw[e]));
  }
  out[idx] = gl_add(out[idx], gl_add(h1, gl_mul_w(hw)));
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
  const long long total = t * kb * 24;
  plane_recombine_kernel<<<(unsigned)((total + BLOCK - 1) / BLOCK), BLOCK, 0,
                           stream>>>(O, out, t, kb, ra, rb);
  return (int)cudaGetLastError();
}

}  // extern "C"
