// The width-16 Poseidon2 permutation of the device challenger, one state
// held by one warp, and what it is built from: the 96-bit sums of its
// linear layers (Acc), the s-box, the linear layer, the permutation and
// the per-lane constant table.  Shared by csrc/challenger.cu
// (round_tail_kernel, perm16_chain_kernel), whose note states the design,
// and csrc/recon.cu (lin_recon_tail_kernel).
#pragma once

#include "field.cuh"

using namespace lt;

#define CH_WIDTH 16
#define CH_RATE 12
#define CH_EXT_INIT 0
#define CH_EXT_TERM 64
#define CH_INTERNAL 128
#define CH_DIAG 150
#define CH_NCONST 166
#define CH_FULL 0xffffffffu
#define CH_ROUNDS 30
#define CH_TABLE (32 * CH_WIDTH)

namespace {

typedef unsigned int u32;

// A sum of a few field values kept as the exact integer
// w0 + 2^32 w1 + 2^64 w2 (w2 small): the linear layers add without a
// reduction and fold once at the end.
struct Acc {
  u32 w0, w1, w2;
};

__device__ __forceinline__ Acc acc_of(u64 v) {
  return Acc{(u32)v, (u32)(v >> 32), 0u};
}

// One carry chain of three 32-bit adds.
__device__ __forceinline__ Acc acc_add(Acc a, const Acc &b) {
  asm("add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, %5;"
      : "+r"(a.w0), "+r"(a.w1), "+r"(a.w2)
      : "r"(b.w0), "r"(b.w1), "r"(b.w2));
  return a;
}

__device__ __forceinline__ Acc acc_xor(const Acc &a, int m) {
  return Acc{__shfl_xor_sync(CH_FULL, a.w0, m),
             __shfl_xor_sync(CH_FULL, a.w1, m),
             __shfl_xor_sync(CH_FULL, a.w2, m)};
}

// The sum mod p as one u64 below 2^64, not always canonical:
// lo + w2 (2^64 mod p).  w2 < 64 at every call here, so w2 EPS < 2^38
// and after a carry out of 2^64 the sum is below 2^38 + 2^32: adding EPS
// once more cannot carry.
__device__ __forceinline__ u64 acc_fold(const Acc &a) {
  const u64 lo = ((u64)a.w1 << 32) | a.w0;
  const u64 e = ((u64)a.w2 << 32) - a.w2;
  const u64 s = lo + e;
  return s < e ? s + EPS : s;
}

__device__ __forceinline__ u64 canon(u64 x) { return x >= P ? x - P : x; }

// x^7 at multiply depth 3: x^2; x^3 and x^4 side by side; x^7.  gl_mul
// takes any u64 and returns a canonical value.
__device__ __forceinline__ u64 ch_pow7(u64 x) {
  const u64 x2 = gl_mul(x, x);
  const u64 x3 = gl_mul(x2, x);
  const u64 x4 = gl_mul(x2, x2);
  return gl_mul(x3, x4);
}

// The external linear layer on the warp's state (element lane & 15 in each
// lane; lanes 16-31 hold a copy and never leave their half), plus this
// lane's constant c of the next round.  M4 is circulant,
// d_i = t + s_i + 2 s_{i+1} with t the quad's sum; then each element gets
// its column's sum over the 4 quads.  At most 36 values of < 2^64 are
// summed (w2 < 36) before the one fold.
__device__ __forceinline__ u64 linear16(u64 y, int lane, u64 c) {
  const Acc a = acc_of(y);
  Acc t = acc_add(a, acc_xor(a, 1));
  t = acc_add(t, acc_xor(t, 2));
  const Acc n = acc_of(
      __shfl_sync(CH_FULL, y, (lane & ~3) | ((lane + 1) & 3)));
  const Acc d = acc_add(t, acc_add(a, acc_add(n, n)));
  Acc col = acc_add(d, acc_xor(d, 4));
  col = acc_add(col, acc_xor(col, 8));
  return acc_fold(acc_add(acc_add(d, acc_of(c)), col));
}

// One permutation of the warp's state s (canonical in, canonical out).
// kt: the (32, 16) table of what lane e adds before round r's s-boxes
// (round r's constant of element e; 0 for e != 0 in the internal rounds;
// rows 30 and 31 zero), in shared memory; diag: this lane's internal
// diagonal entry.  Every lane of the warp must call it.
//
// Between rounds each lane carries x, its element plus the next round's
// constant, below 2^64 but not reduced further: gl_mul and the sums take
// any u64.  The next round's constant is read one round ahead.  In an
// internal round every lane computes the s-box (only lane 0's is kept)
// while the sum of elements 1 ... 15 runs as a butterfly beside it; one
// shuffle then broadcasts lane 0's s-box, so the round's chain is the
// s-box, one multiply by the diagonal and two adds, not the s-box
// followed by the butterfly.
__device__ __forceinline__ u64 permute16(u64 s, const u64 *kt, u64 diag,
                                         int lane) {
  const int e = lane & 15;
  u64 x = linear16(s, lane, kt[e]);
  u64 c = kt[CH_WIDTH + e];
#pragma unroll 1
  for (int r = 0; r < 4; ++r) {
    x = linear16(ch_pow7(x), lane, c);
    c = kt[CH_WIDTH * (r + 2) + e];
  }
#pragma unroll
  for (int r = 4; r < 26; ++r) {
    const u64 y = ch_pow7(x);
    Acc rest = acc_of(e == 0 ? 0ULL : x);
#pragma unroll
    for (int m = 1; m < CH_WIDTH; m <<= 1)
      rest = acc_add(rest, acc_xor(rest, m));
    rest = acc_add(rest, acc_of(c));
    const u64 y0 = __shfl_sync(CH_FULL, y, lane & 16);
    const u64 m = gl_mul(e == 0 ? y : x, diag);
    // s_e d_e + (s-box of s_0) + sum_{i >= 1} s_i + c: 18 values, w2 < 18
    x = acc_fold(acc_add(acc_add(acc_of(m), acc_of(y0)), rest));
    c = kt[CH_WIDTH * (r + 2) + e];
  }
#pragma unroll 1
  for (int r = 26; r < CH_ROUNDS; ++r) {
    x = linear16(ch_pow7(x), lane, c);
    c = kt[CH_WIDTH * (r + 2) + e];
  }
  return canon(x);
}

// The per-lane constant table of permute16 from the caller's 166
// constants.
__device__ __forceinline__ void load_consts(u64 *kt,
                                            const u64 *__restrict__ consts) {
  for (int i = threadIdx.x; i < CH_TABLE; i += blockDim.x) {
    const int r = i / CH_WIDTH, e = i % CH_WIDTH;
    u64 v = 0ULL;
    if (r < 4)
      v = consts[CH_EXT_INIT + CH_WIDTH * r + e];
    else if (r < 26)
      v = e == 0 ? consts[CH_INTERNAL + r - 4] : 0ULL;
    else if (r < CH_ROUNDS)
      v = consts[CH_EXT_TERM + CH_WIDTH * (r - 26) + e];
    kt[i] = v;
  }
}

}  // namespace
