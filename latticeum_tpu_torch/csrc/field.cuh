// Goldilocks (p = 2^64 - 2^32 + 1) and Fq3 = Fq[Y]/(Y^3 - 2^40) device
// arithmetic.  An element is one canonical (< p) uint64, the same bits the
// torch side holds in int64.  Counterpart of field/goldilocks.py and
// field/fq3.py; the 64x64 -> 128-bit product uses __umul64hi and the
// reduction 2^64 = 2^32 - 1, 2^96 = -1 (mod p).
#pragma once

#include <cstdint>

namespace lt {

typedef unsigned long long u64;

constexpr u64 P = 0xFFFFFFFF00000001ULL;
constexpr u64 EPS = 0xFFFFFFFFULL;  // 2^64 mod p

__device__ __forceinline__ u64 gl_add(u64 a, u64 b) {
  u64 s = a + b;
  if (s < a) s += EPS;  // carry out of 2^64
  if (s >= P) s -= P;
  return s;
}

__device__ __forceinline__ u64 gl_sub(u64 a, u64 b) {
  u64 d = a - b;
  if (a < b) d -= EPS;  // borrow: add p = subtract EPS mod 2^64
  return d;
}

// (lo + 2^64 hi) mod p with hi = hl + 2^32 hh: lo - hh + EPS * hl.
__device__ __forceinline__ u64 gl_reduce128(u64 lo, u64 hi) {
  const u64 hh = hi >> 32;
  const u64 hl = hi & EPS;
  u64 t = lo - hh;
  if (lo < hh) t -= EPS;
  const u64 e = (hl << 32) - hl;
  u64 s = t + e;
  if (s < t) s += EPS;
  if (s >= P) s -= P;
  return s;
}

__device__ __forceinline__ u64 gl_mul(u64 a, u64 b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

// a * 2^40 (the Fq3 nonresidue) as a shift and one reduction.
__device__ __forceinline__ u64 gl_mul_w(u64 a) {
  return gl_reduce128(a << 40, a >> 24);
}

struct Fq3 {
  u64 c0, c1, c2;
};

__device__ __forceinline__ Fq3 fq3_zero() { return Fq3{0ULL, 0ULL, 0ULL}; }

__device__ __forceinline__ Fq3 fq3_add(const Fq3 &a, const Fq3 &b) {
  return Fq3{gl_add(a.c0, b.c0), gl_add(a.c1, b.c1), gl_add(a.c2, b.c2)};
}

__device__ __forceinline__ Fq3 fq3_sub(const Fq3 &a, const Fq3 &b) {
  return Fq3{gl_sub(a.c0, b.c0), gl_sub(a.c1, b.c1), gl_sub(a.c2, b.c2)};
}

// Karatsuba: 6 base multiplies.
__device__ __forceinline__ Fq3 fq3_mul(const Fq3 &a, const Fq3 &b) {
  const u64 m0 = gl_mul(a.c0, b.c0);
  const u64 m1 = gl_mul(a.c1, b.c1);
  const u64 m2 = gl_mul(a.c2, b.c2);
  const u64 m01 = gl_mul(gl_add(a.c0, a.c1), gl_add(b.c0, b.c1));
  const u64 m02 = gl_mul(gl_add(a.c0, a.c2), gl_add(b.c0, b.c2));
  const u64 m12 = gl_mul(gl_add(a.c1, a.c2), gl_add(b.c1, b.c2));
  const u64 t1 = gl_sub(m01, gl_add(m0, m1));
  const u64 t3 = gl_sub(m12, gl_add(m1, m2));
  const u64 t2 = gl_add(gl_sub(m02, gl_add(m0, m2)), m1);
  return Fq3{gl_add(m0, gl_mul_w(t3)), gl_add(t1, gl_mul_w(m2)), t2};
}

// Chung-Hasan SQR3: 5 base multiplies.
__device__ __forceinline__ Fq3 fq3_square(const Fq3 &a) {
  const u64 s0 = gl_mul(a.c0, a.c0);
  const u64 a0a1 = gl_mul(a.c0, a.c1);
  const u64 s1 = gl_add(a0a1, a0a1);
  const u64 t = gl_add(gl_sub(a.c0, a.c1), a.c2);
  const u64 s2 = gl_mul(t, t);
  const u64 a1a2 = gl_mul(a.c1, a.c2);
  const u64 s3 = gl_add(a1a2, a1a2);
  const u64 s4 = gl_mul(a.c2, a.c2);
  return Fq3{gl_add(s0, gl_mul_w(s3)), gl_add(s1, gl_mul_w(s4)),
             gl_sub(gl_add(gl_add(s1, s2), s3), gl_add(s0, s4))};
}

}  // namespace lt
