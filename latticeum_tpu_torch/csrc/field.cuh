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

// An unreduced sum of 64x64-bit products, lo + 2^64 hi + 2^128 top: up to
// 2^32 products of any two words fit.
struct U192 {
  u64 lo, hi;
  unsigned top;
};

// s += a * b, the full 128-bit product, carries into top.
__device__ __forceinline__ void mac192(U192 &s, u64 a, u64 b) {
  asm("mad.lo.cc.u64 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u64 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+l"(s.lo), "+l"(s.hi), "+r"(s.top)
      : "l"(a), "l"(b));
}

// s mod p, canonical: 2^128 = 2^96 * 2^32 = -2^32 (mod p), and top << 32
// <= p - 1.
__device__ __forceinline__ u64 reduce192(const U192 &s) {
  return gl_sub(gl_reduce128(s.lo, s.hi), (u64)s.top << 32);
}

// x^7, the Poseidon2 s-box: x^2, x^4, x^6, x^7.
__device__ __forceinline__ u64 gl_pow7(u64 x) {
  const u64 x2 = gl_mul(x, x);
  const u64 x4 = gl_mul(x2, x2);
  const u64 x6 = gl_mul(x4, x2);
  return gl_mul(x6, x);
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

// d += c * x in Fq3, unreduced: with w = 2^40,
//   d0 += c0 x0 + (w c1) x2 + (w c2) x1
//   d1 += c0 x1 + c1 x0     + (w c2) x2
//   d2 += c0 x2 + c1 x1     + c2 x0
// nine 128-bit products into the three 192-bit sums, given w c1 and w c2.
__device__ __forceinline__ void fq3_mac_w(U192 (&d)[3], u64 c0, u64 c1,
                                          u64 c2, u64 wc1, u64 wc2,
                                          const Fq3 &x) {
  mac192(d[0], c0, x.c0);
  mac192(d[0], wc1, x.c2);
  mac192(d[0], wc2, x.c1);
  mac192(d[1], c0, x.c1);
  mac192(d[1], c1, x.c0);
  mac192(d[1], wc2, x.c2);
  mac192(d[2], c0, x.c2);
  mac192(d[2], c1, x.c1);
  mac192(d[2], c2, x.c0);
}

// The same, w c1 and w c2 formed here (two reductions).
__device__ __forceinline__ void fq3_mac(U192 (&d)[3], const Fq3 &c,
                                        const Fq3 &x) {
  fq3_mac_w(d, c.c0, c.c1, c.c2, gl_mul_w(c.c1), gl_mul_w(c.c2), x);
}

__device__ __forceinline__ void zero192(U192 (&d)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = U192{0ULL, 0ULL, 0u};
}

__device__ __forceinline__ Fq3 reduce3(const U192 (&d)[3]) {
  return Fq3{reduce192(d[0]), reduce192(d[1]), reduce192(d[2])};
}

}  // namespace lt
