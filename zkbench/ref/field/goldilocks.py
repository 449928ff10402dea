"""Goldilocks field arithmetic for TPU: p = 2^64 - 2^32 + 1.

TPUs have no native 64-bit integer multiply, so a field element is carried as
a pair of uint32 limbs ``(lo, hi)`` with value ``lo + hi * 2^32``, kept in
canonical form (< p) at every op boundary.  All operations are branch-free
vector ops (VPU-friendly) and exact.

Reduction exploits the special prime structure:

    2^64 ≡ 2^32 - 1 (mod p)        (EPSILON = 2^32 - 1)
    2^96 ≡ -1      (mod p)

so a 128-bit product ``n = n_lo + 2^64*(a + 2^32*b)`` reduces as
``n_lo + EPSILON*a - b (mod p)`` — two 64-bit corrections, no division.

Reference semantics: arkworks ``Fp64<MontBackend>`` with modulus
18446744069414584321 (reference: latticeum/crates/stark-rings/crates/ring/src/
cyclotomic_ring/models/goldilocks/mod.rs:16-27).  We use the canonical (non-
Montgomery) representation; results are bit-identical field values.
"""

from __future__ import annotations

from .. import backend as B
import numpy as np

P = 18446744069414584321  # 2^64 - 2^32 + 1
P_LO = np.uint32(1)
P_HI = np.uint32(0xFFFFFFFF)
EPSILON = np.uint32(0xFFFFFFFF)  # 2^32 - 1 == 2^64 mod p
MASK16 = np.uint32(0xFFFF)

U32 = np.uint32


def _u32(x):
    return B.xp.asarray(x, dtype=U32)


# ---------------------------------------------------------------------------
# conversion helpers (host side)
# ---------------------------------------------------------------------------

def from_int(values) -> tuple[B.xp.ndarray, B.xp.ndarray]:
    """Python ints / numpy array of objects -> (lo, hi) uint32 arrays."""
    arr = np.asarray(values, dtype=object)
    try:
        # fast path: all values already in [0, 2^64) — vectorized split.
        # 2^64 < 2P, so one conditional subtraction canonicalizes.
        w = arr.astype(np.uint64)
        w = np.where(w >= np.uint64(P), w - np.uint64(P), w)
        return (B.xp.asarray((w & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                B.xp.asarray((w >> np.uint64(32)).astype(np.uint32)))
    except (OverflowError, TypeError, ValueError):
        pass
    flat = arr.reshape(-1)
    lo = np.empty(flat.shape, dtype=np.uint32)
    hi = np.empty(flat.shape, dtype=np.uint32)
    for i, v in enumerate(flat):
        v = int(v) % P
        lo[i] = v & 0xFFFFFFFF
        hi[i] = v >> 32
    return (B.xp.asarray(lo.reshape(arr.shape)), B.xp.asarray(hi.reshape(arr.shape)))


def to_int(g) -> np.ndarray:
    """(lo, hi) -> numpy object array of Python ints (vectorized: combine in
    uint64, then tolist() yields exact Python ints)."""
    lo, hi = g
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    combined = lo | (hi << np.uint64(32))
    return np.array(combined.tolist(), dtype=object).reshape(lo.shape)


def to_int_lists(g):
    """(lo, hi) -> nested Python lists of ints (one pass, no object array).

    ~3x cheaper than to_int(...).tolist() / per-element int() loops on the
    proof-fetch paths (tens of thousands of values per fold step)."""
    lo = np.asarray(g[0], dtype=np.uint64)
    hi = np.asarray(g[1], dtype=np.uint64)
    return (lo | (hi << np.uint64(32))).tolist()


def zeros(shape):
    return (B.xp.zeros(shape, dtype=U32), B.xp.zeros(shape, dtype=U32))


def ones(shape):
    return (B.xp.ones(shape, dtype=U32), B.xp.zeros(shape, dtype=U32))


def full(shape, value: int):
    value = int(value) % P
    return (
        B.xp.full(shape, value & 0xFFFFFFFF, dtype=U32),
        B.xp.full(shape, value >> 32, dtype=U32),
    )


def const(value: int):
    """Scalar constant as a rank-0 limb pair."""
    value = int(value) % P
    return (_u32(value & 0xFFFFFFFF), _u32(value >> 32))


# ---------------------------------------------------------------------------
# 64-bit limb helpers
# ---------------------------------------------------------------------------

def _addc(a, b):
    """u32 + u32 -> (sum, carry)."""
    s = a + b
    return s, (s < a).astype(U32)


def _subb(a, b):
    """u32 - u32 -> (diff, borrow)."""
    d = a - b
    return d, (a < b).astype(U32)


def _mul32(a, b):
    """u32 * u32 -> (lo, hi) exact 64-bit product via 16-bit halves."""
    a0 = a & MASK16
    a1 = a >> 16
    b0 = b & MASK16
    b1 = b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> 16) + (p01 & MASK16) + (p10 & MASK16)
    lo = (p00 & MASK16) | (mid << 16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return lo, hi


def _add64(alo, ahi, blo, bhi):
    """64-bit add -> (lo, hi, carry_out)."""
    lo, c0 = _addc(alo, blo)
    hi1, c1 = _addc(ahi, bhi)
    hi, c2 = _addc(hi1, c0)
    return lo, hi, c1 + c2


def _sub64(alo, ahi, blo, bhi):
    """64-bit sub -> (lo, hi, borrow_out)."""
    lo, b0 = _subb(alo, blo)
    hi1, b1 = _subb(ahi, bhi)
    hi, b2 = _subb(hi1, b0)
    return lo, hi, b1 + b2


def _geq_p(lo, hi):
    """value >= p  (p = 2^32*0xFFFFFFFF + 1)."""
    return (hi == P_HI) & (lo >= P_LO)


def _cond_sub_p(lo, hi):
    """Subtract p where value >= p (value < 2^64). One pass suffices."""
    m = _geq_p(lo, hi)
    return B.xp.where(m, lo - P_LO, lo), B.xp.where(m, hi - P_HI, hi)


# ---------------------------------------------------------------------------
# field ops — inputs canonical (< p), outputs canonical
# ---------------------------------------------------------------------------

def add(a, b):
    alo, ahi = a
    blo, bhi = b
    lo, hi, ov = _add64(alo, ahi, blo, bhi)
    # total = a+b < 2p < 2^65. If ov: total - p = wrapped + (2^64 - p) = wrapped + EPSILON.
    lo2, c = _addc(lo, EPSILON)
    hi2 = hi + c
    lo = B.xp.where(ov > 0, lo2, lo)
    hi = B.xp.where(ov > 0, hi2, hi)
    # Now value < 2^64; canonicalize.
    return _cond_sub_p(lo, hi)


def sub(a, b):
    alo, ahi = a
    blo, bhi = b
    lo, hi, bw = _sub64(alo, ahi, blo, bhi)
    # If borrow: wrapped = a - b + 2^64; true value a - b + p = wrapped - EPSILON.
    lo2, bb = _subb(lo, EPSILON)
    hi2 = hi - bb
    lo = B.xp.where(bw > 0, lo2, lo)
    hi = B.xp.where(bw > 0, hi2, hi)
    return lo, hi


def neg(a):
    lo, hi = a
    nz = ((lo | hi) != 0)
    rlo, rhi, _ = _sub64(P_LO, P_HI, lo, hi)
    return B.xp.where(nz, rlo, lo * 0), B.xp.where(nz, rhi, hi * 0)


def _mul64_full(alo, ahi, blo, bhi):
    """64x64 -> 128-bit product as four u32 words (r0..r3, little-endian)."""
    l0, h0 = _mul32(alo, blo)
    l1, h1 = _mul32(alo, bhi)
    l2, h2 = _mul32(ahi, blo)
    l3, h3 = _mul32(ahi, bhi)
    r0 = l0
    # r1 = h0 + l1 + l2 (carries into r2)
    r1a, c0 = _addc(h0, l1)
    r1, c1 = _addc(r1a, l2)
    # r2 = h1 + h2 + l3 + carries (carries into r3)
    r2a, c2 = _addc(h1, h2)
    r2b, c3 = _addc(r2a, l3)
    r2, c4 = _addc(r2b, c0 + c1)
    r3 = h3 + c2 + c3 + c4
    return r0, r1, r2, r3


def reduce128(r0, r1, r2, r3):
    """Reduce a 128-bit value (r0..r3 u32 words) to canonical (< p).

    n = n_lo + 2^64*(r2 + 2^32*r3) ≡ n_lo - r3 + EPSILON*r2 (mod p).
    """
    # t = n_lo - r3 (64-bit); on borrow subtract EPSILON again (wrapped value
    # >= 2^64 - 2^32 so this cannot underflow).
    tlo, thi, bw = _sub64(r0, r1, r3, _u32(0))
    tlo2, bb = _subb(tlo, EPSILON)
    thi2 = thi - bb
    tlo = B.xp.where(bw > 0, tlo2, tlo)
    thi = B.xp.where(bw > 0, thi2, thi)
    # t += EPSILON * r2;  EPSILON*r2 = (r2 << 32) - r2.
    elo, ehi, ebw = _sub64(_u32(0), r2, r2, _u32(0))
    del ebw  # r2<<32 >= r2 always, never borrows (r2==0 case: 0-0)
    lo, hi, ov = _add64(tlo, thi, elo, ehi)
    lo2, c = _addc(lo, EPSILON)
    hi2 = hi + c
    lo = B.xp.where(ov > 0, lo2, lo)
    hi = B.xp.where(ov > 0, hi2, hi)
    return _cond_sub_p(lo, hi)


def mul(a, b):
    alo, ahi = a
    blo, bhi = b
    return reduce128(*_mul64_full(alo, ahi, blo, bhi))


def mul_2e40(a):
    """x * 2^40 mod p as a word shift + one reduce128 (~3x cheaper than a
    full mul) — the Fq3 nonresidue W = 2^40 multiply in every Fq3 product."""
    lo, hi = a
    r1 = lo << np.uint32(8)
    r2 = (lo >> np.uint32(24)) | (hi << np.uint32(8))
    r3 = hi >> np.uint32(24)
    return reduce128(B.xp.zeros_like(lo), r1, r2, r3)


def mul_const(a, c: int):
    """Multiply by a host-known constant (still a full mul; kept for clarity)."""
    lo, hi = a
    cc = int(c) % P
    return mul(a, (B.xp.full_like(lo, cc & 0xFFFFFFFF), B.xp.full_like(hi, cc >> 32)))


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a ** e for host-known integer e (square-and-multiply, unrolled)."""
    lo, hi = a
    result = (B.xp.ones_like(lo), B.xp.zeros_like(hi))
    base = a
    e = int(e)
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inv(a):
    """a^(p-2) — Fermat inverse (0 maps to 0)."""
    return pow_const(a, P - 2)


def select(mask, a, b):
    """Elementwise select: mask ? a : b (mask is bool array)."""
    return (B.xp.where(mask, a[0], b[0]), B.xp.where(mask, a[1], b[1]))


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def is_zero(a):
    return (a[0] | a[1]) == 0


# ---------------------------------------------------------------------------
# batched big-sum: Σ_i a_i mod p along an axis, overflow-safe
# ---------------------------------------------------------------------------

def sum_axis(a, axis: int = -1):
    """Sum of canonical elements along `axis`, exact mod p.

    Strategy: split each element into four 16-bit columns held in uint32,
    partial-sum in chunks of <= 2^16 terms (no overflow: 2^16 * (2^16-1) <
    2^32), recombine columns as a 128-bit value, reduce.
    """
    lo, hi = a
    axis = axis % lo.ndim
    n = lo.shape[axis]
    # move target axis to front for chunking
    lo = B.xp.moveaxis(lo, axis, 0)
    hi = B.xp.moveaxis(hi, axis, 0)

    cols = B.xp.stack(
        [lo & MASK16, lo >> 16, hi & MASK16, hi >> 16], axis=0
    )  # (4, n, ...)

    CH = 1 << 16
    if n <= CH:
        csum = B.xp.sum(cols, axis=1, dtype=U32)  # (4, ...)
        return _combine_cols_small(csum)
    # chunked: pad n up to multiple of CH
    pad = (-n) % CH
    if pad:
        cols = B.xp.pad(cols, [(0, 0), (0, pad)] + [(0, 0)] * (cols.ndim - 2))
    cols = cols.reshape((4, -1, CH) + cols.shape[2:])
    csum = B.xp.sum(cols, axis=2, dtype=U32)  # (4, nchunk, ...) each < 2^32
    # reduce each chunk to a canonical field element, then tree-add them
    elems = _combine_cols_small(csum)  # pair of (nchunk, ...)
    return _tree_reduce_add(elems)


def _combine_cols_small(csum):
    """cols (4, ...) uint32 with weights 2^0,2^16,2^32,2^48 -> canonical elems."""
    c0, c1, c2, c3 = csum[0], csum[1], csum[2], csum[3]
    # value = c0 + c1*2^16 + c2*2^32 + c3*2^48  < 2^80
    r0, ca = _addc(c0, (c1 & MASK16) << 16)
    r1a = (c1 >> 16) + ca  # <= 2^16+1, no overflow
    r1, cb = _addc(r1a, c2)
    r1, cc = _addc(r1, (c3 & MASK16) << 16)
    r2 = (c3 >> 16) + cb + cc
    return reduce128(r0, r1, r2, B.xp.zeros_like(r0))


def _tree_reduce_add(a):
    lo, hi = a
    while lo.shape[0] > 1:
        m = lo.shape[0]
        if m % 2:
            lo = B.xp.concatenate([lo, B.xp.zeros_like(lo[:1])], axis=0)
            hi = B.xp.concatenate([hi, B.xp.zeros_like(hi[:1])], axis=0)
            m += 1
        h = m // 2
        lo2, hi2 = add((lo[:h], hi[:h]), (lo[h:], hi[h:]))
        lo, hi = lo2, hi2
    return lo[0], hi[0]


def dot(a, b, axis: int = -1):
    """Inner product Σ a_i b_i mod p along `axis`."""
    return sum_axis(mul(a, b), axis=axis)
