"""Goldilocks field arithmetic on torch tensors: p = 2^64 - 2^32 + 1.

Counterpart of ``latticeum_tpu/field/goldilocks.py``.  An element is one
u64 held in a ``torch.int64`` tensor (the same 64 bits; values >= 2^63 read
as negative int64), canonical (< p) at every op boundary.  The CUDA kernels
read the same storage as ``uint64_t``.

torch has no unsigned 64-bit add, shift or compare on either device, so the
unsigned operations are emulated on int64: ``int64`` add/sub/mul wrap mod
2^64 exactly like u64, an unsigned compare flips the sign bit of both sides
first, and a logical right shift masks off the sign-extended bits.

Reduction uses 2^64 = EPS (mod p) with EPS = 2^32 - 1 and 2^96 = -1, so a
128-bit product lo + 2^64 (a + 2^32 b) reduces to lo + EPS*a - b.
"""

from __future__ import annotations

import numpy as np
import torch

P = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF               # 2^64 mod p
MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)             # int64 with only the top bit set
P_I64 = P - (1 << 64)          # p as a signed int64 bit pattern
DTYPE = torch.int64


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _srl(x, k: int):
    """Logical right shift of the u64 bits by k (0 < k < 64)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _canon(x):
    """u64 (< 2^64 < 2p) -> canonical: one conditional subtraction of p."""
    return torch.where(_ult(x, P_I64), x, x - P_I64)


# -- conversions (host boundary) ------------------------------------------

def to_i64_bits(u64):
    """numpy uint64 array -> numpy int64 array with the same bits."""
    u = np.asarray(u64, dtype=np.uint64)
    return np.array(u, order="C", copy=not u.flags.c_contiguous).view(np.int64)


def from_limbs(limbs, device=None):
    """Reference (lo, hi) uint32 limb pair -> int64 tensor."""
    lo = np.asarray(limbs[0]).astype(np.uint64)
    hi = np.asarray(limbs[1]).astype(np.uint64)
    return torch.from_numpy(to_i64_bits(lo | (hi << np.uint64(32)))).to(device)


def upload(t, device):
    """A host tensor onto `device`; on a card, from pinned memory and
    without waiting for the work already queued there."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_limbs(x):
    """int64 tensor -> (lo, hi) uint32 numpy limb pair."""
    u = x.detach().cpu().contiguous().numpy().view(np.uint64)
    return ((u & np.uint64(MASK32)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def from_int(values, device=None):
    """Python ints (nested lists / object array) -> canonical int64 tensor."""
    arr = np.asarray(values, dtype=object)
    flat = [int(v) % P for v in arr.reshape(-1)]
    u = np.array(flat, dtype=np.uint64).reshape(arr.shape)
    return torch.from_numpy(to_i64_bits(u)).to(device)


def to_u64(x):
    """int64 tensor -> numpy uint64 array (host copy)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def to_int_lists(x):
    """int64 tensor -> nested Python int lists (canonical values)."""
    return to_u64(x).tolist()


def const(value: int, device=None):
    """Scalar field constant as a rank-0 int64 tensor."""
    return from_int(int(value) % P, device)


# -- field ops: inputs canonical, outputs canonical ------------------------

def add(a, b):
    s = a + b
    s = torch.where(_ult(s, a), s + EPS, s)      # carry: + 2^64 = + EPS
    return _canon(s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - EPS, d)   # borrow: + p = - EPS


def neg(a):
    return torch.where(a == 0, a, P_I64 - a)


def _reduce128(lo, hi):
    """(lo + 2^64 hi) mod p for a 128-bit value given as two u64 words."""
    hl = hi & MASK32
    hh = _srl(hi, 32)
    t = lo - hh
    t = torch.where(_ult(lo, hh), t - EPS, t)
    e = (hl << 32) - hl                          # EPS * hl < 2^64
    s = t + e
    s = torch.where(_ult(s, t), s + EPS, s)
    return _canon(s)


def mul(a, b):
    """Exact product mod p via the four 32x32 partial products."""
    a0, a1 = a & MASK32, _srl(a, 32)
    b0, b1 = b & MASK32, _srl(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _srl(p00, 32) + (p01 & MASK32) + (p10 & MASK32)
    lo = (p00 & MASK32) | (mid << 32)
    hi = p11 + _srl(p01, 32) + _srl(p10, 32) + _srl(mid, 32)
    return _reduce128(lo, hi)


def mul_2e40(a):
    """a * 2^40 mod p (the Fq3 nonresidue) as a shift plus one reduction."""
    return _reduce128(a << 40, _srl(a, 24))


def sum_axis(a, dim: int = -1):
    """Exact sum mod p along `dim`, for up to 2^31 terms.

    The 32-bit halves are summed separately in int64 (no overflow below
    2^31 terms), then recombined: S_lo + 2^32 S_hi with 2^64 = EPS."""
    s_lo = (a & MASK32).sum(dim)
    s_hi = _srl(a, 32).sum(dim)
    return _combine_halves(s_lo, s_hi)


def _combine_halves(s_lo, s_hi):
    """S_lo + 2^32 S_hi mod p for non-negative int64 S_lo, S_hi < 2^63."""
    top = _srl(s_hi, 32) * EPS                   # (S_hi >> 32) * 2^64
    mid = _canon((s_hi & MASK32) << 32)
    return add(add(s_lo, mid), _canon(top))


def segment_sum(vals, seg, num_segments: int):
    """Exact mod-p sums of rows of `vals` (n, ...) into `num_segments`
    buckets by int64 index `seg` (n,).  Field addition is associative, so
    the order index_add_ takes (atomics on the card) cannot change it."""
    shape = (num_segments,) + tuple(vals.shape[1:])
    s_lo = torch.zeros(shape, dtype=DTYPE, device=vals.device)
    s_hi = torch.zeros(shape, dtype=DTYPE, device=vals.device)
    s_lo.index_add_(0, seg, vals & MASK32)
    s_hi.index_add_(0, seg, _srl(vals, 32))
    return _combine_halves(s_lo, s_hi)
