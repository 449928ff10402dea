"""Cubic extension Fq3 = Fq[Y]/(Y^3 - W), W = 2^40 (the NTT slot field).

Matches arkworks ``Fp3<Goldilocks3Config>`` with NONRESIDUE = 1099511627776
(reference: latticeum/crates/stark-rings/crates/ring/src/cyclotomic_ring/
models/goldilocks/mod.rs:29-54).

An Fq3 element is a tuple of three Goldilocks limb pairs (c0, c1, c2), each a
(lo, hi) uint32 array pair; all ops vectorize over arbitrary batch shapes.
"""

from __future__ import annotations

import numpy as np

from .. import backend as B

from . import goldilocks as gl

NONRESIDUE = 1 << 40  # W


def from_int(c0, c1, c2):
    return (gl.from_int(c0), gl.from_int(c1), gl.from_int(c2))


def to_int(x):
    return tuple(gl.to_int(c) for c in x)


def zeros(shape):
    return (gl.zeros(shape), gl.zeros(shape), gl.zeros(shape))


def ones(shape):
    return (gl.ones(shape), gl.zeros(shape), gl.zeros(shape))


def from_base(c0):
    """Embed Fq -> Fq3 (c1 = c2 = 0)."""
    z = (B.xp.zeros_like(c0[0]), B.xp.zeros_like(c0[1]))
    return (c0, z, z)


def add(a, b):
    return tuple(gl.add(x, y) for x, y in zip(a, b))


def sub(a, b):
    return tuple(gl.sub(x, y) for x, y in zip(a, b))


def neg(a):
    return tuple(gl.neg(x) for x in a)


def scale(a, s):
    """Multiply each coefficient by a base-field element s."""
    return tuple(gl.mul(x, s) for x in a)


def mul(a, b):
    """(a0 + a1 Y + a2 Y^2)(b0 + b1 Y + b2 Y^2) mod (Y^3 - W).

    Karatsuba-3: 6 field products instead of the schoolbook 9, and the
    W = 2^40 nonresidue multiplies are word shifts (gl.mul_2e40) — the Fq3
    product is the inner loop of every ring op on the chip."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    m = gl.mul
    m0 = m(a0, b0)
    m1 = m(a1, b1)
    m2 = m(a2, b2)
    m01 = m(gl.add(a0, a1), gl.add(b0, b1))
    m02 = m(gl.add(a0, a2), gl.add(b0, b2))
    m12 = m(gl.add(a1, a2), gl.add(b1, b2))
    t1 = gl.sub(m01, gl.add(m0, m1))            # a0b1 + a1b0
    t3 = gl.sub(m12, gl.add(m1, m2))            # a1b2 + a2b1
    t2 = gl.add(gl.sub(m02, gl.add(m0, m2)), m1)  # a0b2+a2b0+a1b1
    c0 = gl.add(m0, gl.mul_2e40(t3))
    c1 = gl.add(t1, gl.mul_2e40(m2))
    return (c0, c1, t2)


def square(a):
    """Chung-Hasan SQR3: 5 base-field multiplies (vs 6 for mul(a, a)).

    s0=a0^2, s1=2a0a1, s2=(a0-a1+a2)^2, s3=2a1a2, s4=a2^2;
    c0 = s0 + W*s3, c1 = s1 + W*s4, c2 = s1+s2+s3-s0-s4 (= a1^2+2a0a2)."""
    a0, a1, a2 = a
    s0 = gl.mul(a0, a0)
    a0a1 = gl.mul(a0, a1)
    s1 = gl.add(a0a1, a0a1)
    t = gl.add(gl.sub(a0, a1), a2)
    s2 = gl.mul(t, t)
    a1a2 = gl.mul(a1, a2)
    s3 = gl.add(a1a2, a1a2)
    s4 = gl.mul(a2, a2)
    c0 = gl.add(s0, gl.mul_2e40(s3))
    c1 = gl.add(s1, gl.mul_2e40(s4))
    c2 = gl.sub(gl.add(gl.add(s1, s2), s3), gl.add(s0, s4))
    return (c0, c1, c2)


def pow_const(a, e: int):
    shape = a[0][0].shape
    result = ones(shape)
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
    """Inverse via the norm map: a^{-1} = a^{q+q^2} / N(a), N(a) in Fq.

    Simpler: Fermat in the extension, a^(q^3 - 2).  q^3 is huge; instead use
    the standard formula with the adjugate.  For X^3 - W:
      N(a) = a0^3 + W a1^3 + W^2 a2^3 - 3 W a0 a1 a2
      adj0 = a0^2 - W a1 a2
      adj1 = W a2^2 - a0 a1
      adj2 = a1^2 - a0 a2
      a^{-1} = (adj0 + adj1 Y + adj2 Y^2) / N(a)
    """
    a0, a1, a2 = a
    m = gl.mul
    w = gl.const(NONRESIDUE)
    wlo = B.xp.broadcast_to(w[0], a0[0].shape)
    whi = B.xp.broadcast_to(w[1], a0[1].shape)
    W = (wlo, whi)
    a0a1 = m(a0, a1)
    a1a2 = m(a1, a2)
    a0a2 = m(a0, a2)
    adj0 = gl.sub(m(a0, a0), m(W, a1a2))
    adj1 = gl.sub(m(W, m(a2, a2)), a0a1)
    adj2 = gl.sub(m(a1, a1), a0a2)
    # N(a) = a0*adj0 + W*(a2*adj1 + a1*adj2)
    norm = gl.add(m(a0, adj0), m(W, gl.add(m(a2, adj1), m(a1, adj2))))
    ninv = gl.inv(norm)
    return (m(adj0, ninv), m(adj1, ninv), m(adj2, ninv))


def eq(a, b):
    return gl.eq(a[0], b[0]) & gl.eq(a[1], b[1]) & gl.eq(a[2], b[2])
