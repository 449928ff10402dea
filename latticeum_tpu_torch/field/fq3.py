"""Cubic extension Fq3 = Fq[Y]/(Y^3 - W), W = 2^40, on torch tensors.

Counterpart of ``latticeum_tpu/field/fq3.py``.  An element is a tuple
(c0, c1, c2) of int64 Goldilocks tensors with a common batch shape.
"""

from __future__ import annotations

from . import goldilocks as gl


def add(a, b):
    return tuple(gl.add(x, y) for x, y in zip(a, b))


def sub(a, b):
    return tuple(gl.sub(x, y) for x, y in zip(a, b))


def const(c, device=None):
    """Host Fq3 int triple -> a triple of rank-0 tensors on `device`."""
    return tuple(gl.const(int(x), device) for x in c)


def mul(a, b):
    """Karatsuba product: 6 base multiplies, W-multiplies as shifts."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    m0 = gl.mul(a0, b0)
    m1 = gl.mul(a1, b1)
    m2 = gl.mul(a2, b2)
    m01 = gl.mul(gl.add(a0, a1), gl.add(b0, b1))
    m02 = gl.mul(gl.add(a0, a2), gl.add(b0, b2))
    m12 = gl.mul(gl.add(a1, a2), gl.add(b1, b2))
    t1 = gl.sub(m01, gl.add(m0, m1))             # a0b1 + a1b0
    t3 = gl.sub(m12, gl.add(m1, m2))             # a1b2 + a2b1
    t2 = gl.add(gl.sub(m02, gl.add(m0, m2)), m1)  # a0b2 + a2b0 + a1b1
    return (gl.add(m0, gl.mul_2e40(t3)), gl.add(t1, gl.mul_2e40(m2)), t2)


def square(a):
    """Chung-Hasan SQR3 (5 base multiplies)."""
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
