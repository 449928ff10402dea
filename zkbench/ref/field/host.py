"""Host-side (Python int) field/ring arithmetic for protocol glue.

Small quantities (sum-check round messages, challenges, folded scalars) are
manipulated on host between device kernels; this module gives exact Goldilocks
/ Fq3 / RqNTT arithmetic on plain ints.

Conventions:
  * Fq element: int in [0, p)
  * Fq3 element: tuple (c0, c1, c2)
  * RqNTT element: list of 24 ints, slot s at [3s, 3s+3) (an Fq3 each)
  * RqPoly element: list of 24 coefficient ints
"""

from __future__ import annotations

from ..ring import ref_impl as R

P = R.P
W = R.NONRESIDUE  # 2^40
D = R.D


def fq3_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def fq3_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def fq3_neg(a):
    return tuple((-x) % P for x in a)


def fq3_mul(a, b):
    t = [0] * 5
    for i in range(3):
        for j in range(3):
            t[i + j] = (t[i + j] + a[i] * b[j]) % P
    return ((t[0] + W * t[3]) % P, (t[1] + W * t[4]) % P, t[2])


def fq3_scalar(c: int):
    return (c % P, 0, 0)


def fq3_pow(a, e: int):
    r = (1, 0, 0)
    while e:
        if e & 1:
            r = fq3_mul(r, a)
        a = fq3_mul(a, a)
        e >>= 1
    return r


def fq3_inv(a):
    a0, a1, a2 = a
    adj0 = (a0 * a0 - W * a1 * a2) % P
    adj1 = (W * a2 * a2 - a0 * a1) % P
    adj2 = (a1 * a1 - a0 * a2) % P
    norm = (a0 * adj0 + W * (a2 * adj1 + a1 * adj2)) % P
    ninv = pow(norm, P - 2, P)
    return (adj0 * ninv % P, adj1 * ninv % P, adj2 * ninv % P)


# --- RqNTT ---------------------------------------------------------------

def ntt_zero():
    return [0] * D


def ntt_from_u64(c: int):
    """Ring from a base-field scalar: all 8 slots = (c, 0, 0)
    (ntt_form.rs:356-369,689-692)."""
    out = [0] * D
    for s in range(8):
        out[3 * s] = c % P
    return out


def ntt_from_fq3(x):
    """from_scalar: all slots equal to the Fq3 value (ntt_form.rs:689-692)."""
    out = [0] * D
    for s in range(8):
        out[3 * s], out[3 * s + 1], out[3 * s + 2] = x
    return out


def ntt_add(a, b):
    return [(x + y) % P for x, y in zip(a, b)]


def ntt_sub(a, b):
    return [(x - y) % P for x, y in zip(a, b)]


def ntt_neg(a):
    return [(-x) % P for x in a]


def ntt_mul(a, b):
    return R.ntt_mul(a, b)


def ntt_scalar_mul(a, x):
    """Ring element times Fq3 scalar (slot-wise)."""
    out = [0] * D
    for s in range(8):
        r = fq3_mul((a[3 * s], a[3 * s + 1], a[3 * s + 2]), x)
        out[3 * s], out[3 * s + 1], out[3 * s + 2] = r
    return out


def ntt_sum(elems):
    out = [0] * D
    for e in elems:
        for i in range(D):
            out[i] = (out[i] + e[i]) % P
    return out


def ntt_slots(a):
    """-> list of 8 Fq3 tuples."""
    return [(a[3 * s], a[3 * s + 1], a[3 * s + 2]) for s in range(8)]


def crt(coeffs):
    return R.crt(list(coeffs))


def icrt(ntt):
    return R.icrt(list(ntt))
