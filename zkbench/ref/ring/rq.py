"""TPU-side ops for R_q = F_q[X]/(X^24 - X^12 + 1) and its NTT (CRT) form.

Layouts (all batched, limbs = (lo, hi) uint32 pairs):
  * coeff form:  (..., 24) F_q coefficients
  * NTT form:    (..., 24) F_q, slot s occupies columns [3s, 3s+2] and is an
    element of Fq3 = F_q[Y]/(Y^3 - 2^40); matches the in-place layout of the
    reference (goldilocks/ntt.rs:74-87).

The CRT/ICRT butterfly network of the reference (ntt.rs:135-319) is F_q-linear,
so the TPU path applies it as a dense 24x24 matvec mod p — mathematically
identical output, and a single fused batched contraction instead of a chain of
column shuffles.  The matrices are derived at import by running the bit-exact
host implementation (ref_impl.crt/icrt) on basis vectors.
"""

from __future__ import annotations

import numpy as np
from .. import backend as B

from ..field import fq3, goldilocks as gl
from . import ref_impl

D = ref_impl.D
N_SLOTS = ref_impl.N

_CRT_M = ref_impl.crt_matrix()
_ICRT_M = ref_impl.icrt_matrix()


def _matrix_limbs(m):
    return gl.from_int(np.array(m, dtype=object))


CRT_MAT = _matrix_limbs(_CRT_M)     # (24, 24) limbs
ICRT_MAT = _matrix_limbs(_ICRT_M)


def matvec24(mat, x):
    """(24,24) constant matrix @ x[..., 24] mod p."""
    # (..., 1, 24) * (24, 24) -> sum over last axis -> (..., 24)
    xl = (x[0][..., None, :], x[1][..., None, :])
    prod = gl.mul(xl, mat)
    return B.barrier(gl.sum_axis(prod, axis=-1))


def _cols(x):
    return [(x[0][..., i], x[1][..., i]) for i in range(D)]


def _from_cols(cols):
    return (B.xp.stack([c[0] for c in cols], axis=-1),
            B.xp.stack([c[1] for c in cols], axis=-1))


def _cmul(c, const):
    return gl.mul(c, (B.xp.broadcast_to(B.xp.asarray(np.uint32(const & 0xFFFFFFFF)), c[0].shape),
                      B.xp.broadcast_to(B.xp.asarray(np.uint32(const >> 32)), c[1].shape)))


def crt(x):
    """coeff form -> NTT form, batched butterfly network (ntt.rs:135-228).

    Vectorized over the batch; ~60 column ops instead of a dense 24x24
    contraction (the dense path remains as matvec24(CRT_MAT, .))."""
    R = ref_impl.ROOTS
    c = _cols(x)
    for i in range(12):
        a, b = c[i], c[12 + i]
        zb = _cmul(b, R[4])
        c[i] = gl.add(a, zb)
        c[12 + i] = gl.sub(gl.add(a, b), zb)
    for i in range(6):
        a, b = c[i], c[6 + i]
        sb = _cmul(b, R[2])
        c[i], c[6 + i] = gl.add(a, sb), gl.sub(a, sb)
        a, b = c[12 + i], c[18 + i]
        sb = _cmul(b, R[10])
        c[12 + i], c[18 + i] = gl.add(a, sb), gl.sub(a, sb)
    for base, r in ((0, 1), (6, 7), (12, 5), (18, 11)):
        for i in range(3):
            a, b = c[base + i], c[base + 3 + i]
            sb = _cmul(b, R[r])
            c[base + i], c[base + 3 + i] = gl.add(a, sb), gl.sub(a, sb)
    # homogenize (ntt.rs:326-437)
    c[4] = gl.neg(c[4])
    c[7] = _cmul(c[7], R[2])
    c[8] = _cmul(c[8], R[4])
    c[10] = _cmul(c[10], R[6])
    c[11] = _cmul(c[11], R[12])
    for base, r1, r2 in ((12, 3, 1), (15, 11, 5), (18, 7, 3), (21, 15, 7)):
        c1 = c[base + 1]
        c[base + 1] = _cmul(c[base + 2], R[r1])
        c[base + 2] = _cmul(c1, R[r2])
    return _from_cols(c)


def icrt(x):
    """NTT form -> coeff form, batched butterfly network (ntt.rs:240-319)."""
    R = ref_impl.ROOTS
    c = _cols(x)
    # dehomogenize
    c[4] = gl.neg(c[4])
    c[7] = _cmul(c[7], R[22])
    c[8] = _cmul(c[8], R[20])
    c[10] = _cmul(c[10], R[18])
    c[11] = _cmul(c[11], R[12])
    for base, r1, r2 in ((12, 23, 21), (15, 19, 13), (18, 21, 17),
                         (21, 17, 9)):
        c1 = c[base + 1]
        c[base + 1] = _cmul(c[base + 2], R[r1])
        c[base + 2] = _cmul(c1, R[r2])
    for base, r in ((0, 23), (6, 17), (12, 19), (18, 13)):
        for i in range(3):
            a, b = c[base + i], c[base + 3 + i]
            c[base + i] = gl.add(a, b)
            c[base + 3 + i] = _cmul(gl.sub(a, b), R[r])
    for base, r in ((0, 22), (12, 14)):
        for i in range(6):
            a, b = c[base + i], c[base + 6 + i]
            c[base + i] = gl.add(a, b)
            c[base + 6 + i] = _cmul(gl.sub(a, b), R[r])
    for i in range(12):
        a, b = c[i], c[12 + i]
        kd = _cmul(gl.sub(a, b), ref_impl.KAPPA)
        c[i] = _cmul(gl.sub(gl.add(a, b), kd), ref_impl.EIGHT_INV)
        c[12 + i] = _cmul(kd, ref_impl.FOUR_INV)
    return _from_cols(c)


def _as_slots(x):
    """(..., 24) -> Fq3 triple of (..., 8) arrays."""
    lo = x[0].reshape(x[0].shape[:-1] + (N_SLOTS, 3))
    hi = x[1].reshape(x[1].shape[:-1] + (N_SLOTS, 3))
    return tuple((lo[..., i], hi[..., i]) for i in range(3))


def _from_slots(c):
    lo = B.xp.stack([ci[0] for ci in c], axis=-1).reshape(
        c[0][0].shape[:-1] + (D,))
    hi = B.xp.stack([ci[1] for ci in c], axis=-1).reshape(
        c[0][1].shape[:-1] + (D,))
    return (lo, hi)


def ntt_mul(a, b):
    """Slot-wise product of NTT-form elements (8 independent Fq3 muls)."""
    return B.barrier(_from_slots(fq3.mul(_as_slots(a), _as_slots(b))))


def ntt_scalar_mul(a, s3):
    """NTT element * Fq3 scalar (broadcast over slots and batch).

    s3: fq3 element with batch shape broadcastable to a's batch shape.
    """
    sa = _as_slots(a)
    sb = tuple(((c[0][..., None]), (c[1][..., None])) for c in s3)
    return B.barrier(_from_slots(fq3.mul(sa, sb)))


def add(a, b):
    return gl.add(a, b)


def sub(a, b):
    return gl.sub(a, b)


def neg(a):
    return gl.neg(a)


def reduce_coeffs(c):
    """Reduce (..., L>=24) coefficients mod X^24 - X^12 + 1.

    new[i]    = c[i] - c[24+i] - c[36+i]   (i < 12)
    new[12+i] = c[12+i] + c[24+i]          (i < 12)
    (goldilocks/mod.rs:75-98)
    """
    lo, hi = c
    L = lo.shape[-1]

    def col(i):
        if i < L:
            return (lo[..., i], hi[..., i])
        z = B.xp.zeros_like(lo[..., 0])
        return (z, z)

    outs = []
    for i in range(12):
        outs.append(gl.sub(gl.sub(col(i), col(24 + i)), col(36 + i)))
    for i in range(12):
        outs.append(gl.add(col(12 + i), col(24 + i)))
    return (
        B.xp.stack([o[0] for o in outs], axis=-1),
        B.xp.stack([o[1] for o in outs], axis=-1),
    )


def poly_mul(a, b):
    """Coefficient-form ring product via CRT -> slotwise mul -> ICRT (exact)."""
    return icrt(ntt_mul(crt(a), crt(b)))


def rot(c):
    """Multiply by X in coeff form (goldilocks/mod.rs:138-149).

    out[0] = -c[23]; out[i] = c[i-1] (i>=1); out[12] += c[23].
    """
    lo, hi = c
    last = (lo[..., 23], hi[..., 23])
    nl = gl.neg(last)
    outs = [nl] + [(lo[..., i], hi[..., i]) for i in range(D - 1)]
    outs[12] = gl.add(outs[12], last)
    return (
        B.xp.stack([o[0] for o in outs], axis=-1),
        B.xp.stack([o[1] for o in outs], axis=-1),
    )


def from_int_coeffs(values):
    """Host list/array (..., 24) of ints -> coeff-form limbs."""
    return gl.from_int(values)


def to_int(x):
    return gl.to_int(x)


def zeros(batch_shape=()):
    return gl.zeros(tuple(batch_shape) + (D,))


def ones(batch_shape=()):
    """Ring ONE in coeff form."""
    lo = np.zeros(tuple(batch_shape) + (D,), dtype=np.uint32)
    lo[..., 0] = 1
    return (B.xp.asarray(lo), B.xp.zeros(tuple(batch_shape) + (D,), np.uint32))


# -- transposed layout (..., 24, n): ring coords on axis -2 -----------------
# TPU tiling pads the minor (lane) axis to 128; keeping the large hypercube
# axis minor avoids a 5.3x memory blowup from the 24-wide ring axis.

def _as_slots_t(x):
    """(..., 24, n) -> Fq3 triple of (..., 8, n) arrays."""
    lo = x[0].reshape(x[0].shape[:-2] + (N_SLOTS, 3) + x[0].shape[-1:])
    hi = x[1].reshape(x[1].shape[:-2] + (N_SLOTS, 3) + x[1].shape[-1:])
    return tuple((lo[..., i, :], hi[..., i, :]) for i in range(3))


def _from_slots_t(c):
    lo = B.xp.stack([ci[0] for ci in c], axis=-2).reshape(
        c[0][0].shape[:-2] + (D,) + c[0][0].shape[-1:])
    hi = B.xp.stack([ci[1] for ci in c], axis=-2).reshape(
        c[0][1].shape[:-2] + (D,) + c[0][1].shape[-1:])
    return (lo, hi)


def ntt_mul_t(a, b):
    """Slot-wise product in (..., 24, n) layout."""
    return B.barrier(_from_slots_t(fq3.mul(_as_slots_t(a), _as_slots_t(b))))


def ntt_scalar_mul_t(a, s3):
    """(..., 24, n) times Fq3 scalar (components broadcastable scalars)."""
    sa = _as_slots_t(a)
    sb = tuple(((c[0][..., None, None]), (c[1][..., None, None]))
               for c in s3)
    return B.barrier(_from_slots_t(fq3.mul(sa, sb)))
