"""R_q = F_q[X]/(X^24 - X^12 + 1) and its CRT (NTT) form on torch tensors.

Counterpart of ``latticeum_tpu/ring/rq.py``.  A ring element is 24 field
values on one axis: coefficient form, or NTT form where slot s holds the
Fq3 element at positions [3s, 3s+3) (slot-major).  Standard layout keeps the
ring axis last, (..., 24); the t-layout keeps it second to last, (..., 24, n),
with the hypercube on the minor axis.

crt/icrt are the exact 24x24 F_q-linear maps of the reference butterfly
network (``ring/ref_impl.py``), applied as field multiply-adds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fq3, goldilocks as gl
from ..host.ring import ref_impl

D = ref_impl.D
N_SLOTS = ref_impl.N

_CRT_U64 = np.array(ref_impl.crt_matrix(), dtype=np.uint64)
_ICRT_U64 = np.array(ref_impl.icrt_matrix(), dtype=np.uint64)
_ROWS_PER_CHUNK = 1 << 15


def _matvec24(mat_u64, x):
    """out[..., i] = sum_j mat[i, j] x[..., j] mod p, chunked over rows so
    the (rows, 24, 24) product stays a few hundred MB."""
    mat = torch.from_numpy(gl.to_i64_bits(mat_u64)).to(x.device)
    flat = x.reshape(-1, D)
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], _ROWS_PER_CHUNK):
        blk = flat[s:s + _ROWS_PER_CHUNK]
        out[s:s + _ROWS_PER_CHUNK] = gl.sum_axis(
            gl.mul(blk[:, None, :], mat[None]), -1)
    return out.reshape(x.shape)


def crt(x):
    """Coefficient form -> NTT form, (..., 24)."""
    return _matvec24(_CRT_U64, x)


def icrt(x):
    """NTT form -> coefficient form, (..., 24)."""
    return _matvec24(_ICRT_U64, x)


def _as_slots(x):
    """(..., 24) -> Fq3 triple of (..., 8) tensors."""
    v = x.reshape(x.shape[:-1] + (N_SLOTS, 3))
    return (v[..., 0], v[..., 1], v[..., 2])


def _from_slots(c):
    s = torch.stack(c, dim=-1)
    return s.reshape(s.shape[:-2] + (D,))


def ntt_mul(a, b):
    """Slot-wise product of NTT-form elements, (..., 24)."""
    return _from_slots(fq3.mul(_as_slots(a), _as_slots(b)))


def ntt_scalar_mul(a, s3):
    """(..., 24) times an Fq3 scalar whose components broadcast against
    a's batch shape."""
    return _from_slots(fq3.mul(_as_slots(a), tuple(c[..., None] for c in s3)))


def _as_slots_t(x):
    """(..., 24, n) -> Fq3 triple of (..., 8, n) tensors."""
    v = x.reshape(x.shape[:-2] + (N_SLOTS, 3) + x.shape[-1:])
    return (v[..., 0, :], v[..., 1, :], v[..., 2, :])


def _from_slots_t(c):
    s = torch.stack(c, dim=-2)
    return s.reshape(s.shape[:-3] + (D,) + s.shape[-1:])


def ntt_mul_t(a, b):
    """Slot-wise product in the (..., 24, n) layout."""
    return _from_slots_t(fq3.mul(_as_slots_t(a), _as_slots_t(b)))


def ntt_scalar_mul_t(a, s3):
    """(..., 24, n) times an Fq3 scalar whose components broadcast against
    a's batch shape (without the 24 and n axes)."""
    return _from_slots_t(fq3.mul(_as_slots_t(a),
                                 tuple(c[..., None, None] for c in s3)))


def poly_mul(a, b):
    """Coefficient-form ring product, (..., 24): CRT, slot-wise product,
    ICRT (exact)."""
    return icrt(ntt_mul(crt(a), crt(b)))


def rot(c):
    """Multiplication by X in coefficient form, (..., 24): X^24 = X^12 - 1,
    so out[0] = -c[23], out[i] = c[i-1] for i >= 1, and out[12] += c[23]."""
    last = c[..., D - 1:]
    out = torch.cat([gl.neg(last), c[..., :D - 1]], dim=-1)
    out[..., 12:13] = gl.add(out[..., 12:13], last)
    return out
