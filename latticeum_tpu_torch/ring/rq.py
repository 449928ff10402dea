"""R_q = F_q[X]/(X^24 - X^12 + 1) and its CRT (NTT) form on torch tensors.

Counterpart of ``latticeum_tpu/ring/rq.py``.  A ring element is 24 field
values on one axis: coefficient form, or NTT form where slot s holds the
Fq3 element at positions [3s, 3s+3) (slot-major).  Standard layout keeps the
ring axis last, (..., 24); the t-layout keeps it second to last, (..., 24, n),
with the hypercube on the minor axis.

crt/icrt are the exact 24x24 F_q-linear maps of the reference butterfly
network (``ring/ref_impl.py``).  On a card each is one launch of the
butterfly network in ``csrc/ring.cu`` (counted in ``crt.launches`` and
``icrt.launches``; counterparts of ``latticeum_tpu/ring/rq.py:61`` ``crt``
and ``:98`` ``icrt``); on the CPU the plain-torch twins ``crt_twin`` and
``icrt_twin`` apply the maps as a dense matvec of field multiply-adds.
Any other device raises.  There is no fallback.

``ring_mac`` and ``ring_mul_each`` are the ring multiply-accumulate of
``csrc/ringmac.cu`` (counterpart of the XLA functions
``latticeum_tpu/zkvm/accel_nifs.py:796`` ``f0_fn`` and the row-constant
commits and y0 of ``:499`` ``batch_fn``): slot-wise products of NTT-form
rings, summed over the terms or not, one launch each (counted in
``ring_mac.launches`` and ``ring_mul_each.launches``), with the twins
``ring_mac_twin`` and ``ring_mul_each_twin`` (``ntt_mul`` and ``gl.add``)
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fq3, goldilocks as gl
from ..host.ring import ref_impl
from ..kernels import launch as _launch, ptr as _ptr, route as _route, \
    stream as _stream

D = ref_impl.D
N_SLOTS = ref_impl.N

_CRT_U64 = np.array(ref_impl.crt_matrix(), dtype=np.uint64)
_ICRT_U64 = np.array(ref_impl.icrt_matrix(), dtype=np.uint64)
_ROWS_PER_CHUNK = 1 << 15
# The kernel's constants, in csrc/ring.cu's order: the 24 roots, then KAPPA,
# EIGHT_INV and FOUR_INV.
_KERNEL_CONSTS = torch.from_numpy(gl.to_i64_bits(np.array(
    ref_impl.ROOTS + [ref_impl.KAPPA, ref_impl.EIGHT_INV, ref_impl.FOUR_INV],
    dtype=np.uint64)))
_consts_on = {}


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


def crt_twin(x):
    """Plain-torch CRT: the dense 24 x 24 matvec."""
    return _matvec24(_CRT_U64, x)


def icrt_twin(x):
    """Plain-torch ICRT: the dense 24 x 24 matvec."""
    return _matvec24(_ICRT_U64, x)


def _kernel_consts(device):
    """The kernel's constants on `device`, uploaded once per device."""
    if device not in _consts_on:
        _consts_on[device] = gl.upload(_KERNEL_CONSTS, device)
    return _consts_on[device]


def _ring_map(wrapper, twin, inverse, x):
    if x.dtype != gl.DTYPE:
        raise TypeError(f"{wrapper.__name__}: dtype {x.dtype}, expected "
                        "int64")
    if x.dim() == 0 or x.shape[-1] != D:
        raise ValueError(f"{wrapper.__name__}: shape {tuple(x.shape)}, "
                         f"expected (..., {D})")
    if _route((x,)) == "cpu":
        return twin(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel() // D
    if n:
        _launch("lt_crt", _ptr(x), _ptr(out), n, int(inverse),
                _ptr(_kernel_consts(x.device)), _stream())
        wrapper.launches += 1
    return out


def crt(x):
    """Coefficient form -> NTT form, (..., 24)."""
    return _ring_map(crt, crt_twin, False, x)


def icrt(x):
    """NTT form -> coefficient form, (..., 24)."""
    return _ring_map(icrt, icrt_twin, True, x)


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


def ring_mac_twin(parts, c, base=None):
    """Plain torch of ring_mac: one ntt_mul and one add a term."""
    acc = None
    i = 0
    for part in parts:
        for x in part:
            term = ntt_mul(x, c[i][None])
            acc = term if acc is None else gl.add(acc, term)
            i += 1
    if acc is None:
        acc = torch.zeros(parts[0].shape[1:], dtype=gl.DTYPE,
                          device=c.device)
    return acc if base is None else gl.sub(base, acc)


def ring_mul_each_twin(x, c):
    """Plain torch of ring_mul_each."""
    return ntt_mul(x[None], c[:, None, :])


def _terms(name, t, rows=None):
    if t.dtype != gl.DTYPE:
        raise TypeError(f"{name}: dtype {t.dtype}, expected int64")
    if t.dim() != 3 or t.shape[-1] != D or (rows is not None and
                                            t.shape[1] != rows):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected (n, "
                         f"{'rows' if rows is None else rows}, {D})")


def _ring_consts(c, n):
    if c.dtype != gl.DTYPE:
        raise TypeError(f"c: dtype {c.dtype}, expected int64")
    if tuple(c.shape) != (n, D):
        raise ValueError(f"c: shape {tuple(c.shape)}, expected ({n}, {D})")


def ring_mac(parts, c, base=None):
    """out (rows, 24) = sum_i c[i] * x_i, or base - that sum: slot-wise
    Fq3 products of NTT-form rings.  The terms x_i (rows, 24) are the rows
    of one or two parts (n_p, rows, 24) in order, read where they lie;
    c (n, 24) holds one ring a term, n = sum n_p; base (rows, 24) or None.
    One launch (sums unreduced, one reduction an output)."""
    parts = tuple(parts)
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"ring_mac takes one or two parts, not "
                         f"{len(parts)}")
    for k, x in enumerate(parts):
        _terms(f"parts[{k}]", x, parts[0].shape[1] if k else None)
    rows = parts[0].shape[1]
    n = sum(x.shape[0] for x in parts)
    _ring_consts(c, n)
    if base is not None:
        if base.dtype != gl.DTYPE or tuple(base.shape) != (rows, D):
            raise ValueError(f"base: {base.dtype} {tuple(base.shape)}, "
                             f"expected int64 ({rows}, {D})")
    if _route(parts + (c,) + (() if base is None else (base,))) == "cpu":
        return ring_mac_twin(parts, c, base)
    parts = tuple(x.contiguous() for x in parts)
    c = c.contiguous()
    base = None if base is None else base.contiguous()
    out = torch.empty((rows, D), dtype=gl.DTYPE, device=c.device)
    if rows:
        _launch("lt_ring_mac", _ptr(parts[0]),
                _ptr(parts[1]) if len(parts) == 2 else None,
                parts[0].shape[0], rows * D, _ptr(c), n,
                None if base is None else _ptr(base), _ptr(out), rows, 1,
                _stream())
        ring_mac.launches += 1
    return out


def ring_mul_each(x, c):
    """out (n, rows, 24), out[i] = c[i] * x: the slot-wise products of the
    rings x (rows, 24) with each ring of c (n, 24), one launch of
    ring_mac's kernel without the sum."""
    if x.dtype != gl.DTYPE or x.dim() != 2 or x.shape[-1] != D:
        raise ValueError(f"x: {x.dtype} {tuple(x.shape)}, expected int64 "
                         f"(rows, {D})")
    _ring_consts(c, c.shape[0] if c.dim() else -1)
    if _route((x, c)) == "cpu":
        return ring_mul_each_twin(x, c)
    x, c = x.contiguous(), c.contiguous()
    out = torch.empty((c.shape[0],) + tuple(x.shape), dtype=gl.DTYPE,
                      device=x.device)
    if out.numel():
        _launch("lt_ring_mac", _ptr(x), None, c.shape[0], 0, _ptr(c),
                c.shape[0], None, _ptr(out), x.shape[0], 0, _stream())
        ring_mul_each.launches += 1
    return out


KERNELS = (crt, icrt, ring_mac, ring_mul_each)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


reset_launches()
