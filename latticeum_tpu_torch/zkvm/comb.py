"""The four sum-check comb kernels: wrappers, plain-torch twins, launch counts.

Counterparts of the Pallas kernels in ``latticeum_tpu/zkvm/pallas_comb.py``
(``fold_round0_pallas``, ``fold_roundr_pallas``, ``lin_round0_pallas``,
``lin_roundr_pallas``); the CUDA bodies are in ``csrc/comb.cu``.

All arrays are t-layout int64 Goldilocks tensors, (rows, 24, width) with
slot-major ring positions 3*s + c and the (bit-reversed) hypercube on the
minor axis, so a sum-check round pairs column x with column x + half.

* ``fold_round0(X, Tb, mu, b_small)``: X (rows, 24, 2q).  Returns the round
  sums S (2*b_small, 24): S[t] = sum_x Tb(x) * sum_rows mu_row * f_t *
  prod_{b<b_small} (f_t^2 - b^2), f_t = v0 + t (v1 - v0), v0 = X[.., x],
  v1 = X[.., q + x].  Points t = 0, 1 are skipped (zero): h vanishes there
  on honest digit witnesses, exactly as the reference skips them.
* ``fold_roundr(X, Tb, mu, r3, b_small)``: X (rows, 24, 4q) is folded at
  the challenge r (F = X[.., :2q] + r (X[.., 2q:] - X[.., :2q])) into a
  fresh F (rows, 24, 2q); returns (S over all points of F, F).
* ``lin_round0(X, Tc, sets, npts)``: S[t] = sum_x Tc(x) * sum_i sign_i
  prod_{j in S_i} f_t[j], t < npts, over X (rows, 24, 2q).
* ``lin_roundr(X, Tc, r3, sets, npts)``: fold at r as above, then the lin
  sums over F; returns (S, F).

A wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel (and counts the launch) or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..field import fq3, goldilocks as gl
from ..ring import rq

BLOCK = 128          # threads per block of every comb kernel (csrc/comb.cu)
MAX_B_SMALL = 4      # fold kernels are instantiated for npts = 2 .. 8
MAX_LIN_PTS = 12     # lin kernels are instantiated for npts = 1 .. 12
_TWIN_COLS = 8192    # column chunk of the twins (bounds their temporaries)


@dataclass
class LinSets:
    """The lin comb's static multisets S_i and +-1 signs c_i, on the host
    for the twin and as int32 device arrays (CSR offsets) for the kernel."""
    S: tuple
    signs: tuple
    rows: int
    off: torch.Tensor
    idx: torch.Tensor
    sgn: torch.Tensor


def lin_sets(S, signs, rows, device):
    S = tuple(tuple(int(j) for j in s) for s in S)
    signs = tuple(int(s) for s in signs)
    if len(S) != len(signs) or any(s not in (1, -1) for s in signs):
        raise ValueError("lin comb needs one +-1 sign per multiset")
    if any(len(s) == 0 for s in S):
        raise ValueError("lin comb multisets must be non-empty")
    if sorted({j for s in S for j in s}) != list(range(rows)):
        # every Mz row must be folded by the round-r kernel
        raise ValueError(f"multisets must cover all {rows} Mz rows")
    off = [0]
    for s in S:
        off.append(off[-1] + len(s))
    flat = [j for s in S for j in s]

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)
    return LinSets(S, signs, rows, i32(off), i32(flat), i32(list(signs)))


# -- shared pieces of the twins ----------------------------------------------

def fold_t(X, r3):
    """(..., 24, 2w) -> (..., 24, w): v0 + r (v1 - v0) on contiguous halves."""
    w = X.shape[-1] // 2
    v0, v1 = X[..., :w], X[..., w:]
    return gl.add(v0, rq.ntt_scalar_mul_t(gl.sub(v1, v0),
                                          fq3.const(r3, X.device)))


def _slot_major(s3):
    """Fq3 triple of (8,) sums -> (24,) slot-major ring."""
    return torch.stack(s3, dim=-1).reshape(24)


def _fold_sums_twin(X, Tb, mu, b_small, pt0):
    rows, _, w = X.shape
    q = w // 2
    npts = 2 * b_small
    S = torch.zeros((npts, 24), dtype=gl.DTYPE, device=X.device)
    mu3 = tuple(mu[:, c][:, None, None] for c in range(3))   # (rows, 1, 1)
    for c0 in range(0, q, _TWIN_COLS):
        c1 = min(q, c0 + _TWIN_COLS)
        v0 = rq._as_slots_t(X[..., c0:c1])
        v1 = rq._as_slots_t(X[..., q + c0:q + c1])
        tb = rq._as_slots_t(Tb[..., c0:c1])
        step = fq3.sub(v1, v0)
        f, mf, mstep = v0, fq3.mul(mu3, v0), fq3.mul(mu3, step)
        for t in range(npts):
            if t >= pt0:
                fsq = fq3.square(f)
                ev = mf
                for b in range(1, b_small):
                    bb = torch.full_like(fsq[0], b * b)
                    ev = fq3.mul(ev, (gl.sub(fsq[0], bb), fsq[1], fsq[2]))
                evs = fq3.mul(tuple(gl.sum_axis(e, 0) for e in ev), tb)
                S[t] = gl.add(S[t], _slot_major(
                    tuple(gl.sum_axis(e, -1) for e in evs)))
            f, mf = fq3.add(f, step), fq3.add(mf, mstep)
    return S


def lin_groups(sets, device):
    """The multisets grouped by size, one batched product chain per size:
    [(sign > 0 mask (g,), row ids (g, size))] as tensors on `device`."""
    groups = {}
    for i, s in enumerate(sets.S):
        groups.setdefault(len(s), []).append(i)
    return [(torch.tensor([sets.signs[i] > 0 for i in ids], device=device),
             torch.tensor([sets.S[i] for i in ids], device=device))
            for _, ids in sorted(groups.items())]


def signed_multiset_sum(f, groups):
    """sum_i sign_i prod_{j in S_i} f[j] for an Fq3 triple f of (rows, ...)
    tensors -> an Fq3 triple of (...) tensors."""
    total = None
    for pos, jidx in groups:
        prod = tuple(c[jidx[:, 0]] for c in f)               # (g, ...)
        for k in range(1, jidx.shape[1]):
            prod = fq3.mul(prod, tuple(c[jidx[:, k]] for c in f))
        mask = pos.reshape((-1,) + (1,) * (prod[0].dim() - 1))
        part = tuple(gl.sum_axis(torch.where(mask, p, gl.neg(p)), 0)
                     for p in prod)
        total = part if total is None else fq3.add(total, part)
    return total


def _lin_sums_twin(X, Tc, sets, npts):
    rows, _, w = X.shape
    q = w // 2
    S = torch.zeros((npts, 24), dtype=gl.DTYPE, device=X.device)
    groups = lin_groups(sets, X.device)
    for c0 in range(0, q, _TWIN_COLS):
        c1 = min(q, c0 + _TWIN_COLS)
        f = rq._as_slots_t(X[..., c0:c1])                    # (rows, 8, c)
        step = fq3.sub(rq._as_slots_t(X[..., q + c0:q + c1]), f)
        tc = rq._as_slots_t(Tc[..., c0:c1])
        for t in range(npts):
            qv = fq3.mul(signed_multiset_sum(f, groups), tc)
            S[t] = gl.add(S[t], _slot_major(
                tuple(gl.sum_axis(e, -1) for e in qv)))
            f = fq3.add(f, step)
    return S


def fold_round0_twin(X, Tb, mu, b_small):
    return _fold_sums_twin(X, Tb, mu, b_small, pt0=2)


def fold_roundr_twin(X, Tb, mu, r3, b_small):
    F = fold_t(X, r3)
    return _fold_sums_twin(F, Tb, mu, b_small, pt0=0), F


def lin_round0_twin(X, Tc, sets, npts):
    return _lin_sums_twin(X, Tc, sets, npts)


def lin_roundr_twin(X, Tc, r3, sets, npts):
    F = fold_t(X, r3)
    return _lin_sums_twin(F, Tc, sets, npts), F


# -- wrappers ------------------------------------------------------------------

def _check(name, t, shape):
    if t.dtype != gl.DTYPE:
        raise TypeError(f"{name}: dtype {t.dtype}, expected int64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(tensors):
    """'cpu' (twin) or 'cuda' (kernel); all arguments on one device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"arguments on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch(fn_name, *args):
    from .. import kernels
    err = getattr(kernels.lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {err} "
                           f"({kernels.error_string(err)})")


def _fold_check(X, Tb, mu, b_small, width_mult):
    rows, _, width = X.shape
    if width % width_mult or width < width_mult:
        raise ValueError(f"fold width {width} not a multiple of {width_mult}")
    q = width // width_mult
    _check("X", X, (rows, 24, width))
    _check("Tb", Tb, (24, q))
    _check("mu", mu, (rows, 3))
    if not 1 <= b_small <= MAX_B_SMALL:
        raise ValueError(f"b_small {b_small} outside 1..{MAX_B_SMALL}")
    return rows, q


def _r3_args(r3):
    return [ctypes.c_uint64(int(c) % gl.P) for c in r3]


def fold_round0(X, Tb, mu, b_small):
    """Fold sum-check round 0 (replaces pallas_comb.fold_round0_pallas)."""
    rows, q = _fold_check(X, Tb, mu, b_small, 2)
    if _route((X, Tb, mu)) == "cpu":
        return fold_round0_twin(X, Tb, mu, b_small)
    npts = 2 * b_small
    nbx = -(-q // BLOCK)
    partial = torch.empty((nbx, npts, 24), dtype=gl.DTYPE, device=X.device)
    out = torch.empty((npts, 24), dtype=gl.DTYPE, device=X.device)
    _launch("lt_fold_round0", _ptr(X), _ptr(Tb), _ptr(mu), _ptr(partial),
            _ptr(out), rows, q, b_small, _stream())
    fold_round0.launches += 1
    return out


def fold_roundr(X, Tb, mu, r3, b_small):
    """Fold sum-check round r >= 1, fold fused (replaces
    pallas_comb.fold_roundr_pallas)."""
    rows, q = _fold_check(X, Tb, mu, b_small, 4)
    if _route((X, Tb, mu)) == "cpu":
        return fold_roundr_twin(X, Tb, mu, r3, b_small)
    npts = 2 * b_small
    nbx = -(-q // BLOCK)
    F = torch.empty((rows, 24, 2 * q), dtype=gl.DTYPE, device=X.device)
    partial = torch.empty((nbx, npts, 24), dtype=gl.DTYPE, device=X.device)
    out = torch.empty((npts, 24), dtype=gl.DTYPE, device=X.device)
    _launch("lt_fold_roundr", _ptr(X), _ptr(F), _ptr(Tb), _ptr(mu),
            _ptr(partial), _ptr(out), rows, q, *_r3_args(r3), b_small,
            _stream())
    fold_roundr.launches += 1
    return out, F


def _lin_check(X, Tc, sets, npts, width_mult):
    rows, _, width = X.shape
    if width % width_mult or width < width_mult:
        raise ValueError(f"lin width {width} not a multiple of {width_mult}")
    q = width // width_mult
    _check("X", X, (rows, 24, width))
    _check("Tc", Tc, (24, q))
    if sets.rows != rows:
        raise ValueError(f"multisets index {sets.rows} rows, X has {rows}")
    if not 1 <= npts <= MAX_LIN_PTS:
        raise ValueError(f"npts {npts} outside 1..{MAX_LIN_PTS}")
    return rows, q


def _sets_args(sets):
    return [_ptr(sets.off), _ptr(sets.idx), _ptr(sets.sgn), len(sets.S)]


def lin_round0(X, Tc, sets, npts):
    """Linearization round 0 (replaces pallas_comb.lin_round0_pallas)."""
    rows, q = _lin_check(X, Tc, sets, npts, 2)
    if _route((X, Tc, sets.off)) == "cpu":
        return lin_round0_twin(X, Tc, sets, npts)
    nbx = -(-q // BLOCK)
    partial = torch.empty((nbx, npts, 24), dtype=gl.DTYPE, device=X.device)
    out = torch.empty((npts, 24), dtype=gl.DTYPE, device=X.device)
    _launch("lt_lin_round0", _ptr(X), _ptr(Tc), *_sets_args(sets),
            _ptr(partial), _ptr(out), q, npts, _stream())
    lin_round0.launches += 1
    return out


def lin_roundr(X, Tc, r3, sets, npts):
    """Linearization round r >= 1, fold fused (replaces
    pallas_comb.lin_roundr_pallas)."""
    rows, q = _lin_check(X, Tc, sets, npts, 4)
    if _route((X, Tc, sets.off)) == "cpu":
        return lin_roundr_twin(X, Tc, r3, sets, npts)
    nbx = -(-q // BLOCK)
    F = torch.empty((rows, 24, 2 * q), dtype=gl.DTYPE, device=X.device)
    partial = torch.empty((nbx, npts, 24), dtype=gl.DTYPE, device=X.device)
    out = torch.empty((npts, 24), dtype=gl.DTYPE, device=X.device)
    _launch("lt_lin_roundr", _ptr(X), _ptr(F), _ptr(Tc), *_sets_args(sets),
            _ptr(partial), _ptr(out), q, *_r3_args(r3), npts, _stream())
    lin_roundr.launches += 1
    return out, F


WRAPPERS = (fold_round0, fold_roundr, lin_round0, lin_roundr)
TWINS = {fold_round0: fold_round0_twin, fold_roundr: fold_roundr_twin,
         lin_round0: lin_round0_twin, lin_roundr: lin_roundr_twin}


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


reset_launches()
