"""The four sum-check comb kernels, the lin reconstruction tail and the
fold round's c pass: wrappers, plain-torch twins, launch counts.

Counterparts of the Pallas kernels in ``latticeum_tpu/zkvm/pallas_comb.py``
(``fold_round0_pallas``, ``fold_roundr_pallas``, ``lin_round0_pallas``,
``lin_roundr_pallas``), of the reconstruction rounds of the XLA
``latticeum_tpu/zkvm/accel_dev_fs.py:212`` ``run_fixed_phase_dev`` and of the
XLA half of the fold round, ``latticeum_tpu/zkvm/accel_rounds.py:403``
``_make_round_pallas`` (its ``_fold_t`` of the c rows, ``_pair_sum`` of the
eq tables and the c terms); the CUDA bodies are in ``csrc/comb.cu``, the
reconstruction tail's in ``csrc/recon.cu``.

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
  fresh F (rows, 24, 2q); returns (S over all points of F, F).  r3 is the
  challenge as a (3,) tensor on X's device (a row of the sum-check's
  challenges, which never leave the device), read by the kernel there.
* ``lin_round0(X, Tc, sets, npts)``: S[t] = sum_x Tc(x) * sum_i c_i
  prod_{j in S_i} f_t[j], t < npts, over X (rows, 24, 2q).
* ``lin_roundr(X, Tc, r3, sets, npts)``: fold at r as above, then the lin
  sums over F; returns (S, F).
* ``lin_recon_tail(mz, betas, scale3, state, pend0, msgs, chals, sets,
  r)``: the truncated lin sum-check's reconstruction tail, rounds r ..
  nv - 1, in one launch (csrc/recon.cu): the Mz rows mz (t, 24, 2) folded
  at chals[r - 1] (mz (t, 24, 1) as it is when r is 0) into column 0 of a
  2^(nv - r) wide table, zero past it, under the eq row of `betas` (nv -
  r, 3); each round's message S[t] = sum_x scale * e_t(x) * sum_i c_i
  prod_{j in S_i} f_t[j] at npts = msgs.shape[1] points, e_t the eq row
  extended to point t like the Mz rows, goes through the unweighted
  round tail (``challenger.round_tail``) into msgs[k], chals[k] and the
  challenger state, and the table is folded at the challenge.  Returns
  the final rows (t + 1, 24): the table folded at chals[nv - 1], the eq
  row times scale3.
* ``fold_c_round(c2r, eqs, r3, sums)``: a fold round's c terms and eq pair
  sums, one launch: c2r (2, 24, w) read as it is (r3 None) or (2, 24, 2w)
  folded at r3 first; Tn = the pair sums of eqs (3, 24, w), (3, 24, w/2);
  sums (4, 24) <- [sum_x Tn[j] c[j][x], j = 0, 1; sum_x Tn[j] c[j][h + x],
  j = 0, 1] over x < h = w/2, the rows of the round's sums after the tail
  comb's.  Returns (c, Tn).  c2r and eqs may be any views whose rows are
  contiguous (the fold head's interleaved rows).  ``pair_sum(eq)`` is the
  pair sums alone (the lin rounds' eq table) and
  ``fold_c_end(c2r, eqs, t_s, r3, E)`` the sum-check's end: [eq_i E_i,
  c_j folded at r3, interleaved; t_s folded at r3].  All three count
  their launches in ``fold_c_round.launches``.

The lin constants c_i are +-1 signs (``lin_sets``: the zkVM's own CCS, as
the Pallas lin kernels take them) or any rings (``lin_sets_general``):
then the kernels multiply each multiset's product by c_i where they add
or subtract it for a sign.

A wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel (and counts the launch) or raises.  There is no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..crypto import challenger
from ..field import fq3, goldilocks as gl
from ..kernels import (check as _check, counted as _counted,
                       launch as _launch, ptr as _ptr, route as _route,
                       stream as _stream)
from ..ring import rq
from . import tables

BLOCK = 128          # threads per block of every comb kernel (csrc/comb.cu)
MAX_B_SMALL = 4      # fold kernels are instantiated for npts = 2 .. 8
MAX_LIN_PTS = 12     # lin kernels are instantiated for npts = 1 .. 12
MAX_RECON_ROUNDS = 5  # the reconstruction tail's table is <= 32 columns
# the tail's shared memory beyond its static 18.8 KB (csrc/recon.cu)
MAX_RECON_SMEM = 192 * 1024
_TWIN_COLS = 8192    # column chunk of the twins (bounds their temporaries)


@dataclass
class LinSets:
    """The lin comb's static multisets S_i and constants c_i: on the host,
    as int32 device arrays (CSR offsets off, idx) for the kernels, and
    grouped by size for the plain-torch products (``groups``, see
    ``lin_groups``).  The constants are +-1 ``signs`` (host) and ``sgn``
    (int32, device), or rings: ``rings`` (nsets, 24) on the device, with
    signs and sgn None."""
    S: tuple
    signs: tuple
    rows: int
    off: torch.Tensor
    idx: torch.Tensor
    sgn: torch.Tensor
    rings: torch.Tensor
    groups: list


def _csr(S, rows, device):
    """The multisets as a tuple of tuples and their int32 CSR arrays."""
    S = tuple(tuple(int(j) for j in s) for s in S)
    if any(len(s) == 0 for s in S):
        raise ValueError("lin comb multisets must be non-empty")
    if sorted({j for s in S for j in s}) != list(range(rows)):
        # every Mz row must be folded by the round-r kernel
        raise ValueError(f"multisets must cover all {rows} Mz rows")
    off = [0]
    for s in S:
        off.append(off[-1] + len(s))
    flat = [j for s in S for j in s]
    return S, _i32(off, device), _i32(flat, device)


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def lin_sets(S, signs, rows, device):
    """The multisets with +-1 constants (one sign each)."""
    signs = tuple(int(s) for s in signs)
    if len(S) != len(signs) or any(s not in (1, -1) for s in signs):
        raise ValueError("lin comb needs one +-1 sign per multiset")
    S, off, idx = _csr(S, rows, device)
    return LinSets(S, signs, rows, off, idx, _i32(list(signs), device), None,
                   lin_groups(S, signs, device))


def lin_sets_general(S, c_rings, rows, device):
    """The multisets with ring constants c_i (24 values each, any field
    elements, slot-major)."""
    if len(S) != len(c_rings) or any(len(c) != 24 for c in c_rings):
        raise ValueError("lin comb needs one 24-value ring per multiset")
    S, off, idx = _csr(S, rows, device)
    c_rings = tuple(tuple(int(v) for v in c) for c in c_rings)
    return LinSets(S, None, rows, off, idx, None,
                   gl.from_int([list(c) for c in c_rings], device),
                   lin_groups(S, c_rings, device))


# -- shared pieces of the twins ----------------------------------------------

def fold_t(X, r3):
    """(..., 24, 2w) -> (..., 24, w): v0 + r (v1 - v0) on contiguous halves,
    r3 the challenge as a (3,) tensor on X's device."""
    w = X.shape[-1] // 2
    v0, v1 = X[..., :w], X[..., w:]
    return gl.add(v0, rq.ntt_scalar_mul_t(gl.sub(v1, v0), fq3.of(r3)))


def pair_sum_twin(x):
    """(..., 24, w) -> (..., 24, w/2): the sum of the two halves."""
    half = x.shape[-1] // 2
    return gl.add(x[..., :half], x[..., half:])


def contract_twin(a, b):
    """sum_x ntt_mul_t(a, b) over the minor axis -> (..., 24)."""
    return gl.sum_axis(rq.ntt_mul_t(a, b), -1)


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


def lin_groups(S, consts, device):
    """The multisets grouped by size, one batched product chain per size:
    [(weight, row ids (g, size))] as tensors on `device`.  `consts` holds
    one +-1 sign or one ring (24 values) per multiset; the weight is the
    sign > 0 mask (g,), or the rings as an Fq3 triple of (g, 8) slots."""
    groups = {}
    for i, s in enumerate(S):
        groups.setdefault(len(s), []).append(i)
    out = []
    for _, ids in sorted(groups.items()):
        if isinstance(consts[ids[0]], int):
            weight = torch.tensor([consts[i] > 0 for i in ids], device=device)
        else:
            weight = rq._as_slots(gl.from_int([list(consts[i]) for i in ids],
                                              device))
        out.append((weight, torch.tensor([S[i] for i in ids], device=device)))
    return out


def multiset_sum(f, groups):
    """sum_i c_i prod_{j in S_i} f[j] for an Fq3 triple f of (rows, ..., 8,
    n) tensors (the slots second to last) -> an Fq3 triple of (..., 8, n)
    tensors; c_i a sign or a ring, as ``lin_groups`` holds it."""
    total = None
    for weight, jidx in groups:
        prod = tuple(c[jidx[:, 0]] for c in f)               # (g, ...)
        for k in range(1, jidx.shape[1]):
            prod = fq3.mul(prod, tuple(c[jidx[:, k]] for c in f))
        if isinstance(weight, tuple):
            lead = (-1,) + (1,) * (prod[0].dim() - 3)
            part = tuple(gl.sum_axis(p, 0) for p in fq3.mul(
                prod, tuple(w.reshape(lead + (8, 1)) for w in weight)))
        else:
            mask = weight.reshape((-1,) + (1,) * (prod[0].dim() - 1))
            part = tuple(gl.sum_axis(torch.where(mask, p, gl.neg(p)), 0)
                         for p in prod)
        total = part if total is None else fq3.add(total, part)
    return total


def _lin_sums_twin(X, Tc, sets, npts):
    rows, _, w = X.shape
    q = w // 2
    S = torch.zeros((npts, 24), dtype=gl.DTYPE, device=X.device)
    groups = sets.groups
    for c0 in range(0, q, _TWIN_COLS):
        c1 = min(q, c0 + _TWIN_COLS)
        f = rq._as_slots_t(X[..., c0:c1])                    # (rows, 8, c)
        step = fq3.sub(rq._as_slots_t(X[..., q + c0:q + c1]), f)
        tc = rq._as_slots_t(Tc[..., c0:c1])
        for t in range(npts):
            qv = fq3.mul(multiset_sum(f, groups), tc)
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


def lin_recon_round_twin(X, sets, npts, scale3, r3=None):
    """A reconstruction round as the port first ran it, plain torch: each
    point's Mz and eq values, the multiset sum, the weight."""
    cur = X if r3 is None else fold_t(X, r3)
    t_rows = cur.shape[0] - 1
    half = cur.shape[-1] // 2
    v0, v1 = cur[..., :half], cur[..., half:]
    step = gl.sub(v1, v0)
    pts = [v0]
    for _t in range(npts - 1):
        pts.append(gl.add(pts[-1], step))
    f = rq._as_slots_t(torch.stack(pts, dim=1))   # (rows, npts, 8, half)
    q = multiset_sum(tuple(c[:t_rows] for c in f), sets.groups)
    e = fq3.mul(tuple(c[t_rows] for c in f), fq3.of(scale3))
    g = fq3.mul(q, e)
    msg = torch.stack([gl.sum_axis(c, -1) for c in g],
                      dim=-1).reshape(-1, 24)
    return msg if r3 is None else (msg, cur)


def lin_recon_fold_twin(X, r3, out, scale3=None):
    F = fold_t(X, r3)
    if scale3 is not None:
        F[-1] = rq.ntt_scalar_mul_t(F[-1], fq3.of(scale3))
    out[..., :F.shape[-1]] = F
    out[..., F.shape[-1]:] = 0
    return out


def lin_recon_tail_twin(mz, betas, scale3, state, pend0, msgs, chals, sets,
                        r):
    """The reconstruction tail as the port ran it before its kernel, plain
    torch, in the same order: the fold of the Mz rows into column 0, the
    eq table of the betas, then each round and its unweighted round tail,
    then the final fold, scaled."""
    nv, npts = msgs.shape[0], msgs.shape[1]
    t_rows, dev = mz.shape[0], mz.device
    rows = 1 << (nv - r)
    cur = torch.zeros((t_rows + 1, 24, rows), dtype=gl.DTYPE, device=dev)
    if r:
        lin_recon_fold_twin(mz, chals[r - 1], cur[:t_rows])
    else:
        cur[:t_rows, :, :1] = mz
    cur[t_rows] = tables.eq_table_twin(
        [tuple(b) for b in gl.to_int_lists(betas)], rows, dev, t_layout=True)
    for k in range(r, nv):
        if k == r:
            msg = lin_recon_round_twin(cur, sets, npts, scale3)
        else:
            msg, cur = lin_recon_round_twin(cur, sets, npts, scale3,
                                            chals[k - 1])
        msgs[k], chals[k], st, _ = challenger.round_tail_twin(
            msg, None, None, None, state, pend0 if k == 0 else chals[k - 1],
            weighted=False)
        state.copy_(st)
    final = torch.empty((t_rows + 1, 24, 1), dtype=gl.DTYPE, device=dev)
    lin_recon_fold_twin(cur, chals[nv - 1], final, scale3)
    return final[..., 0]


def fold_c_round_twin(c2r, eqs, r3=None):
    """A fold round's c terms as the port first ran them: the c rows'
    fold, the eq tables' pair sums and two contractions.  Returns (c, Tn,
    sums (4, 24))."""
    if r3 is not None:
        c2r = fold_t(c2r, r3)
    half = c2r.shape[-1] // 2
    Tn = pair_sum_twin(eqs)                                  # (3, 24, half)
    Sc0 = contract_twin(Tn[:2], c2r[..., :half])             # (2, 24)
    Sc1 = contract_twin(Tn[:2], c2r[..., half:])
    return c2r, Tn, torch.cat([Sc0, Sc1])


def fold_c_end_twin(c2r, eqs, t_s, r3, E):
    """The fold sum-check's final rows as the port first ran them: the
    tail and c rows folded at r3, each eq row times its weight E[i]."""
    t_s, c2r = fold_t(t_s, r3), fold_t(c2r, r3)
    eqr = [rq.ntt_scalar_mul_t(eqs[i], fq3.of(E[i])) for i in range(3)]
    return torch.cat([torch.stack([eqr[0], c2r[0], eqr[1], c2r[1],
                                   eqr[2]]), t_s])


# -- wrappers ------------------------------------------------------------------

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


def _sums_out(out, npts, device):
    if out is None:
        return torch.empty((npts, 24), dtype=gl.DTYPE, device=device)
    _check("out", out, (npts, 24))
    return out


def fold_round0(X, Tb, mu, b_small, out=None):
    """Fold sum-check round 0 (replaces pallas_comb.fold_round0_pallas);
    the sums into `out` (2 b_small, 24) where given."""
    rows, q = _fold_check(X, Tb, mu, b_small, 2)
    npts = 2 * b_small
    out = _sums_out(out, npts, X.device)
    if _route((X, Tb, mu, out)) == "cpu":
        return out.copy_(fold_round0_twin(X, Tb, mu, b_small))
    nbx = -(-q // BLOCK)
    partial = torch.empty((nbx, npts, 24), dtype=gl.DTYPE, device=X.device)
    _launch("lt_fold_round0", _ptr(X), _ptr(Tb), _ptr(mu), _ptr(partial),
            _ptr(out), rows, q, b_small, _stream())
    fold_round0.launches += 1
    return out


def fold_roundr(X, Tb, mu, r3, b_small, out=None):
    """Fold sum-check round r >= 1, fold fused (replaces
    pallas_comb.fold_roundr_pallas); the sums into `out` where given."""
    rows, q = _fold_check(X, Tb, mu, b_small, 4)
    _check("r3", r3, (3,))
    npts = 2 * b_small
    out = _sums_out(out, npts, X.device)
    if _route((X, Tb, mu, r3, out)) == "cpu":
        S, F = fold_roundr_twin(X, Tb, mu, r3, b_small)
        return out.copy_(S), F
    nbx = -(-q // BLOCK)
    F = torch.empty((rows, 24, 2 * q), dtype=gl.DTYPE, device=X.device)
    partial = torch.empty((nbx, npts, 24), dtype=gl.DTYPE, device=X.device)
    _launch("lt_fold_roundr", _ptr(X), _ptr(F), _ptr(Tb), _ptr(mu),
            _ptr(partial), _ptr(out), rows, q, _ptr(r3), b_small, _stream())
    fold_roundr.launches += 1
    return out, F


def _sets_check(sets, rows, npts):
    """Raise unless `sets` index `rows` Mz rows with one kind of constants
    and npts is a point count the kernels take."""
    if sets.rows != rows:
        raise ValueError(f"multisets index {sets.rows} rows, not {rows}")
    if (sets.sgn is None) == (sets.rings is None):
        raise ValueError("lin sets need either +-1 signs or ring constants")
    if not 1 <= npts <= MAX_LIN_PTS:
        raise ValueError(f"npts {npts} outside 1..{MAX_LIN_PTS}")


def _lin_check(X, Tc, sets, npts, width_mult):
    rows, _, width = X.shape
    if width % width_mult or width < width_mult:
        raise ValueError(f"lin width {width} not a multiple of {width_mult}")
    q = width // width_mult
    _check("X", X, (rows, 24, width))
    _check("Tc", Tc, (24, q))
    _sets_check(sets, rows, npts)
    return rows, q


def _sets_args(sets):
    """The kernels' multiset arguments: CSR, then the signs or the rings
    (the other a null pointer)."""
    consts = [None if c is None else _ptr(c) for c in (sets.sgn, sets.rings)]
    return [_ptr(sets.off), _ptr(sets.idx), *consts, len(sets.S)]


def _sets_tensors(sets):
    return tuple(t for t in (sets.off, sets.rings) if t is not None)


def lin_round0(X, Tc, sets, npts):
    """Linearization round 0 (replaces pallas_comb.lin_round0_pallas)."""
    rows, q = _lin_check(X, Tc, sets, npts, 2)
    if _route((X, Tc) + _sets_tensors(sets)) == "cpu":
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
    _check("r3", r3, (3,))
    if _route((X, Tc, r3) + _sets_tensors(sets)) == "cpu":
        return lin_roundr_twin(X, Tc, r3, sets, npts)
    nbx = -(-q // BLOCK)
    F = torch.empty((rows, 24, 2 * q), dtype=gl.DTYPE, device=X.device)
    partial = torch.empty((nbx, npts, 24), dtype=gl.DTYPE, device=X.device)
    out = torch.empty((npts, 24), dtype=gl.DTYPE, device=X.device)
    _launch("lt_lin_roundr", _ptr(X), _ptr(F), _ptr(Tc), *_sets_args(sets),
            _ptr(partial), _ptr(out), q, _ptr(r3), npts, _stream())
    lin_roundr.launches += 1
    return out, F


def recon_smem(rows, width, sets):
    """Bytes of the reconstruction tail's dynamic shared memory: the table
    (rows, 3, width) of one slot, the slot's ring constants where given,
    the CSR arrays and the multisets' order (csrc/recon.cu
    rc_smem_bytes)."""
    nsets, nnz = len(sets.S), sets.idx.numel()
    return (8 * (rows * 3 * width + (3 * nsets if sets.rings is not None
                                     else 0))
            + 4 * (nsets + 1 + nnz + 2 * nsets))


def lin_recon_tail(mz, betas, scale3, state, pend0, msgs, chals, sets, r):
    """The reconstruction tail of a truncated lin sum-check, rounds r ..
    nv - 1 (nv = msgs.shape[0]), one launch (replaces the tail of
    accel_dev_fs.run_fixed_phase_dev): writes msgs[r:], chals[r:] and
    state in place and returns the final rows (t + 1, 24).  pend0, what
    round 0 observes first, is read only when r is 0; after it round r
    observes chals[r - 1]."""
    t_rows = mz.shape[0]
    nv, npts = msgs.shape[0], msgs.shape[1]
    if not 0 <= r < nv:
        raise ValueError(f"round {r} outside 0..{nv - 1}")
    nr = nv - r
    if nr > MAX_RECON_ROUNDS:
        raise ValueError(f"{nr} reconstruction rounds, at most "
                         f"{MAX_RECON_ROUNDS}")
    _check("mz", mz, (t_rows, 24, 2 if r else 1))
    _check("betas", betas, (nr, 3))
    _check("scale3", scale3, (3,))
    _check("state", state, (challenger.WIDTH,))
    _check("pend0", pend0, (pend0.shape[0],))
    _check("msgs", msgs, (nv, npts, 24))
    _check("chals", chals, (nv, 3))
    if pend0.shape[0] > challenger.MAX_PENDING:
        raise ValueError(f"{pend0.shape[0]} pending values, at most "
                         f"{challenger.MAX_PENDING}")
    _sets_check(sets, t_rows, npts)
    smem = recon_smem(t_rows + 1, 1 << nr, sets)
    if smem > MAX_RECON_SMEM:
        raise ValueError(f"a {t_rows + 1} x 24 x {1 << nr} table takes "
                         f"{smem} bytes of shared memory, at most "
                         f"{MAX_RECON_SMEM}")
    args = (mz, betas, scale3, state, pend0, msgs, chals)
    if _route(args + _sets_tensors(sets)) == "cpu":
        return lin_recon_tail_twin(mz, betas, scale3, state, pend0, msgs,
                                   chals, sets, r)
    pend = pend0 if r == 0 else chals[r - 1]
    final = torch.empty((t_rows + 1, 24), dtype=gl.DTYPE, device=mz.device)
    _launch("lt_lin_recon_tail", _ptr(mz), t_rows, _ptr(betas),
            _ptr(scale3), _ptr(state), _ptr(pend), pend.shape[0], _ptr(msgs),
            _ptr(chals), _ptr(challenger.kernel_consts(mz.device)),
            *_sets_args(sets)[:4], len(sets.S), sets.idx.numel(), npts, nv, r,
            _ptr(final), _stream())
    lin_recon_tail.launches += 1
    return final


def _row_stride(name, x, rows, width):
    """The row stride of x (rows, 24, width), int64, each row contiguous."""
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: dtype {x.dtype}, expected int64")
    if tuple(x.shape) != (rows, 24, width):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"({rows}, 24, {width})")
    if x.stride(-1) != 1 or x.stride(-2) != width:
        raise ValueError(f"{name}: each row must be contiguous")
    return x.stride(0)


def _even_width(w):
    if w % 2 or w < 2:
        raise ValueError(f"pair-sum width {w} not a multiple of 2")


def fold_c_round(c2r, eqs, r3, sums):
    """A fold round's c terms and eq pair sums, one launch (replaces the
    XLA half of accel_rounds._make_round_pallas): returns (c, Tn) and
    writes sums (4, 24).  The launch keeps no state between launches, so
    launches on several streams may overlap."""
    w = eqs.shape[-1]
    _even_width(w)
    eq_rs = _row_stride("eqs", eqs, 3, w)
    c_rs = _row_stride("c2r", c2r, 2, w if r3 is None else 2 * w)
    _check("sums", sums, (4, 24))
    args = (c2r, eqs, sums) + (() if r3 is None else (r3,))
    if r3 is not None:
        _check("r3", r3, (3,))
    if _route(args) == "cpu":
        c, Tn, S = fold_c_round_twin(c2r, eqs, r3)
        sums.copy_(S)
        return c, Tn
    dev = eqs.device
    Tn = torch.empty((3, 24, w // 2), dtype=gl.DTYPE, device=dev)
    c = c2r if r3 is None else torch.empty((2, 24, w), dtype=gl.DTYPE,
                                           device=dev)
    _launch("lt_fold_c_round", _ptr(c2r), c_rs, _ptr(eqs), eq_rs,
            None if r3 is None else _ptr(r3),
            None if r3 is None else _ptr(c), _ptr(Tn), _ptr(sums), w,
            _stream())
    fold_c_round.launches += 1
    return c, Tn


def pair_sum(eq):
    """(rows, 24, w) or (24, w), rows contiguous -> the pair sums (rows,
    24, w/2) or (24, w/2), one launch (counted in fold_c_round's)."""
    w = eq.shape[-1]
    _even_width(w)
    flat = eq if eq.dim() == 3 else eq[None]
    rs = _row_stride("eq", flat, flat.shape[0], w)
    if _route((eq,)) == "cpu":
        return pair_sum_twin(eq)
    out = torch.empty(eq.shape[:-1] + (w // 2,), dtype=gl.DTYPE,
                      device=eq.device)
    _launch("lt_pair_sum", _ptr(eq), rs, flat.shape[0], _ptr(out), w,
            _stream())
    fold_c_round.launches += 1
    return out


def fold_c_end(c2r, eqs, t_s, r3, E):
    """The fold sum-check's final rows (5 + n_t, 24, w): eq_i E_i at rows
    0, 2, 4, the c rows (2, 24, 2w) folded at r3 at rows 1, 3, the tail
    t_s (n_t, 24, 2w) folded at r3 after them; eqs (3, 24, w), E (3, 3).
    One launch of fold_c_round's end kernel."""
    w = eqs.shape[-1]
    eq_rs = _row_stride("eqs", eqs, 3, w)
    c_rs = _row_stride("c2r", c2r, 2, 2 * w)
    n_t = t_s.shape[0]
    _check("t_s", t_s, (n_t, 24, 2 * w))
    _check("r3", r3, (3,))
    _check("E", E, (3, 3))
    if _route((c2r, eqs, t_s, r3, E)) == "cpu":
        return fold_c_end_twin(c2r, eqs, t_s, r3, E)
    out = torch.empty((5 + n_t, 24, w), dtype=gl.DTYPE, device=eqs.device)
    _launch("lt_fold_c_end", _ptr(c2r), c_rs, _ptr(eqs), eq_rs, _ptr(t_s),
            n_t, _ptr(r3), _ptr(E), _ptr(out), w, _stream())
    fold_c_round.launches += 1
    return out


WRAPPERS = (_counted(fold_round0, "lt_fold_round0"),
            _counted(fold_roundr, "lt_fold_roundr"),
            _counted(lin_round0, "lt_lin_round0"),
            _counted(lin_roundr, "lt_lin_roundr"))
_counted(lin_recon_tail, "lt_lin_recon_tail")
_counted(fold_c_round, "lt_fold_c_round", "lt_pair_sum", "lt_fold_c_end")
TWINS = {fold_round0: fold_round0_twin, fold_roundr: fold_roundr_twin,
         lin_round0: lin_round0_twin, lin_roundr: lin_roundr_twin}


def reset_launches():
    for w in WRAPPERS + (lin_recon_tail, fold_c_round):
        w.launches = 0


reset_launches()
