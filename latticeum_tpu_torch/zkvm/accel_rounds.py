"""Eq-factored (Gruen) sum-check rounds with the host transcript.

Counterpart of ``latticeum_tpu/zkvm/accel_rounds.py``:
``run_lin_rounds_factored`` (:516) and ``run_fold_rounds_factored`` (:909)
with the host Fiat-Shamir transcript, one round at a time (the reference's
``LATTICEUM_CHAIN=0`` math).  Round messages are bit-identical to the host
path ``nifs/*.prove``: the eq table never enters the comb, each round's comb
is evaluated at deg+1 points by a comb kernel (``comb.py``), and the host
extends the sums to the message points and applies the E * eqf(beta_r, t)
weights with exact integers.

Shrink rounds run until the arrays are one column wide; there is no
fixed-width phase.  When the lin stack is truncated (its width below
2^nv, ROADMAP C.h5), the remaining variables are finished by unfactored
rounds over a rebuilt eq table, exactly as the reference's truncated-MLE
reconstruction (``accel_rounds.py:240-276``); those rounds are tiny and stay
plain torch.  The host-side helpers (Lagrange extension, eqf weights, the
transcript round) are the reference's own, imported as they are.

All arrays are t-layout (rows, 24, n) with a bit-reversed hypercube, so a
round pairs the two contiguous halves.
"""

from __future__ import annotations

import torch

from latticeum_tpu.field import host as H
from latticeum_tpu.zkvm.accel_fs import _lagrange_ext_consts
from latticeum_tpu.zkvm.accel_rounds import (_eqf_at, _eqf_host, _extend_host,
                                             _transcript_round, _weighted_msg)
from latticeum_tpu.zkvm.accel_t import build_eq_table_rev

from ..field import fq3, goldilocks as gl
from ..ring import rq
from . import comb

P = gl.P


def _rows_to_pts(S):
    """(npts, 24) sums tensor -> [pt][slot] Fq3 int triples."""
    v = gl.to_int_lists(S)
    return [[tuple(row[3 * s:3 * s + 3]) for s in range(8)] for row in v]


def _pair_sum(x):
    half = x.shape[-1] // 2
    return gl.add(x[..., :half], x[..., half:])


def _contract(a, b):
    """sum_x ntt_mul_t(a, b) over the minor axis -> (..., 24)."""
    return gl.sum_axis(rq.ntt_mul_t(a, b), -1)


# -- linearization --------------------------------------------------------------

def _lin_reconstruct(transcript, stack, nv, r, degree, sets, beta_s, chals):
    """Unfactored rounds r..nv-1 over a truncated stack that is one column
    wide: Mz finals at column 0 of a 2^(nv-r) wide table, the eq row
    rebuilt for the remaining variables and scaled by prod eqf(beta_j, r_j).
    Returns (proof, chals, final rows)."""
    dev = stack.device
    t_rows = stack.shape[0] - 1
    rest = 1 << (nv - r)
    scale = (1, 0, 0)
    for rj, bj in zip(chals, beta_s):
        scale = H.fq3_mul(scale, _eqf_at(bj, rj))
    tab = build_eq_table_rev(beta_s[r:])                  # (rest, 24) limbs
    tab_t = rq.ntt_scalar_mul_t(gl.from_limbs(tab, dev).T.contiguous(),
                                fq3.const(scale, dev))
    cur = torch.zeros((t_rows + 1, 24, rest), dtype=gl.DTYPE, device=dev)
    cur[:, :, 0] = stack[:, :, 0]
    cur[t_rows] = tab_t
    groups = comb.lin_groups(sets, dev)
    proof, out = [], []
    while r < nv:
        half = cur.shape[-1] // 2
        v0, v1 = cur[..., :half], cur[..., half:]
        step = gl.sub(v1, v0)
        pts = [v0]
        for _t in range(degree):
            pts.append(gl.add(pts[-1], step))
        f = rq._as_slots_t(torch.stack(pts, dim=1))   # (rows, deg+1, 8, half)
        q = comb.signed_multiset_sum(tuple(c[:t_rows] for c in f), groups)
        g = fq3.mul(q, tuple(c[t_rows] for c in f))
        msg = gl.to_int_lists(torch.stack(
            [gl.sum_axis(c, -1) for c in g], dim=-1).reshape(-1, 24))
        c = _transcript_round(transcript, msg)
        proof.append(msg)
        out.append(c)
        cur = gl.add(v0, rq.ntt_scalar_mul_t(step, fq3.const(c, dev)))
        r += 1
    return proof, out, cur[..., 0]


def run_lin_rounds_factored(transcript, g_t, nv, degree, sets, beta_s,
                            log=None):
    """Eq-factored linearization sum-check.

    g_t: (t+1, 24, n0) t-layout stack, eq row last (n0 <= 2^nv, a power of
    two); sets: the multisets with their +-1 signs (comb.lin_sets).  Each
    round folds the previous challenge into the Mz rows and evaluates
    q = sum_i c_i prod Mz_j at deg(q)+1 = degree points, weighted by the
    pair-summed eq table (lin_round0 / lin_roundr); the eq table advances
    by pair sums only.  Returns (proof, chals, final) with final rows in
    [Mz..., eq] order, (t+1, 24)."""
    dev = g_t.device
    t_rows = g_t.shape[0] - 1
    n0 = g_t.shape[-1]
    npts_q, n_msg = degree, degree + 1
    ext_q = _lagrange_ext_consts(npts_q, n_msg)
    transcript.absorb_u64(nv)
    transcript.absorb_u64(degree)

    mz, eq = g_t[:t_rows], g_t[t_rows]
    E = (1, 0, 0)
    proof, chals = [], []
    r = 0
    while r < nv and (mz.shape[-1] // 2 if r else mz.shape[-1]) >= 2:
        Tc = _pair_sum(eq).contiguous()
        if r == 0:
            Sq = comb.lin_round0(mz.contiguous(), Tc, sets, npts_q)
        else:
            Sq, mz = comb.lin_roundr(mz, Tc, chals[-1], sets, npts_q)
        S_ext = _extend_host(_rows_to_pts(Sq), ext_q)
        w_t = [H.fq3_mul(E, _eqf_host(beta_s[r], t)) for t in range(n_msg)]
        msg = _weighted_msg([(w_t, S_ext)], n_msg)
        c = _transcript_round(transcript, msg)
        proof.append(msg)
        chals.append(c)
        E = H.fq3_mul(E, _eqf_at(beta_s[r], c))
        eq = Tc
        r += 1
    if r:
        mz = comb.fold_t(mz, chals[-1])
    # the unfactored eq row equals E * T (T the carried pair-sum table)
    eqr = rq.ntt_scalar_mul_t(eq, fq3.const(E, dev))
    stack = torch.cat([mz, eqr[None]])
    if r < nv:
        tp, tc, final = _lin_reconstruct(transcript, stack, nv, r, degree,
                                         sets, beta_s, chals)
        proof.extend(tp)
        chals.extend(tc)
    else:
        final = stack[..., 0]
    if log:
        log(f"      lin rounds: {r} factored + {nv - r} reconstruction (n0={n0})")
    return proof, chals, final


# -- folding --------------------------------------------------------------------

def mu_powers(mu_s, K, TAU=3):
    """mu_k^{d+1}, k-major (row k*TAU + d) -> host list of Fq3 triples."""
    out = []
    for k in range(2 * K):
        p = (1, 0, 0)
        for _d in range(TAU):
            p = H.fq3_mul(p, tuple(int(x) % P for x in mu_s[k]))
            out.append(p)
    return out


def run_fold_rounds_factored(transcript, head, tail, nv, degree, mu_s,
                             eq_points, b_small, K, TAU=3, log=None):
    """Eq-factored folding sum-check.

    head: (5, 24, n) rows [eq_r1, c1, eq_r2, c2, eq_beta]; tail: the
    (2K*TAU, 24, n) f_hat rows, n = 2^nv; eq_points = (r1, r2, beta) host Fq3
    lists; mu_s the 2K host mu challenges.  Each round folds the challenge
    into the f_hat rows (fold_roundr) and the c rows, pair-sums the three eq
    tables, evaluates h at 2*b_small points over the tail (T_beta-weighted,
    fold_round0 / fold_roundr) and the two linear c terms at {0, 1}
    (T_r-weighted).  Returns (proof, chals, final) with final rows in the
    [eq1, c1, eq2, c2, eq_beta, f_hat...] order."""
    dev = tail.device
    n0 = tail.shape[-1]
    if n0 != 1 << nv:
        raise ValueError(f"fold sum-check needs full-width MLEs ({n0} != 2^{nv})")
    npts_h, n_msg = 2 * b_small, degree + 1
    ext_h = _lagrange_ext_consts(npts_h, n_msg)
    ext_c = _lagrange_ext_consts(2, n_msg)
    mu = gl.from_int([list(m) for m in mu_powers(mu_s, K, TAU)], dev)
    transcript.absorb_u64(nv)
    transcript.absorb_u64(degree)

    t_s = tail.contiguous()
    c2r, eqs = head[1:4:2], head[0::2]
    E = [(1, 0, 0)] * 3
    proof, chals = [], []
    r = 0
    while r < nv:
        if r:
            c2r = comb.fold_t(c2r, chals[-1])
        half = c2r.shape[-1] // 2
        Tn = _pair_sum(eqs)                                  # (3, 24, half)
        Sc0 = _contract(Tn[:2], c2r[..., :half])             # (2, 24)
        Sc1 = _contract(Tn[:2], c2r[..., half:])
        Tb = Tn[2].contiguous()
        if r == 0:
            Sh = comb.fold_round0(t_s, Tb, mu, b_small)
        else:
            Sh, t_s = comb.fold_roundr(t_s, Tb, mu, chals[-1], b_small)
        sc = _rows_to_pts(torch.cat([Sc0, Sc1]))             # [tbl0@0, tbl1@0, tbl0@1, tbl1@1]
        terms = []
        for tbl in range(2):
            S_ext = _extend_host([sc[tbl], sc[2 + tbl]], ext_c)
            w_t = [H.fq3_mul(E[tbl], _eqf_host(eq_points[tbl][r], t))
                   for t in range(n_msg)]
            terms.append((w_t, S_ext))
        w_t = [H.fq3_mul(E[2], _eqf_host(eq_points[2][r], t))
               for t in range(n_msg)]
        terms.append((w_t, _extend_host(_rows_to_pts(Sh), ext_h)))
        msg = _weighted_msg(terms, n_msg)
        c = _transcript_round(transcript, msg)
        proof.append(msg)
        chals.append(c)
        for tbl in range(3):
            E[tbl] = H.fq3_mul(E[tbl], _eqf_at(eq_points[tbl][r], c))
        eqs = Tn
        r += 1
    t_s = comb.fold_t(t_s, chals[-1])
    c2r = comb.fold_t(c2r, chals[-1])
    eqr = [rq.ntt_scalar_mul_t(eqs[i], fq3.const(E[i], dev)) for i in range(3)]
    head_f = torch.stack([eqr[0], c2r[0], eqr[1], c2r[1], eqr[2]])
    final = torch.cat([head_f, t_s])[..., 0]
    if log:
        log(f"      fold rounds: {r} factored (n0={n0})")
    return proof, chals, final
