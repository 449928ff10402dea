"""Linearization subprotocol Πlin (latticefold/src/nifs/linearization.rs).

Prover: sum-check over g(x) = eq(β,x) · Σ_i c_i Π_{j∈S_i} mle[M_j z](x),
degree ccs.d + 1, then sends v = mle[f_hat](r), u = mle[Mz](r).
Verifier: checks the sum-check (claim 0) and e·Σ c_i Π u_j == s.
"""

from __future__ import annotations

from .. import backend as B
import numpy as np

from ..field import goldilocks as gl, host as H
from ..poly import mle as mle_mod, sumcheck as sc
from ..ring import rq
from .structs import CCCS, LCCCS

BETA_DS = int.from_bytes(b"beta_s", "big")


def _ring_const_dev(c_host, shape):
    c = gl.from_int(np.array(c_host, dtype=object))
    return (B.xp.broadcast_to(c[0], shape), B.xp.broadcast_to(c[1], shape))


def make_comb_fn(ccs):
    """comb(vals (t+1, B, 24)) = (Σ_i c_i Π_{j∈S_i} vals[j]) · vals[t]."""
    two = make_comb_fn2(tuple(tuple(s) for s in ccs.S))
    import numpy as np
    consts = gl.from_int(np.array([list(c) for c in ccs.c], dtype=object))

    def comb(vals):
        return two(vals, consts)
    return comb


def make_comb_fn2(S):
    """Two-arg comb for the device engine: comb(vals, c_consts (q,24))."""
    def comb(vals, consts):
        lo, hi = vals
        total = None
        for i, S_i in enumerate(S):
            had = None
            for j in S_i:
                term = (lo[j], hi[j])
                had = term if had is None else rq.ntt_mul(had, term)
            ci = (consts[0][i], consts[1][i])
            term = rq.ntt_mul(had, ci)
            total = term if total is None else gl.add(total, term)
        return rq.ntt_mul(total, (lo[-1], hi[-1]))
    return comb


def squeeze_beta(transcript, s):
    transcript.absorb_fq3(H.fq3_scalar(BETA_DS))
    return [transcript.get_challenge() for _ in range(s)]


def evaluate_mles_host(mles_dev, point):
    """(k, n, 24) device MLEs evaluated at host Fq3 point -> host rings.

    Supports lazily-truncated MLEs (length < 2^len(point))."""
    out = mle_mod.evaluate(mles_dev, [mle_mod.fq3_const(r) for r in point])
    vals = gl.to_int(out)  # (k, 24)
    return [[int(x) for x in vals[k]] for k in range(vals.shape[0])]


def prove(cm_i: CCCS, wit, transcript, ccs, log=None):
    """Returns (lcccs, proof, mz_mles_dev)."""
    import time
    _t = time.time()

    def _log(msg):
        if log:
            log(f"lin.prove {msg} [{time.time()-_t:.1f}s]")

    beta_s = squeeze_beta(transcript, ccs.s)
    z = cm_i.z_vector(wit.w_ccs)
    # lazy truncation: gate rows occupy a prefix; beyond it every Mz MLE is
    # exactly zero, so the sum-check runs on truncated arrays (the analog of
    # the reference's truncate_lnze, mle/dense.rs:93)
    cap = max(getattr(Mj, "max_row", ccs.m - 1) for Mj in ccs.M) + 1
    cap = 1 << (cap - 1).bit_length()
    cap = min(cap, ccs.m)
    mz = ccs.matvecs(z, out_rows=cap)         # (t, cap, 24)
    _log("matvecs done")
    eq_tab = mle_mod.build_eq_table(beta_s, max_rows=cap)
    _log("eq table done")
    g_lo = B.xp.concatenate([mz[0], eq_tab[0][None]])
    g_hi = B.xp.concatenate([mz[1], eq_tab[1][None]])
    comb = make_comb_fn(ccs)
    proof_sc, chals, _ = sc.prove(transcript, (g_lo, g_hi), ccs.s,
                                  ccs.d + 1, comb, log=log,
                                  eq_info=(beta_s, ccs.t))
    _log("sumcheck done")
    point_r = [H.ntt_from_fq3(r) for r in chals]
    v = evaluate_mles_host(wit.f_hat, chals)
    _log("v evals done")
    u = evaluate_mles_host(mz, chals)
    _log("u evals done")
    transcript.absorb_slice(v)
    transcript.absorb_slice(u)
    proof = {"sumcheck": proof_sc, "v": v, "u": u}
    lcccs = LCCCS(r=point_r, v=v, cm=[list(x) for x in cm_i.cm], u=u,
                  x_w=[list(x) for x in cm_i.x_ccs], h=H.ntt_from_u64(1))
    return lcccs, proof, mz


def verify(cm_i: CCCS, proof, transcript, ccs):
    beta_s = squeeze_beta(transcript, ccs.s)
    point, s_val = sc.verify(transcript, ccs.s, ccs.d + 1,
                             H.ntt_zero(), proof["sumcheck"])
    # e = eq(point, beta)
    e = (1, 0, 0)
    for ri, bi in zip(point, beta_s):
        xy = H.fq3_mul(ri, bi)
        e = H.fq3_mul(e, H.fq3_sub(H.fq3_add(H.fq3_add(xy, xy), (1, 0, 0)),
                                   H.fq3_add(ri, bi)))
    total = H.ntt_zero()
    for i in range(ccs.q):
        had = H.ntt_from_u64(1)
        for j in ccs.S[i]:
            had = H.ntt_mul(had, proof["u"][j])
        total = H.ntt_add(total, H.ntt_mul(list(ccs.c[i]), had))
    should_equal_s = H.ntt_scalar_mul(total, e)
    if should_equal_s != s_val:
        raise ValueError("linearization evaluation claim failed")
    transcript.absorb_slice(proof["v"])
    transcript.absorb_slice(proof["u"])
    return LCCCS(r=[H.ntt_from_fq3(r) for r in point], v=proof["v"],
                 cm=[list(x) for x in cm_i.cm], u=proof["u"],
                 x_w=[list(x) for x in cm_i.x_ccs], h=H.ntt_from_u64(1))
