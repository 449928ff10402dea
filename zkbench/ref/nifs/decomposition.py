"""Decomposition subprotocol Πdecomp (latticefold/src/nifs/decomposition.rs).

Splits a B-norm witness into K B_SMALL-norm witnesses (transpose trick),
splits the statement x_w || h, commits each part (reconstructing y_0 =
cm - Σ b^i y_i to save one commitment), and emits per-part evaluation claims
u_s (Mz at r) and v_s (f_hat at r).  The verifier recomposes everything with
powers of B_SMALL and compares to the input LCCCS.
"""

from __future__ import annotations

from .. import backend as B
import numpy as np

from ..field import goldilocks as gl, host as H
from ..ring import decompose as dc, rq
from .linearization import evaluate_mles_host
from .structs import LCCCS, Witness

P = H.P


def decompose_witness(wit: Witness, params) -> list:
    """K witnesses from the B_SMALL/K split of f_coeff
    (decomposition.rs:160-166)."""
    f_s = dc.decompose_vec_into_k_vecs(wit.f_coeff, params.B_SMALL, params.K)
    out = []
    for k in range(params.K):
        fk = (f_s[0][k], f_s[1][k])
        out.append(Witness.from_f_coeff(fk, params.B, params.L))
    return out


def compute_x_s(x_w_host, h_host, params):
    """decompose_big_vec_into_k_vec_and_compose_back (decomposition/utils.rs:12-41).

    Returns K host lists of (l+1) ring elements.
    """
    x = [list(v) for v in x_w_host] + [list(h_host)]
    xd = gl.from_int(np.array(x, dtype=object))          # (l+1, 24) NTT
    coeff = rq.icrt(xd)
    big = dc.gadget_decompose(coeff, params.B, params.L)  # ((l+1)*L, 24)
    ks = dc.decompose_vec_into_k_vecs(big, params.B_SMALL, params.K)
    # per k: chunks of L recomposed with base B -> crt
    out = []
    for k in range(params.K):
        part = (ks[0][k], ks[1][k])                       # ((l+1)*L, 24)
        rec = dc.gadget_recompose(part, params.B, params.L)  # (l+1, 24) coeff
        ntt = rq.crt(rec)
        vals = gl.to_int(ntt)
        out.append([[int(v) for v in row] for row in vals])
    return out


def commit_witnesses(wit_s, scheme, cm_i: LCCCS, params):
    """y_0 = cm - Σ_{i>=1} b^i y_i; y_i = commit(wit_i) (decomposition.rs:178-201)."""
    b = params.B_SMALL
    ys_tail = [scheme.commit_host(w.f) for w in wit_s[1:]]
    acc = [[0] * 24 for _ in range(scheme.kappa)]
    for y in reversed(ys_tail):
        acc = [H.ntt_scalar_mul(H.ntt_add(a, yi), H.fq3_scalar(b))
               for a, yi in zip(acc, y)]
    y0 = [H.ntt_sub(c, a) for c, a in zip(cm_i.cm, acc)]
    return [y0] + ys_tail


def eq_transposed_rows(ccs, point):
    """For each matrix j: w_j = M_j^T @ eq(point) as (t, n, 24) limbs.

    Evaluation claims <mle[M_j z], eq(r)> then reduce to w_j · z —
    the Mz MLEs are never materialized (the reference's dominant memory
    and flame-graph cost, dp3 evaluation.tex:139-160).
    """
    from ..poly import mle as mle_mod
    cap = max(getattr(Mj, "max_row", ccs.m - 1) for Mj in ccs.M) + 1
    eq_tab = mle_mod.build_eq_table(point, max_rows=cap)
    outs = [Mj.matvec_T(eq_tab, ccs.n) for Mj in ccs.M]
    return (B.xp.stack([o[0] for o in outs]),
            B.xp.stack([o[1] for o in outs]))


def eval_claims_via_eqT(eqT, z):
    """u[j] = sum_col eqT[j, col] * z[col] -> t host rings."""
    prod = rq.ntt_mul(eqT, (z[0][None], z[1][None]))  # (t, n, 24)
    summed = gl.sum_axis(prod, axis=-2)               # (t, 24)
    vals = gl.to_int(summed)
    return [[int(v) for v in row] for row in vals]


def z_vector_dev(x_host, w_ccs):
    head = gl.from_int(np.array([list(v) for v in x_host], dtype=object))
    return (B.xp.concatenate([head[0], w_ccs[0]]),
            B.xp.concatenate([head[1], w_ccs[1]]))


def prove(cm_i: LCCCS, wit: Witness, transcript, ccs, scheme, params,
          eqT=None):
    """Returns (z_s list of (n,24) dev, lcccs_s, wit_s, proof)."""
    point = [H.ntt_slots(r)[0] for r in cm_i.r]  # embedded Fq3 challenges
    wit_s = decompose_witness(wit, params)
    x_s = compute_x_s(cm_i.x_w, cm_i.h, params)
    y_s = commit_witnesses(wit_s, scheme, cm_i, params)
    v_s = [evaluate_mles_host(w.f_hat, point) for w in wit_s]
    if eqT is None:
        eqT = eq_transposed_rows(ccs, point)
    z_s = []
    for k in range(params.K):
        z = z_vector_dev(x_s[k], wit_s[k].w_ccs)
        z_s.append(z)
    u_s = [eval_claims_via_eqT(eqT, z) for z in z_s]

    lcccs_s = []
    for k in range(params.K):
        transcript.absorb_slice(x_s[k])
        transcript.absorb_slice(y_s[k])
        transcript.absorb_slice(u_s[k])
        transcript.absorb_slice(v_s[k])
        lcccs_s.append(LCCCS(r=[list(r) for r in cm_i.r], v=v_s[k],
                             cm=y_s[k], u=u_s[k], x_w=x_s[k][:-1],
                             h=x_s[k][-1]))
    proof = {"u_s": u_s, "v_s": v_s, "x_s": x_s, "y_s": y_s}
    return z_s, lcccs_s, wit_s, proof


def _recompose(vecs_s, b_pows):
    """Σ_k b^k * vecs_s[k][j] per j (decomposition.rs:262-276)."""
    length = len(vecs_s[0])
    out = []
    for j in range(length):
        acc = H.ntt_zero()
        for k, bp in enumerate(b_pows):
            acc = H.ntt_add(acc, H.ntt_scalar_mul(vecs_s[k][j],
                                                  H.fq3_scalar(bp)))
        out.append(acc)
    return out


def verify(cm_i: LCCCS, proof, transcript, ccs, params):
    lcccs_s = []
    for k in range(params.K):
        transcript.absorb_slice(proof["x_s"][k])
        transcript.absorb_slice(proof["y_s"][k])
        transcript.absorb_slice(proof["u_s"][k])
        transcript.absorb_slice(proof["v_s"][k])
        lcccs_s.append(LCCCS(r=[list(r) for r in cm_i.r],
                             v=proof["v_s"][k], cm=proof["y_s"][k],
                             u=proof["u_s"][k], x_w=proof["x_s"][k][:-1],
                             h=proof["x_s"][k][-1]))
    b_pows = [pow(params.B_SMALL, k, P) for k in range(params.K)]
    if _recompose(proof["y_s"], b_pows) != [list(c) for c in cm_i.cm]:
        raise ValueError("decomposition: commitment recomposition failed")
    if _recompose(proof["v_s"], b_pows) != [list(v) for v in cm_i.v]:
        raise ValueError("decomposition: v recomposition failed")
    if _recompose(proof["u_s"], b_pows) != [list(u) for u in cm_i.u]:
        raise ValueError("decomposition: u recomposition failed")
    xh = _recompose(proof["x_s"], b_pows)
    if xh[:-1] != [list(x) for x in cm_i.x_w] or xh[-1] != list(cm_i.h):
        raise ValueError("decomposition: statement recomposition failed")
    return lcccs_s
