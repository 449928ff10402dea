"""Verifier-variable collection: replay the NIFS verifier transcript and
record every challenge and intermediate value the in-circuit folding
verifier gates need (latticeum/crates/zkvm/src/zk_latticefold.rs:104-684).
"""

from __future__ import annotations

from ..field import host as H
from ..nifs import folding as fold, linearization as lin, nifs as nifs_mod
from ..nifs.structs import LCCCS

P = H.P


def zk_interpolate_with_terms(p_i, eval_at):
    """(res, terms) with terms in DESCENDING i order
    (sumcheck/verifier.rs:267-343)."""
    n = len(p_i)
    res = H.ntt_zero()
    terms = []
    for i in range(n - 1, -1, -1):
        num = (1, 0, 0)
        den = 1
        for j in range(n):
            if j == i:
                continue
            num = H.fq3_mul(num, H.fq3_sub(eval_at, (j % P, 0, 0)))
            den = den * (i - j) % P
        w = H.fq3_mul(num, H.fq3_scalar(pow(den, P - 2, P)))
        term = H.ntt_scalar_mul(p_i[i], w)
        terms.append(term)
        res = H.ntt_add(res, term)
    return res, terms


def zk_eq_eval(x_list, y_list):
    """(res, xi_yis, factors, sub_res) over Fq3 values, ring-embedded
    (sumcheck/utils.rs:98-131)."""
    xi_yis, factors, sub_res = [], [], [H.ntt_from_u64(1)]
    res = (1, 0, 0)
    for xi, yi in zip(x_list, y_list):
        xy = H.fq3_mul(xi, yi)
        xi_yis.append(H.ntt_from_fq3(xy))
        f = H.fq3_sub(H.fq3_add(H.fq3_add(xy, xy), (1, 0, 0)),
                      H.fq3_add(xi, yi))
        factors.append(H.ntt_from_fq3(f))
        res = H.fq3_mul(res, f)
        sub_res.append(H.ntt_from_fq3(res))
    return res, xi_yis, factors, sub_res


def _collect_sumcheck(proof_rounds, transcript, nvars, degree, initial_claim):
    """Replay a sum-check transcript, recording polys / claimed sums /
    subterms / evaluation point (zk_latticefold.rs:285-353, 615-684)."""
    transcript.absorb_u64(nvars)
    transcript.absorb_u64(degree)
    claimed = list(initial_claim)
    claimed_sums = [list(claimed)]
    subterms = []
    eval_point = []
    polynomials = []
    for rnd in range(nvars):
        evals = proof_rounds[rnd]
        transcript.absorb_slice(evals)
        r = transcript.get_challenge()
        eval_point.append(r)
        res, terms = zk_interpolate_with_terms(evals, r)
        claimed = res
        subterms.extend(terms)
        claimed_sums.append(list(claimed))
        transcript.absorb_fq3(r)
        polynomials.append([list(e) for e in evals])
    return {
        "polynomials": polynomials,
        "claimed_sums": claimed_sums,
        "claimed_sums_subterms": subterms,
        "evaluation_point": eval_point,          # Fq3 list
        "expected_evaluation": list(claimed),
    }


def collect_linearization_vars(cm_i, lin_proof, ccs, transcript):
    beta_s = lin.squeeze_beta(transcript, ccs.s)
    sc = _collect_sumcheck(lin_proof["sumcheck"], transcript, ccs.s,
                           ccs.d + 1, H.ntt_zero())
    _, xi_yis, factors, sub_res = zk_eq_eval(sc["evaluation_point"], beta_s)

    inner = H.ntt_zero()
    per_multiset = []
    for i, c in enumerate(ccs.c):
        prod = H.ntt_from_u64(1)
        for j in ccs.S[i]:
            prod = H.ntt_mul(prod, lin_proof["u"][j])
        per_multiset.append(prod)
        inner = H.ntt_add(inner, H.ntt_mul(list(c), prod))

    transcript.absorb_slice(lin_proof["v"])
    transcript.absorb_slice(lin_proof["u"])

    point_rings = [H.ntt_from_fq3(r) for r in sc["evaluation_point"]]
    lcccs = LCCCS(r=point_rings, v=lin_proof["v"],
                  cm=[list(x) for x in cm_i.cm], u=lin_proof["u"],
                  x_w=[list(x) for x in cm_i.x_ccs], h=H.ntt_from_u64(1))
    vars = {
        "beta_s": [H.ntt_from_fq3(b) for b in beta_s],
        "evaluation_polynomials": sc["polynomials"],
        "claimed_sums": sc["claimed_sums"],
        "claimed_sums_subterms": sc["claimed_sums_subterms"],
        "evaluation_point": point_rings,
        "expected_evaluation": sc["expected_evaluation"],
        "u": [list(u) for u in lin_proof["u"]],
        "inner": inner,
        "inner_per_multiset": per_multiset,
        "e_xi_yis": xi_yis,
        "e_factors": factors,
        "e_sub_res": sub_res,
    }
    return lcccs, vars


def collect_decomposition_vars(cm_i, dec_proof, transcript, K):
    lcccs_s = []
    for k in range(K):
        x, y, u, v = (dec_proof["x_s"][k], dec_proof["y_s"][k],
                      dec_proof["u_s"][k], dec_proof["v_s"][k])
        transcript.absorb_slice(x)
        transcript.absorb_slice(y)
        transcript.absorb_slice(u)
        transcript.absorb_slice(v)
        lcccs_s.append(LCCCS(r=[list(r) for r in cm_i.r], v=v, cm=y, u=u,
                             x_w=x[:-1], h=x[-1]))
    vars = {
        "cm": [list(c) for c in cm_i.cm],
        "y_s": dec_proof["y_s"],
        "v": [list(v) for v in cm_i.v],
        "v_s": dec_proof["v_s"],
        "u": [list(u) for u in cm_i.u],
        "u_s": dec_proof["u_s"],
        "x_w": [list(x) for x in cm_i.x_w],
        "h": list(cm_i.h),
        "x_s": dec_proof["x_s"],
    }
    return lcccs_s, vars


def collect_folding_vars(cm_i_s, proof, transcript, ccs, params):
    """Vectorized through field.hostvec (pinned against the scalar
    formulation by tests/test_collect.py): the α/ζ claim chains, the
    expected-evaluation value, and the final ρ-products are batched limb
    ops over the 2K-instance axis instead of pure-Python fq3 loops."""
    import numpy as np

    from .. import backend as B
    from ..field import goldilocks as gl, hostvec as HV

    K, b_small = params.K, params.B_SMALL
    alpha_s, beta_s, zeta_s, mu_s = fold.squeeze_alpha_beta_zeta_mu(
        transcript, ccs.s, K)

    t = ccs.t
    n_i = 2 * K
    with B.numpy_mode():
        v = HV.rings(np.array([[list(x) for x in c.v] for c in cm_i_s],
                              dtype=object))              # (n_i, 3, 24)
        u = HV.rings(np.array([[list(x) for x in c.u] for c in cm_i_s],
                              dtype=object))              # (n_i, t, 24)
        a3 = HV.fq3s(alpha_s)
        z3 = HV.fq3s(zeta_s)
        h1 = gl.add(HV.ntt_scalar_mul_batch((v[0][:, 2], v[1][:, 2]), a3),
                    (v[0][:, 1], v[1][:, 1]))
        h2 = gl.add(HV.ntt_scalar_mul_batch(h1, a3),
                    (v[0][:, 0], v[1][:, 0]))
        cl1 = HV.ntt_scalar_mul_batch(h2, a3)
        # Horner chain h_j = Σ_{m>=j} ζ^{m-j} u_m as a log-doubling suffix
        # cumsum of w_m = ζ^m u_m, then h_j = ζ^{-j} S_j: 7 batched adds
        # instead of t-2 sequential tiny muls (bit-equal, exact algebra)
        zpow = HV.fq3_seq_powers(z3, t)                   # ζ^1..ζ^t (t, n_i)
        zp = tuple((np.concatenate([np.ones((1, n_i), np.uint32)
                                    if c == 0 else
                                    np.zeros((1, n_i), np.uint32),
                                    zpow[c][0][:t - 1]]).T,
                    np.concatenate([np.zeros((1, n_i), np.uint32),
                                    zpow[c][1][:t - 1]]).T)
                   for c in range(3))                     # ζ^0..ζ^{t-1}
        zinv = [H.fq3_inv(z) for z in zeta_s]
        zipow = HV.fq3_seq_powers(HV.fq3s(zinv), t)       # ζ^-1..ζ^-t
        zip_ = tuple((np.concatenate([np.ones((1, n_i), np.uint32)
                                      if c == 0 else
                                      np.zeros((1, n_i), np.uint32),
                                      zipow[c][0][:t - 1]]).T,
                      np.concatenate([np.zeros((1, n_i), np.uint32),
                                      zipow[c][1][:t - 1]]).T)
                     for c in range(3))                   # ζ^0..ζ^-(t-1)
        w = HV.ntt_scalar_mul_batch(u, zp)                # (n_i, t, 24)
        S = w
        sh = 1
        while sh < t:
            Slo = S[0].copy()
            Shi = S[1].copy()
            head_add = gl.add((Slo[:, :t - sh], Shi[:, :t - sh]),
                              (S[0][:, sh:], S[1][:, sh:]))
            Slo[:, :t - sh] = head_add[0]
            Shi[:, :t - sh] = head_add[1]
            S = (Slo, Shi)
            sh *= 2
        h_all = HV.ntt_scalar_mul_batch(S, zip_)          # h_j at (n_i, j, 24)
        # list order: j = t-2 down to 0
        hs_st = (h_all[0][:, t - 2::-1], h_all[1][:, t - 2::-1])
        hh = (h_all[0][:, 0], h_all[1][:, 0])             # h_0
        g3i = HV.ntt_scalar_mul_batch(hh, z3)
        claim_g1_h1 = HV.to_rings(h1)
        claim_g1_h2 = HV.to_rings(h2)
        claim_g1_terms = HV.to_rings(cl1)
        claim_g1 = HV.to_rings(gl.sum_axis(cl1, axis=0))
        claim_g3_h = HV.to_rings((hs_st[0].reshape(-1, 24),
                                  hs_st[1].reshape(-1, 24)))
        claim_g3_terms = HV.to_rings(g3i)
        claim_g3 = HV.to_rings(gl.sum_axis(g3i, axis=0))
        total = H.ntt_add(claim_g1, claim_g3)

    sc = _collect_sumcheck(proof["sumcheck"], transcript, ccs.s,
                           2 * b_small, total)

    ris = [[H.ntt_slots(r)[0] for r in cm_i.r] for cm_i in cm_i_s]
    e_ast = fold._eq_eval_fq3(beta_s, sc["evaluation_point"])
    e_s = [fold._eq_eval_fq3(ri, sc["evaluation_point"]) for ri in ris]
    with B.numpy_mode():
        should = fold.expected_claim_value_vec(
            alpha_s, mu_s, proof["theta_s"], e_ast, e_s, zeta_s,
            proof["eta_s"], b_small, K)

    for th in proof["theta_s"]:
        transcript.absorb_slice(th)
    for et in proof["eta_s"]:
        transcript.absorb_slice(et)
    rho_coeff, rho_ntt = fold.get_rhos(transcript, K)

    with B.numpy_mode():
        rho_l = HV.rings(np.array(rho_ntt, dtype=object))
        rho_b = (rho_l[0][:, None], rho_l[1][:, None])

        def products(stack):
            arr = HV.rings(np.array(stack, dtype=object))  # (n_i, k, 24)
            out = HV.ntt_mul_batch(arr, rho_b)
            return HV.to_rings((np.asarray(out[0]).reshape(-1, 24),
                                np.asarray(out[1]).reshape(-1, 24)))

        final_cm_products = products(
            [[list(c) for c in cm_i.cm] for cm_i in cm_i_s])
        final_u_products = products(
            [[list(e) for e in etas] for etas in proof["eta_s"]])
        final_x_products = products(
            [[list(x) for x in cm_i.x_w] + [list(cm_i.h)]
             for cm_i in cm_i_s])

    return {
        "alpha_s": [H.ntt_from_fq3(a) for a in alpha_s],
        "beta_s": [H.ntt_from_fq3(b) for b in beta_s],
        "zeta_s": [H.ntt_from_fq3(zt) for zt in zeta_s],
        "mu_s": [H.ntt_from_fq3(m) for m in mu_s],
        "claim_g1_h1": claim_g1_h1,
        "claim_g1_h2": claim_g1_h2,
        "claim_g1_terms": claim_g1_terms,
        "claim_g1": claim_g1,
        "claim_g3_h": claim_g3_h,
        "claim_g3_terms": claim_g3_terms,
        "claim_g3": claim_g3,
        "sumcheck_polynomials": sc["polynomials"],
        "sumcheck_claimed_sums": sc["claimed_sums"],
        "sumcheck_claimed_sums_subterms": sc["claimed_sums_subterms"],
        "sumcheck_evaluation_point": [H.ntt_from_fq3(r)
                                      for r in sc["evaluation_point"]],
        "sumcheck_expected_evaluation": sc["expected_evaluation"],
        "should_equal_s": should,
        "rho_s": rho_ntt,
        "eta_s": [list(e) for etas in proof["eta_s"] for e in etas],
        "final_cm_products": final_cm_products,
        "final_u_products": final_u_products,
        "final_x_products": final_x_products,
    }


def generate_verification_witness_vars(acc, cm_i, proof, ccs, params,
                                       transcript_factory):
    transcript = transcript_factory()
    nifs_mod.absorb_public_input(acc, cm_i, transcript)
    linearized_cm_i, lin_vars = collect_linearization_vars(
        cm_i, proof["linearization"], ccs, transcript)
    dec_acc, dvars_l = collect_decomposition_vars(
        acc, proof["decomposition_l"], transcript, params.K)
    dec_cmi, dvars_r = collect_decomposition_vars(
        linearized_cm_i, proof["decomposition_r"], transcript, params.K)
    fvars = collect_folding_vars(dec_acc + dec_cmi, proof["folding"],
                                 transcript, ccs, params)
    return {
        "linearization": lin_vars,
        "decomp_l": dvars_l,
        "decomp_r": dvars_r,
        "folding": fvars,
    }
