"""Folding subprotocol Πfold (latticefold/src/nifs/folding.rs + utils).

Folds 2K decomposed LCCCS instances into one via a degree-2·B_SMALL
sum-check over g = g1 (f_hat claims) + g2 (norm range products) + g3
(linearization claims), then short-challenge (ρ) linear combinations:
v_0 = RotSum, cm_0 = Σ ρ·cm, u_0 = Σ ρ·η, x_0 = Σ ρ·(x_w‖h), f_0 = Σ ρ·f.
"""

from __future__ import annotations

from .. import backend as B
import numpy as np

from ..field import goldilocks as gl, host as H
from ..poly import mle as mle_mod, sumcheck as sc
from ..ring import ref_impl as RI, rq
from .linearization import evaluate_mles_host
from .structs import LCCCS, TAU, Witness

P = H.P
ALPHA_DS = int.from_bytes(b"alpha_s", "big")
ZETA_DS = int.from_bytes(b"zeta_s", "big")
MU_DS = int.from_bytes(b"mu_s", "big")
BETA_DS = int.from_bytes(b"beta_s", "big")
RHO_DS = int.from_bytes(b"rho_s", "big")


def squeeze_alpha_beta_zeta_mu(transcript, log_m, K):
    """(folding/utils.rs:45-96): alpha(2K), zeta(2K), mu(2K-1)+ONE, beta(log_m)."""
    transcript.absorb_fq3(H.fq3_scalar(ALPHA_DS))
    alpha_s = [transcript.get_challenge() for _ in range(2 * K)]
    transcript.absorb_fq3(H.fq3_scalar(ZETA_DS))
    zeta_s = [transcript.get_challenge() for _ in range(2 * K)]
    transcript.absorb_fq3(H.fq3_scalar(MU_DS))
    mu_s = [transcript.get_challenge() for _ in range(2 * K - 1)]
    mu_s.append((1, 0, 0))
    transcript.absorb_fq3(H.fq3_scalar(BETA_DS))
    beta_s = [transcript.get_challenge() for _ in range(log_m)]
    return alpha_s, beta_s, zeta_s, mu_s


def get_rhos(transcript, K):
    """2K-1 short challenges + ONE, coeff + NTT forms (folding/utils.rs:116-127)."""
    transcript.absorb_fq3(H.fq3_scalar(RHO_DS))
    rhos_coeff = [transcript.get_short_challenge() for _ in range(2 * K - 1)]
    one = [1] + [0] * 23
    rhos_coeff.append(one)
    rhos_ntt = [RI.crt(list(r)) for r in rhos_coeff]
    return rhos_coeff, rhos_ntt


def _horner_combine(mles, coeff_fq3):
    """Σ_j coeff^{j+1} · mles[j]  (device, mles: (k, n, 24))."""
    lo, hi = mles
    k = lo.shape[0]
    acc = gl.zeros(lo.shape[1:])
    cdev = mle_mod.fq3_const(coeff_fq3)
    for j in range(k - 1, -1, -1):
        acc = rq.ntt_scalar_mul(gl.add(acc, (lo[j], hi[j])), cdev)
    return acc


def challenged_mz_combined(ccs, z_s, zeta_s, lo_idx, hi_idx):
    """Σ_{i∈half} Σ_j ζ_i^{j+1}·(M_j z_i) computed as Σ_j M_j·(Σ_i ζ_i^{j+1} z_i).

    Algebraic restructure of calculate_challenged_mz_mle
    (folding.rs:211-232): t matvecs total instead of t·K, and the Mz MLEs
    are never materialized.  Exact same result.
    """
    n = z_s[0][0].shape[0]
    t = ccs.t
    acc = gl.zeros((ccs.m, 24))
    for j in range(t):
        comb = gl.zeros((n, 24))
        for i in range(lo_idx, hi_idx):
            pw = H.fq3_pow(zeta_s[i], j + 1)
            comb = gl.add(comb, rq.ntt_scalar_mul(z_s[i], mle_mod.fq3_const(pw)))
        acc = gl.add(acc, ccs.M[j].matvec(comb, ccs.m))
    return acc


def create_sumcheck_mles(log_m, f_hat_mles, alpha_s, zeta_s, z_s, ccs,
                         r_s, beta_s, K):
    """Builds the g MLE list (folding/utils.rs:196-255).

    f_hat_mles: list of 2K (TAU, m, 24) device limbs.
    z_s: list of 2K (n, 24) device limbs (full z vectors).
    Returns (g_lo, g_hi) stacked (5 + 2K*TAU, m, 24).
    """
    def combined_half(lo_idx, hi_idx):
        acc = gl.zeros((1 << log_m, 24))
        for i in range(lo_idx, hi_idx):
            acc = gl.add(acc, _horner_combine(f_hat_mles[i], alpha_s[i]))
        acc = gl.add(acc, challenged_mz_combined(ccs, z_s, zeta_s,
                                                 lo_idx, hi_idx))
        return acc

    eq_r1 = mle_mod.build_eq_table([H.ntt_slots(r)[0] for r in r_s[0]])
    eq_r2 = mle_mod.build_eq_table([H.ntt_slots(r)[0] for r in r_s[K]])
    comb1 = combined_half(0, K)
    comb2 = combined_half(K, 2 * K)
    eq_beta = mle_mod.build_eq_table(beta_s)
    parts = [eq_r1, comb1, eq_r2, comb2, eq_beta]
    for i in range(2 * K):
        lo, hi = f_hat_mles[i]
        for d in range(TAU):
            parts.append((lo[d], hi[d]))
    return (B.xp.stack([p[0] for p in parts]),
            B.xp.stack([p[1] for p in parts]))


def make_comb_fn(mu_s, b_small, K):
    """comb over stacked g-mles (folding/utils.rs:269-321)."""
    two = make_comb_fn2(b_small, K)
    consts = mu_consts(mu_s)

    def comb(vals):
        return two(vals, consts)
    return comb


def mu_consts(mu_s):
    """Host mu list (Fq3 tuples) -> limb arrays (2K, 3) lo/hi."""
    arr = np.array([[c % H.P for c in m] for m in mu_s], dtype=object)
    return gl.from_int(arr)


def make_comb_fn2(b_small, K):
    """Two-arg comb for the device engine: comb(vals, mu_consts (2K,3))."""
    def comb(vals, consts):
        lo, hi = vals
        result = gl.add(rq.ntt_mul((lo[0], hi[0]), (lo[1], hi[1])),
                        rq.ntt_mul((lo[2], hi[2]), (lo[3], hi[3])))
        eq_b = (lo[4], hi[4])
        for k in range(2 * K):
            mu_dev = ((consts[0][k, 0], consts[1][k, 0]),
                      (consts[0][k, 1], consts[1][k, 1]),
                      (consts[0][k, 2], consts[1][k, 2]))
            inter = gl.zeros(lo[0].shape)
            for d in range(TAU - 1, -1, -1):
                f_i = (lo[5 + k * TAU + d], hi[5 + k * TAU + d])
                f_sq = rq.ntt_mul(f_i, f_i)
                ev = eq_b
                for b in range(1, b_small):
                    bb = gl.from_int(np.array(H.ntt_from_u64(b * b),
                                              dtype=object))
                    bb = (B.xp.broadcast_to(B.xp.asarray(bb[0]),
                                            f_sq[0].shape),
                          B.xp.broadcast_to(B.xp.asarray(bb[1]),
                                            f_sq[1].shape))
                    ev = rq.ntt_mul(ev, gl.sub(f_sq, bb))
                ev = rq.ntt_mul(ev, f_i)
                inter = rq.ntt_scalar_mul(gl.add(inter, ev), mu_dev)
            result = gl.add(result, inter)
        return result
    return comb


def rot_sum(rho_coeff, b_fq3_list):
    """RotSum (cyclotomic-rings/src/rotation.rs:45-61): host.

    rho_coeff: 24 coefficient ints; b: 24 Fq3 tuples.
    Returns 24 Fq3 tuples: Σ_i b_i · coeffs(X^i · rho).
    """
    acc = [(0, 0, 0)] * 24
    cur = list(rho_coeff)
    for b_i in b_fq3_list:
        for j in range(24):
            acc[j] = H.fq3_add(acc[j], H.fq3_mul(H.fq3_scalar(cur[j]), b_i))
        cur = RI.rot(cur)
    return acc


def rot_lin_combination(rho_s_coeff, theta_s):
    """v_0 = Σ_i RotSum(ρ_i, flatten(θ_i)) (rotation.rs:84-104).

    theta_s: 2K lists of TAU host rings. Returns TAU host rings.
    """
    acc = [(0, 0, 0)] * 24
    for rho, thetas in zip(rho_s_coeff, theta_s):
        flat = []
        for t in thetas:
            flat.extend(H.ntt_slots(t))   # TAU * 8 = 24 Fq3 values
        s = rot_sum(rho, flat)
        acc = [H.fq3_add(a, x) for a, x in zip(acc, s)]
    out = []
    for j in range(TAU):
        ring = [0] * 24
        for sslot in range(8):
            c = acc[8 * j + sslot]
            ring[3 * sslot], ring[3 * sslot + 1], ring[3 * sslot + 2] = c
        out.append(ring)
    return out


def rot_matrices(rho_s_coeff):
    """(n_i, 24, 24) object array R[i, k, j] = coeffs(X^k · rho_i)[j].

    RotSum(rho, b) = b^T · R — the rotation structure of rotation.rs:45-61
    captured as a per-instance coefficient matrix so the Fq3-weighted sum
    becomes a batched limb contraction."""
    n_i = len(rho_s_coeff)
    R = np.empty((n_i, 24, 24), dtype=object)
    for i, rho in enumerate(rho_s_coeff):
        cur = [c % P for c in rho]
        for k in range(24):
            R[i, k] = list(cur)
            cur = RI.rot(cur)
    return R


def rot_lin_combination_vec(rho_s_coeff, theta_s):
    """Vectorized rot_lin_combination: one batched limb contraction per Fq3
    component instead of n_i·24·24 pure-Python fq3 muls.  Bit-exact with
    rot_lin_combination (pinned by tests/test_collect.py).

    Returns TAU host rings (lists of 24 ints).  Call under numpy_mode."""
    n_i = len(rho_s_coeff)
    R = gl.from_int(rot_matrices(rho_s_coeff))          # (n_i, 24, 24)
    th = np.array([[list(t) for t in ths] for ths in theta_s],
                  dtype=object)                          # (n_i, TAU, 24)
    tl, thi = gl.from_int(th)
    # flatten to slot-major Fq3 components: (n_i, 24 slots, 3)
    tl = tl.reshape(n_i, 24, 3)
    thi = thi.reshape(n_i, 24, 3)
    acc = []                                             # per component c
    for c in range(3):
        b_c = (tl[..., c, None], thi[..., c, None])      # (n_i, 24, 1)
        prod = gl.mul(b_c, R)                            # (n_i, 24, 24)
        flat = (prod[0].reshape(n_i * 24, 24), prod[1].reshape(n_i * 24, 24))
        acc.append(gl.sum_axis(flat, axis=0))            # (24,)
    acc_int = [gl.to_int(a) for a in acc]                # 3 x (24,)
    out = []
    for j in range(TAU):
        ring = [0] * 24
        for s in range(8):
            for c in range(3):
                ring[3 * s + c] = int(acc_int[c][8 * j + s])
        out.append(ring)
    return out


def compute_v0_u0_x0_cm0_vec(rho_coeff, rho_ntt, theta_s, cm_i_s, eta_s, ccs):
    """Vectorized compute_v0_u0_x0_cm0 (folding/utils.rs:456-517): the
    ρ-linear combinations as three batched ntt_muls + sums over the instance
    axis.  Bit-exact with the scalar path (tests/test_collect.py).  Call
    under numpy_mode; returns plain int lists."""
    from ..field import hostvec as HV
    v_0 = rot_lin_combination_vec(rho_coeff, theta_s)
    rho_l = HV.rings(np.array(rho_ntt, dtype=object))    # (n_i, 24)
    rho_b = (rho_l[0][:, None], rho_l[1][:, None])

    def combine(stack):
        arr = HV.rings(np.array(stack, dtype=object))    # (n_i, k, 24)
        return HV.to_rings(gl.sum_axis(
            HV.ntt_mul_batch(arr, rho_b), axis=0))

    cm_0 = combine([[list(c) for c in cm_i.cm] for cm_i in cm_i_s])
    u_0 = combine([[list(e) for e in etas] for etas in eta_s])
    x_0 = combine([[list(x) for x in cm_i.x_w] + [list(cm_i.h)]
                   for cm_i in cm_i_s])
    return v_0, cm_0, u_0, x_0


def compute_v0_u0_x0_cm0(rho_s_coeff, rho_s_ntt, theta_s, cm_i_s, eta_s, ccs):
    """(folding/utils.rs:456-517) — host."""
    v_0 = rot_lin_combination(rho_s_coeff, theta_s)
    kappa = len(cm_i_s[0].cm)
    cm_0 = [H.ntt_zero() for _ in range(kappa)]
    for rho, cm_i in zip(rho_s_ntt, cm_i_s):
        for k in range(kappa):
            cm_0[k] = H.ntt_add(cm_0[k], H.ntt_mul(list(cm_i.cm[k]), rho))
    u_0 = [H.ntt_zero() for _ in range(ccs.t)]
    for rho, etas in zip(rho_s_ntt, eta_s):
        for j in range(ccs.t):
            u_0[j] = H.ntt_add(u_0[j], H.ntt_mul(rho, etas[j]))
    x_0 = [H.ntt_zero() for _ in range(ccs.l + 1)]
    for rho, cm_i in zip(rho_s_ntt, cm_i_s):
        xs = [list(x) for x in cm_i.x_w] + [list(cm_i.h)]
        for j in range(ccs.l + 1):
            x_0[j] = H.ntt_add(x_0[j], H.ntt_mul(rho, xs[j]))
    return v_0, cm_0, u_0, x_0


def _eq_eval_fq3(x_list, y_list):
    e = (1, 0, 0)
    for xi, yi in zip(x_list, y_list):
        xy = H.fq3_mul(xi, yi)
        e = H.fq3_mul(e, H.fq3_sub(H.fq3_add(H.fq3_add(xy, xy), (1, 0, 0)),
                                   H.fq3_add(xi, yi)))
    return e


def calculate_claims(alpha_s, zeta_s, cm_i_s):
    """claim_g1 = ΣΣ α^{j+1} v, claim_g3 = ΣΣ ζ^{j+1} u (folding.rs:311-343)."""
    g1 = H.ntt_zero()
    g3 = H.ntt_zero()
    for i, cm_i in enumerate(cm_i_s):
        pw = alpha_s[i]
        for v in cm_i.v:
            g1 = H.ntt_add(g1, H.ntt_scalar_mul(list(v), pw))
            pw = H.fq3_mul(pw, alpha_s[i])
        pw = zeta_s[i]
        for u in cm_i.u:
            g3 = H.ntt_add(g3, H.ntt_scalar_mul(list(u), pw))
            pw = H.fq3_mul(pw, zeta_s[i])
    return g1, g3


def expected_claim_value(alpha_s, mu_s, theta_s, e_ast, e_s, zeta_s, eta_s,
                         b_small, K):
    """(folding/utils.rs:365-408) — host."""
    total = H.ntt_zero()
    for i in range(2 * K):
        s1 = H.ntt_zero()
        pw = alpha_s[i]
        for th in theta_s[i]:
            s1 = H.ntt_add(s1, H.ntt_scalar_mul(
                H.ntt_scalar_mul(list(th), e_s[i]), pw))
            pw = H.fq3_mul(pw, alpha_s[i])
        s2 = H.ntt_zero()
        pw = mu_s[i]
        for th in theta_s[i]:
            prod = list(th)
            for b in range(1, b_small):
                jb = H.ntt_from_u64(b)
                prod = H.ntt_mul(prod, H.ntt_mul(H.ntt_sub(list(th), jb),
                                                 H.ntt_add(list(th), jb)))
            s2 = H.ntt_add(s2, H.ntt_scalar_mul(prod, pw))
            pw = H.fq3_mul(pw, mu_s[i])
        s2 = H.ntt_scalar_mul(s2, e_ast)
        s3 = H.ntt_zero()
        pw = zeta_s[i]
        for et in eta_s[i]:
            s3 = H.ntt_add(s3, H.ntt_scalar_mul(list(et), pw))
            pw = H.fq3_mul(pw, zeta_s[i])
        s3 = H.ntt_scalar_mul(s3, e_s[i])
        total = H.ntt_add(total, H.ntt_add(H.ntt_add(s1, s2), s3))
    return total


def expected_claim_value_vec(alpha_s, mu_s, theta_s, e_ast, e_s, zeta_s,
                             eta_s, b_small, K):
    """Vectorized expected_claim_value (folding/utils.rs:365-408): the
    ζ/α/μ power chains as batched limb ops over the (2K, t) instance grid.
    Bit-exact with the scalar path.  Call under numpy_mode; returns a host
    ring (list of 24 ints)."""
    from ..field import hostvec as HV
    n_i = 2 * K
    th = HV.rings(np.array([[list(t) for t in ths] for ths in theta_s],
                           dtype=object))                # (n_i, TAU, 24)
    et = HV.rings(np.array([[list(e) for e in etas] for etas in eta_s],
                           dtype=object))                # (n_i, t, 24)
    t = et[0].shape[1]
    a3 = HV.fq3s(alpha_s)                                # (n_i,)
    z3 = HV.fq3s(zeta_s)
    m3 = HV.fq3s(mu_s)
    e3 = HV.fq3s(e_s)
    east3 = HV.fq3s([e_ast])

    def powers(base, count):
        pw = HV.fq3_seq_powers(base, count)              # (count, n_i)
        return tuple((pw[c][0].T, pw[c][1].T) for c in range(3))  # (n_i, count)

    apow = powers(a3, TAU)
    zpow = powers(z3, t)
    mpow = powers(m3, TAU)

    def scal(r, s3):
        return HV.ntt_scalar_mul_batch(r, s3)

    # s1_i = Σ_d α_i^{d+1} θ_{i,d}
    s1 = gl.sum_axis(scal(th, apow), axis=1)             # (n_i, 24)
    # s2_i = Σ_d μ_i^{d+1} · θ·Π_b (θ-b)(θ+b)
    prod = th
    for b in range(1, b_small):
        bb = gl.from_int(np.array(H.ntt_from_u64(b), dtype=object))
        sq = HV.ntt_mul_batch(gl.sub(th, bb), gl.add(th, bb))
        prod = HV.ntt_mul_batch(prod, sq)
    s2 = gl.sum_axis(scal(prod, mpow), axis=1)
    s2 = scal(s2, east3)
    # s3_i = Σ_j ζ_i^{j+1} η_{i,j}
    s3v = gl.sum_axis(scal(et, zpow), axis=1)
    se = gl.add(scal(gl.add(s1, s3v), e3), s2)
    total = gl.sum_axis(se, axis=0)
    return [int(x) for x in gl.to_int(total)]


def prove(cm_i_s, wit_s, transcript, ccs, z_s, params):
    """Returns (lcccs, w_0, proof).  z_s: 2K full z vectors (device)."""
    from . import decomposition as dec
    K, b_small = params.K, params.B_SMALL
    assert len(cm_i_s) == 2 * K
    log_m = ccs.s
    alpha_s, beta_s, zeta_s, mu_s = squeeze_alpha_beta_zeta_mu(
        transcript, log_m, K)
    f_hat_mles = [w.f_hat for w in wit_s]
    r_s = [cm_i.r for cm_i in cm_i_s]
    g = create_sumcheck_mles(log_m, f_hat_mles, alpha_s, zeta_s, z_s, ccs,
                             r_s, beta_s, K)
    comb = make_comb_fn(mu_s, b_small, K)
    proof_sc, chals, _ = sc.prove(transcript, g, log_m, 2 * b_small, comb)
    r_0 = chals
    theta_s = [evaluate_mles_host(fh, r_0) for fh in f_hat_mles]
    eqT_r0 = dec.eq_transposed_rows(ccs, r_0)
    eta_s = [dec.eval_claims_via_eqT(eqT_r0, z) for z in z_s]
    for th in theta_s:
        transcript.absorb_slice(th)
    for et in eta_s:
        transcript.absorb_slice(et)
    rho_coeff, rho_ntt = get_rhos(transcript, K)
    # f_0 = Σ ρ_i f_i (device)
    f0 = None
    for rho, w in zip(rho_ntt, wit_s):
        rd = gl.from_int(np.array(rho, dtype=object))
        rd = (B.xp.broadcast_to(rd[0], w.f[0].shape),
              B.xp.broadcast_to(rd[1], w.f[1].shape))
        term = rq.ntt_mul(rd, w.f)
        f0 = term if f0 is None else gl.add(f0, term)
    v_0, cm_0, u_0, x_0 = compute_v0_u0_x0_cm0(
        rho_coeff, rho_ntt, theta_s, cm_i_s, eta_s, ccs)
    h = x_0[-1]
    lcccs = LCCCS(r=[H.ntt_from_fq3(c) for c in r_0], v=v_0, cm=cm_0,
                  u=u_0, x_w=x_0[:-1], h=h)
    f0_coeff = rq.icrt(f0)
    w_0 = Witness(w_ccs=__recompose_w(f0, params), f_coeff=f0_coeff, f=f0,
                  f_hat=Witness.build_fhat(f0_coeff))
    proof = {"sumcheck": proof_sc, "theta_s": theta_s, "eta_s": eta_s}
    return lcccs, w_0, proof


def __recompose_w(f0, params):
    from ..ring import decompose as dc
    return dc.gadget_recompose(f0, params.B, params.L)


def verify(cm_i_s, proof, transcript, ccs, params):
    K, b_small = params.K, params.B_SMALL
    assert len(cm_i_s) == 2 * K
    alpha_s, beta_s, zeta_s, mu_s = squeeze_alpha_beta_zeta_mu(
        transcript, ccs.s, K)
    g1, g3 = calculate_claims(alpha_s, zeta_s, cm_i_s)
    claim = H.ntt_add(g1, g3)
    r_0, expected = sc.verify(transcript, ccs.s, 2 * b_small, claim,
                              proof["sumcheck"])
    ris = [[H.ntt_slots(r)[0] for r in cm_i.r] for cm_i in cm_i_s]
    e_ast = _eq_eval_fq3(beta_s, r_0)
    e_s = [_eq_eval_fq3(ri, r_0) for ri in ris]
    should = expected_claim_value(alpha_s, mu_s, proof["theta_s"], e_ast,
                                  e_s, zeta_s, proof["eta_s"], b_small, K)
    if should != expected:
        raise ValueError("folding evaluation claim failed")
    for th in proof["theta_s"]:
        transcript.absorb_slice(th)
    for et in proof["eta_s"]:
        transcript.absorb_slice(et)
    rho_coeff, rho_ntt = get_rhos(transcript, K)
    v_0, cm_0, u_0, x_0 = compute_v0_u0_x0_cm0(
        rho_coeff, rho_ntt, proof["theta_s"], cm_i_s, proof["eta_s"], ccs)
    return LCCCS(r=[H.ntt_from_fq3(c) for c in r_0], v=v_0, cm=cm_0, u=u_0,
                 x_w=x_0[:-1], h=x_0[-1])
