"""Multilinear sum-check prover/verifier over RqNTT (LatticeFold flavor).

Protocol (bit-exact mirror of latticefold/src/utils/sumcheck.rs:51-112 +
prover.rs:62-168 + verifier.rs:100-141):
  * transcript: absorb(nvars), absorb(degree); per round absorb the
    degree+1 evaluations, sample an Fq3 challenge, absorb it back;
  * round message: evaluations of sum_b comb(P_1..P_k at (b, t)) for
    t = 0..degree, computed incrementally (P(t+1) = P(t) + step);
  * verifier: checks p(0)+p(1) == claim, interpolates at the challenge.

The prover's hypercube reduction runs on device (batched limb ops, summed
with overflow-safe mod-p reductions); the transcript and the (cheap)
verifier run on host ints.
"""

from __future__ import annotations

from .. import backend as B
from ..field import goldilocks as gl, host as H
from ..poly import mle as mle_mod
from ..ring import rq

P = H.P


def prove(transcript, mles, nv: int, degree: int, comb_fn, log=None,
          eq_info=None):
    """Run the sum-check prover.

    mles: limb pair of shape (k, 2^nv, 24) — the k multiplicands.
    comb_fn(vals) with vals a limb pair (k, B, 24) -> limb pair (B, 24).
    Returns (proof, challenges, final_mles):
      proof: list of rounds, each a list of degree+1 host ring elements;
      challenges: list of Fq3 tuples (host);
      final_mles: (k, 1, 24) limbs — each MLE fully fixed (prover state).
    """
    transcript.absorb_u64(nv)
    transcript.absorb_u64(degree)
    import time
    proof = []
    challenges = []
    cur = mles
    for _round in range(nv):
        _rt = time.time()
        lo, hi = cur
        n = lo.shape[-2]
        if n == 1 and _round < nv:
            # lazily-truncated MLEs collapsed before all variables were
            # bound.  The remaining logical entries are zero for every
            # truncated mle, but eq(beta, x) is NOT zero there — rebuild
            # the true remaining arrays: eq factors out as
            # (prod_j eq(r_j, beta_j)) * eq-table(beta[_round:]).
            rest = 1 << (nv - _round)
            z_lo = B.xp.zeros(lo.shape[:-2] + (rest - 1, 24), lo.dtype)
            lo = B.xp.concatenate([lo, z_lo], axis=-2)
            hi = B.xp.concatenate([hi, z_lo], axis=-2)
            if eq_info is not None:
                beta_list, eq_index = eq_info
                scale = (1, 0, 0)
                for rj, bj in zip(challenges, beta_list):
                    xy = H.fq3_mul(rj, bj)
                    scale = H.fq3_mul(scale, H.fq3_sub(
                        H.fq3_add(H.fq3_add(xy, xy), (1, 0, 0)),
                        H.fq3_add(rj, bj)))
                tab = mle_mod.build_eq_table(beta_list[_round:])
                tab = rq.ntt_scalar_mul(tab, mle_mod.fq3_const(scale))
                lo = B.at_set(lo, (eq_index,), tab[0])
                hi = B.at_set(hi, (eq_index,), tab[1])
            cur = (lo, hi)
            n = rest
        lo2 = lo.reshape(lo.shape[:-2] + (n // 2, 2, 24))
        hi2 = hi.reshape(hi.shape[:-2] + (n // 2, 2, 24))
        v0 = (lo2[..., 0, :], hi2[..., 0, :])
        v1 = (lo2[..., 1, :], hi2[..., 1, :])
        # evaluate the comb at ALL degree+1 points in one batched call:
        # point axis inserted after the mle axis -> (k, deg+1, half, 24)
        pts_lo = [v0[0], v1[0]]
        pts_hi = [v0[1], v1[1]]
        step = gl.sub(v1, v0)
        vals = v1
        for _t in range(2, degree + 1):
            vals = gl.add(vals, step)
            pts_lo.append(vals[0])
            pts_hi.append(vals[1])
        stacked = (B.xp.stack(pts_lo, axis=-3), B.xp.stack(pts_hi, axis=-3))
        evals = comb_fn(stacked)             # (deg+1, half, 24)
        sums = gl.sum_axis(evals, axis=-2)   # (deg+1, 24)
        ints = gl.to_int(sums)
        round_msg = [[int(x) for x in ints[t]] for t in range(degree + 1)]
        transcript.absorb_slice(round_msg)
        proof.append(round_msg)
        r = transcript.get_challenge()
        transcript.absorb_fq3(r)
        challenges.append(r)
        cur = gl.add(v0, rq.ntt_scalar_mul(step, mle_mod.fq3_const(r)))
        if log:
            log(f"sumcheck round {_round}: {time.time()-_rt:.1f}s")
    return proof, challenges, cur


def interpolate_uni_poly(p_i, eval_at):
    """Lagrange-interpolate ring evaluations p_i (at x = 0..len-1) at the Fq3
    point eval_at (verifier.rs:147-265). Host ints."""
    n = len(p_i)
    # early return if eval_at is one of the nodes
    for k in range(n):
        if eval_at == (k % P, 0, 0):
            return list(p_i[k])
    res = H.ntt_zero()
    for i in range(n):
        num = (1, 0, 0)
        den = 1
        for j in range(n):
            if j == i:
                continue
            num = H.fq3_mul(num, H.fq3_sub(eval_at, (j % P, 0, 0)))
            den = den * (i - j) % P
        w = H.fq3_mul(num, H.fq3_scalar(pow(den, P - 2, P)))
        res = H.ntt_add(res, H.ntt_scalar_mul(p_i[i], w))
    return res


def verify(transcript, nv: int, degree: int, claimed_sum, proof):
    """Verifier: returns (point, expected_evaluation) or raises ValueError.

    claimed_sum / evaluations are host ring elements (24-int lists).
    """
    transcript.absorb_u64(nv)
    transcript.absorb_u64(degree)
    randomness = []
    for rnd in range(nv):
        evals = proof[rnd]
        if len(evals) != degree + 1:
            raise ValueError("incorrect number of evaluations")
        transcript.absorb_slice(evals)
        r = transcript.get_challenge()
        transcript.absorb_fq3(r)
        randomness.append(r)
    expected = list(claimed_sum)
    for rnd in range(nv):
        evals = proof[rnd]
        p01 = H.ntt_add(evals[0], evals[1])
        if p01 != expected:
            raise ValueError(
                f"sumcheck failed at round {rnd}: p(0)+p(1) != expected")
        expected = interpolate_uni_poly(evals, randomness[rnd])
    return randomness, expected
