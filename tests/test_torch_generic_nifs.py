"""The port's copy of the ring-generic NIFS (host/nifs/generic.py) over the
copied ring models: the cases of tests/test_generic_nifs.py on the copy
(the two full chains stay ``slow``, as there), and the generic
linearization, prover and verifier, against the JAX package's generic
NIFS on every model with a homogenization.  Exact integers."""

import random

import pytest

from latticeum_tpu.nifs import generic as G_jax
from latticeum_tpu.ring import models as models_jax
from latticeum_tpu_torch.host.nifs import generic as G
from latticeum_tpu_torch.host.ring import models


def _params(ring):
    # B^L >= q, b_small^K = B
    if ring.p.bit_length() > 64:
        B, L, b_small, K = 1 << 63, 4, 2, 63
    elif ring.p.bit_length() > 32:
        B, L, b_small, K = 1 << 16, 8, 2, 16
    else:
        B, L, b_small, K = 1 << 16, 2, 2, 16
    assert b_small ** K == B and B ** L > ring.p
    return {"B": B, "L": L, "b_small": b_small, "K": K,
            "tau": ring.D // ring.N}


def _instance(G, ring, x):
    params = _params(ring)
    ccs = G.toy_ccs(ring, params["L"])
    z = G.toy_z(ring, x)
    ccs.check_relation(ring, z)
    wit = G.witness_from_w(ring, z[ccs.l + 1:], params["B"], params["L"],
                           params["tau"])
    return params, ccs, z, wit


def _setup(ring):
    params, ccs, z, wit = _instance(G, ring, 3)
    scheme = G.GAjtai(ring, kappa=2, n=len(wit.f))
    cm_i = G.GCCCS(cm=scheme.commit(wit.f), x_ccs=z[:ccs.l])
    zero_w = [ring.zero()] * (ccs.n - ccs.l - 1)
    zwit = G.witness_from_w(ring, zero_w, params["B"], params["L"],
                            params["tau"])
    zcm = G.GCCCS(cm=scheme.commit(zwit.f), x_ccs=[ring.zero()] * ccs.l)
    acc, _ = G.lin_prove(ring, ccs, zcm, zwit, G.ShaTranscript(ring))
    return params, ccs, z, wit, scheme, cm_i, acc, zwit


def _chain(ring):
    params, ccs, z, wit, scheme, cm_i, acc, w_acc = _setup(ring)
    folded = acc
    for x, (cm, w) in ((3, (cm_i, wit)), (5, None)):
        if w is None:
            _, _, z2, w = _instance(G, ring, x)
            cm = G.GCCCS(cm=scheme.commit(w.f), x_ccs=z2[:ccs.l])
        tp = G.ShaTranscript(ring)
        new, w_acc, proof = G.nifs_prove(ring, ccs, scheme, folded, w_acc,
                                         cm, w, params, tp)
        tv = G.ShaTranscript(ring)
        assert G.nifs_verify(ring, ccs, folded, cm, proof, params,
                             tv) == new
        assert tv.state == tp.state
        folded = new


@pytest.mark.slow
def test_stark_prime_full_nifs_chain():
    _chain(G.GRing(models.STARK))


@pytest.mark.slow
def test_babybear_full_nifs_chain():
    ring = G.GRing(models.BABYBEAR)
    assert ring.d == 9
    _chain(ring)


def test_generic_ring_ops_stark():
    """Eq-table formula, relation, balanced decomposition at b = 2."""
    ring = G.GRing(models.STARK)
    p = ring.p
    ccs = G.toy_ccs(ring, 4)
    ccs.check_relation(ring, G.toy_z(ring, 2))
    rnd = random.Random(1)
    betas = [rnd.randrange(p) for _ in range(3)]
    table = G.build_eq_table(ring, [ring.scalar(b) for b in betas])
    for idx in range(8):
        e = 1
        for j in range(3):
            xj = (idx >> j) & 1
            e = e * ((betas[j] if xj else (1 - betas[j])) % p) % p
        assert table[idx] == ring.from_u64(e)
    coeffs = [(rnd.randrange(-(1 << 61), 1 << 61)) % p
              for _ in range(ring.D)]
    digs = G.decompose_balanced_coeffs(ring, coeffs, 2, 63)
    rec = [0] * ring.D
    for k in range(63):
        w = pow(2, k, p)
        rec = [(r + d * w) % p for r, d in zip(rec, digs[k])]
    assert rec == list(coeffs)


def test_babybear_homogenized_ring_ops():
    """crt_h is a ring isomorphism and the diagonal challenge embedding a
    field homomorphism."""
    ring = G.GRing(models.BABYBEAR)
    F = ring.F
    rnd = random.Random(7)
    a = [rnd.randrange(ring.p) for _ in range(ring.D)]
    b = [rnd.randrange(ring.p) for _ in range(ring.D)]
    ra, rb = ring.from_coeffs(a), ring.from_coeffs(b)
    assert ring.to_coeffs(ra) == a
    assert ring.to_coeffs(ring.mul(ra, rb)) == ring.m.poly_mul(a, b)
    c1 = tuple(rnd.randrange(ring.p) for _ in range(9))
    c2 = tuple(rnd.randrange(ring.p) for _ in range(9))
    assert ring.mul(ring.scalar(c1), ring.scalar(c2)) == \
        ring.scalar(F.mul(c1, c2))
    assert ring.mul(ring.scalar(c1), ra) == tuple(F.mul(c1, s) for s in ra)


@pytest.mark.parametrize("name", ["stark_prime", "babybear", "goldilocks"])
def test_lin_prove_matches_jax(name):
    """The copy's generic linearization against the original's on the toy
    CCS: the same proof, accumulator and SHA-256 transcript state, and the
    copy's verifier accepts it."""
    out = []
    for g, mods in ((G, models), (G_jax, models_jax)):
        ring = g.GRing(mods.MODELS[name])
        params, ccs, z, wit = _instance(g, ring, 3)
        scheme = g.GAjtai(ring, kappa=2, n=len(wit.f))
        cm_i = g.GCCCS(cm=scheme.commit(wit.f), x_ccs=z[:ccs.l])
        t = g.ShaTranscript(ring)
        acc, proof = g.lin_prove(ring, ccs, cm_i, wit, t)
        out.append((vars(acc), proof, t.state, ring, ccs, cm_i))
    (acc, proof, state, ring, ccs, cm_i), theirs = out
    assert (acc, proof, state) == theirs[:3]
    tv = G.ShaTranscript(ring)
    assert vars(G.lin_verify(ring, ccs, cm_i, proof, tv)) == acc
    assert tv.state == state
