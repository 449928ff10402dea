"""The port's copy of the cross-ring models (host/ring/models.py: BabyBear,
Frog, StarkPrime, Goldilocks): every case of tests/test_ring_models.py on
the copy (CRT factorization, slot-wise products, ICRT, balanced
decomposition, homogenization), and each model's tables and products
against the JAX package's ring/models.py.  Exact integers."""

import numpy as np
import pytest

from latticeum_tpu.ring import models as M_jax
from latticeum_tpu_torch.host.ring import models as M
from latticeum_tpu_torch.host.ring import ref_impl as R

ALL = [M.BABYBEAR, M.FROG, M.STARK, M.GOLDILOCKS]
IDS = [m.name for m in ALL]


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_root_tables_are_powers(m):
    g = m.slot_roots[0]
    order = {"babybear": 24, "frog": 8, "stark_prime": 32,
             "goldilocks": 24}[m.name]
    assert pow(g, order, m.p) == 1
    assert pow(g, order // 2, m.p) == m.p - 1


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_slot_roots_satisfy_cyclotomic(m):
    for r in m.slot_roots:
        val = (pow(r, m.N, m.p) - m.mid * pow(r, m.N // 2, m.p) + 1) % m.p
        assert val == 0, (m.name, r)


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_crt_is_ring_homomorphism(m):
    rng = np.random.default_rng(42)
    a, b = m.rand(rng), m.rand(rng)
    assert m.poly_mul(a, b) == m.ntt_mul(a, b)


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_icrt_inverts_crt(m):
    rng = np.random.default_rng(7)
    a = m.rand(rng)
    assert m.icrt(m.crt(a)) == [v % m.p for v in a]


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_reduce_matches_mod(m):
    e = [0] * (m.D + 1)
    e[m.D] = 1
    expect = [0] * m.D
    expect[0] = (-1) % m.p
    if m.mid:
        expect[m.D // 2] = m.mid % m.p
    assert m.reduce(e) == expect


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_balanced_decompose_roundtrip(m):
    rng = np.random.default_rng(3)
    a = m.rand(rng)
    b, L = 1 << 8, (m.p.bit_length() + 7) // 8 + 1
    digs = m.decompose_balanced(a, b, L)
    assert m.recompose(digs, b) == [v % m.p for v in a]
    half = m.p // 2
    for dig in digs:
        for v in dig:
            lifted = v - m.p if v > half else v
            assert -b // 2 <= lifted <= b // 2


def test_goldilocks_model_matches_production_ring():
    rng = np.random.default_rng(11)
    a, b = M.GOLDILOCKS.rand(rng), M.GOLDILOCKS.rand(rng)
    assert (M.GOLDILOCKS.ntt_mul(a, b)
            == R.icrt(R.ntt_mul(R.crt(list(a)), R.crt(list(b)))))


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_crt_h_ring_isomorphism(m):
    if not m.has_hom:
        pytest.skip(f"{m.name}: no homogenization (documented gap)")
    rng = np.random.default_rng(11)
    a, b = m.rand(rng), m.rand(rng)
    assert m.icrt_h(m.crt_h(a)) == [v % m.p for v in a]
    assert m.poly_mul(a, b) == m.icrt_h(m.slot_mul_h(m.crt_h(a), m.crt_h(b)))


@pytest.mark.parametrize("m", ALL, ids=IDS)
def test_model_matches_jax(m):
    """The copy's constants, root tables and maps equal the original's."""
    theirs = M_jax.MODELS[m.name]
    for key in ("p", "D", "N", "d", "mid", "slot_roots", "has_hom"):
        assert getattr(m, key) == getattr(theirs, key), key
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    a, b = m.rand(rng_a), m.rand(rng_a)
    assert (a, b) == (theirs.rand(rng_b), theirs.rand(rng_b))
    assert m.crt(a) == theirs.crt(a)
    assert m.ntt_mul(a, b) == theirs.ntt_mul(a, b)
    if m.has_hom:
        assert m.crt_h(a) == theirs.crt_h(a)
