"""Torch ring ops (CRT/ICRT, slot-wise products, gadget decomposition)
against the JAX package's ring code under numpy, the Python-int reference
(ring/ref_impl.py) and the reference golden CRT vector.  Exact equality."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import goldilocks as gl_ref
from latticeum_tpu.ring import decompose as dc_ref, ref_impl as R, rq as rq_ref
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.ring import decompose as dc, rq
from test_ring import GOLDEN_NTT, GOLDEN_POLY

P = gl.P


def rand_rings(n, seed, shape=()):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, P, shape + (n, 24), dtype=np.uint64)
    return u


def t(u):
    return torch.from_numpy(gl.to_i64_bits(u))


def ref(u):
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def same(x, limbs):
    u = np.asarray(limbs[0]).astype(np.uint64) | (
        np.asarray(limbs[1]).astype(np.uint64) << np.uint64(32))
    return np.array_equal(gl.to_u64(x), u)


def test_crt_icrt_golden():
    assert gl.to_int_lists(rq.crt(gl.from_int([GOLDEN_POLY]))) == [GOLDEN_NTT]
    assert gl.to_int_lists(rq.icrt(gl.from_int([GOLDEN_NTT]))) == [GOLDEN_POLY]


@pytest.mark.parametrize("name", ["crt", "icrt"])
def test_crt_maps_match_reference(name):
    u = rand_rings(40, seed=1, shape=(2,))
    got = getattr(rq, name)(t(u))
    with B.numpy_mode():
        assert same(got, getattr(rq_ref, name)(ref(u)))
    oracle = getattr(R, name)
    assert gl.to_int_lists(got[0, :5]) == [oracle([int(v) for v in row])
                                            for row in u[0, :5]]


def test_ntt_mul_and_scalar_mul_match_reference():
    a, b = rand_rings(50, seed=2), rand_rings(50, seed=3)
    s = np.random.default_rng(4).integers(0, P, (50, 3), dtype=np.uint64)
    with B.numpy_mode():
        assert same(rq.ntt_mul(t(a), t(b)), rq_ref.ntt_mul(ref(a), ref(b)))
        s_ref = tuple(ref(s[:, c]) for c in range(3))
        assert same(rq.ntt_scalar_mul(t(a), tuple(t(s[:, c]) for c in range(3))),
                    rq_ref.ntt_scalar_mul(ref(a), s_ref))


def test_t_layout_products_match_reference():
    a = np.moveaxis(rand_rings(33, seed=5, shape=(3,)), -1, -2).copy()
    b = np.moveaxis(rand_rings(33, seed=6, shape=(3,)), -1, -2).copy()
    s = np.random.default_rng(7).integers(0, P, (3, 3), dtype=np.uint64)
    with B.numpy_mode():
        assert same(rq.ntt_mul_t(t(a), t(b)), rq_ref.ntt_mul_t(ref(a), ref(b)))
        assert same(
            rq.ntt_scalar_mul_t(t(a), tuple(t(s[:, c]) for c in range(3))),
            rq_ref.ntt_scalar_mul_t(ref(a), tuple(ref(s[:, c])
                                                  for c in range(3))))


@pytest.mark.parametrize("b,L", [(1 << 15, 5), (1 << 16, 4), (1024, 2)])
def test_gadget_decompose_and_recompose_match_reference(b, L):
    u = rand_rings(30, seed=b)
    u[:3] = np.array([0, 1, P - 1], dtype=np.uint64)[:, None]
    got = dc.gadget_decompose(t(u), b, L)
    with B.numpy_mode():
        assert same(got, dc_ref.gadget_decompose(ref(u), b, L))
        assert same(dc.gadget_recompose(got, b, L),
                    dc_ref.gadget_recompose(ref(gl.to_u64(got)), b, L))
    if b ** L >= P:
        assert np.array_equal(gl.to_u64(dc.gadget_recompose(got, b, L)), u)


@pytest.mark.parametrize("b,K", [(2, 15), (4, 8), (2, 10)])
def test_decompose_into_k_vecs_matches_reference(b, K):
    u = rand_rings(20, seed=K, shape=(2,))
    with B.numpy_mode():
        assert same(dc.decompose_vec_into_k_vecs(t(u), b, K),
                    dc_ref.decompose_vec_into_k_vecs(ref(u), b, K))


def test_decompose_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        dc.decompose_balanced(torch.zeros(3, dtype=torch.int64), 6, 2)


def test_ref_limbs_helper_round_trips():
    u = rand_rings(4, seed=9)
    assert np.array_equal(gl.to_u64(gl.from_limbs(ref(u))), u)
    assert np.array_equal(
        gl_ref.to_int(ref(u)).astype(np.uint64), u)


@pytest.mark.parametrize("name", ["poly_mul", "rot"])
def test_poly_mul_and_rot_match_reference(name):
    """The coefficient-form product and the multiplication by X against
    the JAX package's rq under numpy and the Python-int reference, with
    rows of zeros and of p - 1 among the first."""
    a, b = rand_rings(6, seed=7, shape=(2,)), rand_rings(6, seed=8, shape=(2,))
    a[0, 0], a[0, 1], b[0, :2] = 0, P - 1, P - 1
    if name == "poly_mul":
        got = rq.poly_mul(t(a), t(b))
        with B.numpy_mode():
            want = rq_ref.poly_mul(ref(a), ref(b))
        oracle = [R.poly_mul([int(v) for v in x], [int(v) for v in y])
                  for x, y in zip(a[0], b[0])]
    else:
        got = rq.rot(t(a))
        with B.numpy_mode():
            want = rq_ref.rot(ref(a))
        oracle = [R.rot([int(v) for v in x]) for x in a[0]]
    assert same(got, want)
    assert gl.to_int_lists(got[0]) == oracle
