"""Torch Goldilocks and Fq3 arithmetic against the Python-int oracle
(field/host.py) and the JAX package's limb arithmetic under numpy.

Tolerance: none.  Field values are exact mod p, so every comparison is
integer equality."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import fq3 as fq3_ref, goldilocks as gl_ref
from latticeum_tpu.field import host as H
from latticeum_tpu_torch.field import fq3, goldilocks as gl

P = gl.P
BOUNDARY = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1,
            (1 << 64) - (1 << 32), 1 << 63, (1 << 63) - 1, 1 << 48]


def values(n, seed):
    rng = np.random.default_rng(seed)
    rand = [int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]
    pairs = [(a, b) for a in BOUNDARY for b in BOUNDARY]
    a = [x for x, _ in pairs] + rand
    b = [y for _, y in pairs] + rand[::-1]
    return [x % P for x in a], [y % P for y in b]


def ref_limbs(vals):
    with B.numpy_mode():
        return gl_ref.from_int(np.array(vals, dtype=object))


def ref_ints(limbs):
    return [int(v) for v in gl_ref.to_int(limbs).reshape(-1)]


BINARY = {
    "add": (gl.add, gl_ref.add, lambda x, y: (x + y) % P),
    "sub": (gl.sub, gl_ref.sub, lambda x, y: (x - y) % P),
    "mul": (gl.mul, gl_ref.mul, lambda x, y: x * y % P),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_matches_oracle_and_reference(op):
    mine, ref, oracle = BINARY[op]
    a, b = values(400, seed=1)
    got = gl.to_int_lists(mine(gl.from_int(a), gl.from_int(b)))
    assert got == [oracle(x, y) for x, y in zip(a, b)]
    with B.numpy_mode():
        assert got == ref_ints(ref(ref_limbs(a), ref_limbs(b)))


UNARY = {
    "neg": (gl.neg, lambda x: (-x) % P),
    "mul_2e40": (gl.mul_2e40, lambda x: (x << 40) % P),
}


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_op_matches_oracle(op):
    mine, oracle = UNARY[op]
    a, _ = values(400, seed=2)
    assert gl.to_int_lists(mine(gl.from_int(a))) == [oracle(x) for x in a]


@pytest.mark.parametrize("n", [1, 7, 4096])
def test_sum_axis_exact(n):
    a, _ = values(n * 3, seed=n)
    a = a[:n * 3]
    t = gl.from_int(a).reshape(3, -1)
    want = [sum(a[i * (len(a) // 3):(i + 1) * (len(a) // 3)]) % P
            for i in range(3)]
    assert gl.to_int_lists(gl.sum_axis(t, -1)) == want


def test_sum_axis_of_maximal_values():
    t = torch.full((1 << 16,), P - 1 - (1 << 64), dtype=torch.int64)
    assert gl.to_int_lists(gl.sum_axis(t, 0)) == (P - 1) * (1 << 16) % P


def test_segment_sum_exact():
    a, _ = values(2000, seed=3)
    seg = np.random.default_rng(4).integers(0, 9, len(a))
    want = [0] * 9
    for v, s in zip(a, seg):
        want[s] = (want[s] + v) % P
    got = gl.segment_sum(gl.from_int(a), torch.from_numpy(seg), 9)
    assert gl.to_int_lists(got) == want


def test_limb_and_int_conversions_round_trip():
    a, _ = values(300, seed=5)
    limbs = ref_limbs(a)
    t = gl.from_limbs(limbs)
    assert gl.to_int_lists(t) == a
    lo, hi = gl.to_limbs(t)
    np.testing.assert_array_equal(lo, limbs[0])
    np.testing.assert_array_equal(hi, limbs[1])
    assert gl.to_int_lists(gl.const(P + 5)) == 5


def fq3_values(n, seed):
    a, b = values(3 * n, seed)
    return ([tuple(a[3 * i:3 * i + 3]) for i in range(n)],
            [tuple(b[3 * i:3 * i + 3]) for i in range(n)])


def fq3_tensor(xs):
    return tuple(gl.from_int([x[c] for x in xs]) for c in range(3))


def fq3_ints(t):
    return [tuple(v) for v in zip(*(gl.to_int_lists(c) for c in t))]


FQ3 = {
    "add": (fq3.add, fq3_ref.add, H.fq3_add),
    "sub": (fq3.sub, fq3_ref.sub, H.fq3_sub),
    "mul": (fq3.mul, fq3_ref.mul, H.fq3_mul),
}


@pytest.mark.parametrize("op", sorted(FQ3))
def test_fq3_op_matches_oracle_and_reference(op):
    mine, ref, oracle = FQ3[op]
    a, b = fq3_values(200, seed=6)
    got = fq3_ints(mine(fq3_tensor(a), fq3_tensor(b)))
    assert got == [oracle(x, y) for x, y in zip(a, b)]
    with B.numpy_mode():
        r = ref(tuple(ref_limbs([x[c] for x in a]) for c in range(3)),
                tuple(ref_limbs([y[c] for y in b]) for c in range(3)))
        assert got == [tuple(v) for v in zip(*(ref_ints(c) for c in r))]


def test_fq3_square_and_const():
    a, _ = fq3_values(200, seed=7)
    assert fq3_ints(fq3.square(fq3_tensor(a))) == [H.fq3_mul(x, x) for x in a]
    assert fq3_ints(tuple(c[None] for c in fq3.const(a[0]))) == [a[0]]
