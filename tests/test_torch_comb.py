"""The four comb kernels' plain-torch twins (what the wrappers run on CPU
tensors) against the Pallas kernels' own bodies run without pallas_call
(pallas_comb._accum_h / _lin_point under numpy) and against Python-int
oracles (the oracle_sums pattern of scripts/pallas_ab.py).

Tolerance: none; the sums are exact mod p.  A test marked `cuda` holds the
CUDA kernels against the twins; it needs a card and skips elsewhere."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import fq3 as fq3_ref, host as H
from latticeum_tpu.zkvm import pallas_comb as PC
from latticeum_tpu.zkvm.accel_rounds import _fold_t as ref_fold_t, _fq3_limbs
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.zkvm import comb

P = gl.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_ab():
    spec = importlib.util.spec_from_file_location(
        "pallas_ab", os.path.join(ROOT, "scripts", "pallas_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rnd(rng, *shape):
    return rng.integers(0, P, shape, dtype=np.uint64)


def limbs(u):
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def ints(pair):
    return (np.asarray(pair[0], np.uint64)
            | (np.asarray(pair[1], np.uint64) << np.uint64(32)))


def tt(u):
    return torch.from_numpy(gl.to_i64_bits(u))


def comps_c(x24):
    """(rows, 24, m) u64 -> the Pallas c-layout Fq3 comps of limb pairs."""
    r, _, m = x24.shape
    c = np.moveaxis(x24.reshape(r, 8, 3, m), 2, 1)
    return tuple(limbs(c[:, k]) for k in range(3))


def pallas_fold_sums(v0, v1, Tb, mu, b_small, pt0):
    """pallas_comb._accum_h on (v0, v1) halves, slot-major (npts, 24)."""
    npts = 2 * b_small
    slo = np.zeros((npts, 3, 8), np.uint32)
    shi = np.zeros((npts, 3, 8), np.uint32)
    with B.numpy_mode():
        v0_3, v1_3 = comps_c(v0), comps_c(v1)
        mu3 = tuple((limbs(mu[:, k])[0][:, None, None],
                     limbs(mu[:, k])[1][:, None, None]) for k in range(3))
        tb3 = tuple((x[0][0], x[1][0]) for x in comps_c(Tb[None]))
        PC._accum_h(v0_3, fq3_ref.sub(v1_3, v0_3), mu3, tb3,
                    PC._bsq_consts(b_small), pt0, npts, slo, shi)
    return np.moveaxis(ints((slo, shi)), 1, 2).reshape(npts, 24)


def pallas_lin_sums(v0, v1, Tc, S, signs, npts):
    """pallas_comb._lin_point per point (the _lin_accum fori body)."""
    out = np.zeros((npts, 24), np.uint64)
    with B.numpy_mode():
        f, f1 = comps_c(v0), comps_c(v1)
        step = fq3_ref.sub(f1, f)
        tc3 = tuple((x[0][0], x[1][0]) for x in comps_c(Tc[None]))
        for t in range(npts):
            qv = fq3_ref.mul(PC._lin_point(f, S, signs), tc3)
            s3 = [ints(PC._sum_axis_i32(qv[c], -1)) for c in range(3)]
            out[t] = np.stack(s3, axis=-1).reshape(24)
            f = fq3_ref.add(f, step)
    return out


def ref_fold(X, r3):
    with B.numpy_mode():
        return ints(ref_fold_t(limbs(X), _fq3_limbs(r3)))


def lin_oracle(X, Tc, S, signs, npts):
    """Python-int q(t) = sum_i sign_i prod_j f_t[j], Tc-weighted."""
    rows, _, m2 = X.shape
    q = m2 // 2
    out = [[0] * 24 for _ in range(npts)]
    for x in range(q):
        for t in range(npts):
            for s in range(8):
                f = []
                for j in range(rows):
                    v0 = tuple(int(X[j, 3 * s + c, x]) for c in range(3))
                    v1 = tuple(int(X[j, 3 * s + c, q + x]) for c in range(3))
                    st = H.fq3_sub(v1, v0)
                    f.append(H.fq3_add(v0, tuple(t * c % P for c in st)))
                acc = (0, 0, 0)
                for S_i, sg in zip(S, signs):
                    prod = (1, 0, 0)
                    for j in S_i:
                        prod = H.fq3_mul(prod, f[j])
                    acc = (H.fq3_add(acc, prod) if sg > 0
                           else H.fq3_sub(acc, prod))
                tc = tuple(int(Tc[3 * s + c, x]) for c in range(3))
                w = H.fq3_mul(acc, tc)
                for c in range(3):
                    out[t][3 * s + c] = (out[t][3 * s + c] + w[c]) % P
    return out


@pytest.mark.parametrize("b_small", [2, 4])
def test_fold_round0_twin_matches_pallas_body(b_small):
    rng = np.random.default_rng(b_small)
    rows, q = 5, 64
    X, Tb, mu = rnd(rng, rows, 24, 2 * q), rnd(rng, 24, q), rnd(rng, rows, 3)
    got = gl.to_u64(comb.fold_round0(tt(X), tt(Tb), tt(mu), b_small))
    want = pallas_fold_sums(X[..., :q], X[..., q:], Tb, mu, b_small, pt0=2)
    assert np.array_equal(got, want)
    assert not got[:2].any()                      # zero-skip of t = 0, 1


@pytest.mark.parametrize("b_small", [2, 4])
def test_fold_roundr_twin_matches_pallas_body(b_small):
    rng = np.random.default_rng(10 + b_small)
    rows, q = 4, 32
    X, Tb, mu = rnd(rng, rows, 24, 4 * q), rnd(rng, 24, q), rnd(rng, rows, 3)
    r3 = [int(v) for v in rnd(rng, 3)]
    S, F = comb.fold_roundr(tt(X), tt(Tb), tt(mu), r3, b_small)
    F_ref = ref_fold(X, r3)
    assert np.array_equal(gl.to_u64(F), F_ref)
    want = pallas_fold_sums(F_ref[..., :q], F_ref[..., q:], Tb, mu, b_small,
                            pt0=0)
    assert np.array_equal(gl.to_u64(S), want)


@pytest.mark.parametrize("pt0,b_small", [(2, 2), (0, 2), (2, 4)])
def test_fold_twin_matches_python_int_oracle(pt0, b_small):
    rng = np.random.default_rng(20 + pt0 + b_small)
    rows, q = 3, 4
    X, Tb, mu = rnd(rng, rows, 24, 2 * q), rnd(rng, 24, q), rnd(rng, rows, 3)
    want = _pallas_ab().oracle_sums(X, Tb, mu, pt0, b_small)
    got = comb._fold_sums_twin(tt(X), tt(Tb), tt(mu), b_small, pt0)
    got = gl.to_u64(got).astype(object)
    assert (got[pt0:] == want[pt0:]).all()
    assert not got[:pt0].any()


SETS = ([(0, 3, 5), (1,), (2, 4)], (1, -1, 1))
SETS7 = ([(0, 1, 2, 3, 4, 5, 6), (7, 7), (8,)], (-1, 1, -1))


@pytest.mark.parametrize("sets,npts", [(SETS, 4), (SETS7, 8), (SETS, 1)])
def test_lin_round0_twin_matches_pallas_body(sets, npts):
    S, signs = sets
    rows = max(j for s in S for j in s) + 1
    rng = np.random.default_rng(npts + rows)
    q = 32
    X, Tc = rnd(rng, rows, 24, 2 * q), rnd(rng, 24, q)
    ls = comb.lin_sets(S, signs, rows, "cpu")
    got = gl.to_u64(comb.lin_round0(tt(X), tt(Tc), ls, npts))
    want = pallas_lin_sums(X[..., :q], X[..., q:], Tc, S, signs, npts)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("sets,npts", [(SETS, 4), (SETS7, 8)])
def test_lin_roundr_twin_matches_pallas_body(sets, npts):
    S, signs = sets
    rows = max(j for s in S for j in s) + 1
    rng = np.random.default_rng(30 + npts)
    q = 16
    X, Tc = rnd(rng, rows, 24, 4 * q), rnd(rng, 24, q)
    r3 = [int(v) for v in rnd(rng, 3)]
    ls = comb.lin_sets(S, signs, rows, "cpu")
    Sq, F = comb.lin_roundr(tt(X), tt(Tc), r3, ls, npts)
    F_ref = ref_fold(X, r3)
    assert np.array_equal(gl.to_u64(F), F_ref)
    want = pallas_lin_sums(F_ref[..., :q], F_ref[..., q:], Tc, S, signs, npts)
    assert np.array_equal(gl.to_u64(Sq), want)


def test_lin_twin_matches_python_int_oracle():
    S, signs = SETS
    rng = np.random.default_rng(40)
    X, Tc = rnd(rng, 6, 24, 4), rnd(rng, 24, 2)
    ls = comb.lin_sets(S, signs, 6, "cpu")
    got = gl.to_int_lists(comb.lin_round0(tt(X), tt(Tc), ls, 3))
    assert got == lin_oracle(X, Tc, S, signs, 3)


def test_wrappers_validate_their_arguments():
    X = torch.zeros((3, 24, 8), dtype=torch.int64)
    mu = torch.zeros((3, 3), dtype=torch.int64)
    with pytest.raises(ValueError):
        comb.fold_round0(X, torch.zeros((24, 3), dtype=torch.int64), mu, 2)
    with pytest.raises(TypeError):
        comb.fold_round0(X.to(torch.int32), torch.zeros((24, 4),
                                                        dtype=torch.int32),
                         mu, 2)
    with pytest.raises(ValueError):
        comb.fold_round0(X, torch.zeros((24, 4), dtype=torch.int64), mu, 5)
    with pytest.raises(ValueError):
        comb.lin_sets([(0,), (1,)], (1, 2), 2, "cpu")
    with pytest.raises(ValueError):
        comb.lin_sets([(0,)], (1,), 2, "cpu")       # row 1 never folded
    with pytest.raises(ValueError):
        comb.fold_round0(torch.zeros((3, 24, 8), dtype=torch.int64,
                                     device="meta"),
                         torch.zeros((24, 4), dtype=torch.int64,
                                     device="meta"),
                         torch.zeros((3, 3), dtype=torch.int64,
                                     device="meta"), 2)


def test_cpu_tensors_run_the_twin_without_counting_launches():
    comb.reset_launches()
    rng = np.random.default_rng(50)
    X, Tb, mu = rnd(rng, 2, 24, 8), rnd(rng, 24, 4), rnd(rng, 2, 3)
    comb.fold_round0(tt(X), tt(Tb), tt(mu), 2)
    assert all(w.launches == 0 for w in comb.WRAPPERS)


@pytest.mark.cuda
def test_cuda_kernels_match_twins():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(60)
    dev = "cuda"

    def d(u):
        return tt(u).to(dev)
    for b_small in (1, 2, 3, 4):
        X, Tb, mu = rnd(rng, 6, 24, 1024), rnd(rng, 24, 512), rnd(rng, 6, 3)
        args = (d(X), d(Tb), d(mu), b_small)
        assert torch.equal(comb.fold_round0(*args),
                           comb.fold_round0_twin(*args))
        X = rnd(rng, 6, 24, 2048)
        args = (d(X), d(Tb), d(mu), [int(v) for v in rnd(rng, 3)], b_small)
        for a, b in zip(comb.fold_roundr(*args), comb.fold_roundr_twin(*args)):
            assert torch.equal(a, b)
    S, signs = SETS7
    ls = comb.lin_sets(S, signs, 9, dev)
    for npts in (1, 8, 12):
        X, Tc = rnd(rng, 9, 24, 1024), rnd(rng, 24, 512)
        args = (d(X), d(Tc), ls, npts)
        assert torch.equal(comb.lin_round0(*args), comb.lin_round0_twin(*args))
        X = rnd(rng, 9, 24, 2048)
        args = (d(X), d(Tc), [int(v) for v in rnd(rng, 3)], ls, npts)
        for a, b in zip(comb.lin_roundr(*args), comb.lin_roundr_twin(*args)):
            assert torch.equal(a, b)
