"""The four comb kernels' plain-torch twins (what the wrappers run on CPU
tensors) against the Pallas kernels' own bodies run without pallas_call
(pallas_comb._accum_h / _lin_point under numpy) and against Python-int
oracles (the oracle_sums pattern of scripts/pallas_ab.py); the fold
round's c pass (fold_c_round, pair_sum, fold_c_end) against the XLA half
of the JAX package's fold round (accel_rounds._fold_t, _pair_sum and the
ntt_mul_t sums of _make_round_pallas) under numpy.

Tolerance: none; the sums are exact mod p.  A test marked `cuda` holds the
CUDA kernels against the twins; it needs a card and skips elsewhere."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import fq3 as fq3_ref, host as H
from latticeum_tpu.zkvm import pallas_comb as PC
from latticeum_tpu.field import goldilocks as gl_ref
from latticeum_tpu.ring import rq as rq_ref
from latticeum_tpu.zkvm.accel_rounds import (_fold_t as ref_fold_t,
                                             _fq3_limbs,
                                             _pair_sum as ref_pair_sum)
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.zkvm import comb

P = gl.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_ab():
    return _script("pallas_ab")


TRIALS = _script("fold_c_trials")
COMB_CU = os.path.join(ROOT, "latticeum_tpu_torch", "csrc", "comb.cu")
RECON_TRIALS = _script("recon_trials")
RECON_CU = os.path.join(ROOT, "latticeum_tpu_torch", "csrc", "recon.cu")


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
    """Python-int q(t) = sum_i c_i prod_j f_t[j], Tc-weighted; c_i a +-1
    sign or a ring (24 slot-major values)."""
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
                    if isinstance(sg, int):
                        acc = (H.fq3_add(acc, prod) if sg > 0
                               else H.fq3_sub(acc, prod))
                    else:
                        acc = H.fq3_add(acc, H.fq3_mul(prod, tuple(
                            int(sg[3 * s + c]) for c in range(3))))
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
    S, F = comb.fold_roundr(tt(X), tt(Tb), tt(mu), tt(np.array(r3, np.uint64)),
                            b_small)
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
    Sq, F = comb.lin_roundr(tt(X), tt(Tc), tt(np.array(r3, np.uint64)), ls,
                            npts)
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


def rings(rng, n):
    return [[int(v) for v in rnd(rng, 24)] for _ in range(n)]


def test_lin_twin_with_ring_constants_matches_python_int_oracle():
    S, _ = SETS
    rng = np.random.default_rng(41)
    X, Tc, c = rnd(rng, 6, 24, 4), rnd(rng, 24, 2), rings(rng, len(S))
    ls = comb.lin_sets_general(S, c, 6, "cpu")
    got = gl.to_int_lists(comb.lin_round0(tt(X), tt(Tc), ls, 3))
    assert got == lin_oracle(X, Tc, S, c, 3)


@pytest.mark.parametrize("sets,npts", [(SETS, 4), (SETS7, 8)])
def test_lin_ring_constants_of_signs_match_the_signed_twins(sets, npts):
    """Rings that are the +-1 scalars give the signed sums, in round 0 and
    round r."""
    S, signs = sets
    rows = max(j for s in S for j in s) + 1
    ring = {1: [1, 0, 0] * 8, -1: [P - 1, 0, 0] * 8}
    signed = comb.lin_sets(S, signs, rows, "cpu")
    general = comb.lin_sets_general(S, [ring[g] for g in signs], rows, "cpu")
    rng = np.random.default_rng(42 + npts)
    q = 16
    X, Tc = tt(rnd(rng, rows, 24, 4 * q)), tt(rnd(rng, 24, q))
    r3 = tt(rnd(rng, 3))
    X0 = X[..., :2 * q].contiguous()
    assert torch.equal(comb.lin_round0(X0, Tc, signed, npts),
                       comb.lin_round0(X0, Tc, general, npts))
    for a, b in zip(comb.lin_roundr(X, Tc, r3, signed, npts),
                    comb.lin_roundr(X, Tc, r3, general, npts)):
        assert torch.equal(a, b)


def test_lin_sets_general_validates_its_arguments():
    rng = np.random.default_rng(43)
    with pytest.raises(ValueError):
        comb.lin_sets_general([(0,), (1,)], rings(rng, 1), 2, "cpu")
    with pytest.raises(ValueError):
        comb.lin_sets_general([(0,), (1,)], [[1] * 23, [1] * 24], 2, "cpu")
    with pytest.raises(ValueError):
        comb.lin_sets_general([(0,)], rings(rng, 1), 2, "cpu")
    ls = comb.lin_sets_general([(0,), (1,)], rings(rng, 2), 2, "cpu")
    ls.sgn = torch.ones(2, dtype=torch.int32)          # signs and rings both
    X = torch.zeros((2, 24, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        comb.lin_round0(X, torch.zeros((24, 4), dtype=torch.int64), ls, 2)


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


# -- the lin reconstruction rounds ----------------------------------------------

def recon_oracle(X, S, consts, npts, scale):
    """Python-int sums of one reconstruction round over X (rows + 1, 24,
    2q): S[t] = sum_x scale * e_t * sum_i c_i prod_{j in S_i} f_t[j], the
    eq row (the last) extended to point t like the Mz rows."""
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
                for S_i, sg in zip(S, consts):
                    prod = (1, 0, 0)
                    for j in S_i:
                        prod = H.fq3_mul(prod, f[j])
                    if isinstance(sg, int):
                        acc = (H.fq3_add(acc, prod) if sg > 0
                               else H.fq3_sub(acc, prod))
                    else:
                        acc = H.fq3_add(acc, H.fq3_mul(prod, tuple(
                            int(sg[3 * s + c]) for c in range(3))))
                w = H.fq3_mul(H.fq3_mul(acc, f[-1]), scale)
                for c in range(3):
                    out[t][3 * s + c] = (out[t][3 * s + c] + w[c]) % P
    return out


def fold_oracle(X, r3):
    """Python-int fold of X (rows, 24, 2w) at r3 -> (rows, 24, w) ints."""
    rows, _, w2 = X.shape
    w = w2 // 2
    out = np.zeros((rows, 24, w), dtype=object)
    for j in range(rows):
        for s in range(8):
            for x in range(w):
                a = tuple(int(X[j, 3 * s + c, x]) for c in range(3))
                b = tuple(int(X[j, 3 * s + c, w + x]) for c in range(3))
                v = H.fq3_add(a, H.fq3_mul(r3, H.fq3_sub(b, a)))
                out[j, 3 * s:3 * s + 3, x] = v
    return out


@pytest.mark.parametrize("kind", ["signs", "rings"])
@pytest.mark.parametrize("fold", [False, True])
def test_lin_recon_round_twin_matches_python_int_oracle(kind, fold):
    """One reconstruction round (the first, or a later one with its fold
    of the previous challenge) against Python ints, with +-1 signs and
    with ring constants; a row of p - 1 among the inputs."""
    S, signs = SETS
    rng = np.random.default_rng(70 + fold + 2 * (kind == "rings"))
    consts = signs if kind == "signs" else rings(rng, len(S))
    ls = (comb.lin_sets(S, signs, 6, "cpu") if kind == "signs"
          else comb.lin_sets_general(S, consts, 6, "cpu"))
    q, npts = 2, 5
    X = rnd(rng, 7, 24, (4 if fold else 2) * q)
    X[2] = P - 1
    scale = tuple(int(v) for v in rnd(rng, 3))
    if fold:
        r3 = tuple(int(v) for v in rnd(rng, 3))
        S_t, F = comb.lin_recon_round_twin(tt(X), ls, npts, tt(np.array(
            scale, np.uint64)), tt(np.array(r3, np.uint64)))
        cur = fold_oracle(X, r3)
        assert gl.to_int_lists(F) == cur.tolist()
    else:
        S_t = comb.lin_recon_round_twin(tt(X), ls, npts,
                                        tt(np.array(scale, np.uint64)))
        cur = X
    assert gl.to_int_lists(S_t) == recon_oracle(cur, S, consts, npts, scale)


@pytest.mark.parametrize("scaled", [False, True])
def test_lin_recon_fold_twin_matches_python_int_oracle(scaled):
    """The fold alone into the first columns of a wider output (zero past
    them), the last row times the scale where given."""
    rng = np.random.default_rng(80 + scaled)
    X, r3 = rnd(rng, 4, 24, 4), tuple(int(v) for v in rnd(rng, 3))
    scale = tuple(int(v) for v in rnd(rng, 3)) if scaled else None
    out = torch.full((4, 24, 5), 7, dtype=torch.int64)
    comb.lin_recon_fold_twin(tt(X), tt(np.array(r3, np.uint64)), out,
                             None if scale is None else tt(np.array(
                                 scale, np.uint64)))
    want = fold_oracle(X, r3)
    if scaled:
        for s in range(8):
            for x in range(2):
                want[-1, 3 * s:3 * s + 3, x] = H.fq3_mul(
                    tuple(int(v) for v in want[-1, 3 * s:3 * s + 3, x]),
                    scale)
    assert gl.to_int_lists(out[..., :2]) == want.tolist()
    assert not out[..., 2:].any()


def old_lin_reconstruct(mz, nv, r, degree, sets, betas, scale, state,
                        pend0, msgs, chals):
    """The reconstruction tail as accel_rounds._lin_reconstruct ran it
    before lin_recon_tail: nine calls of the wrappers (their CPU routes),
    the fold, the eq table, each round and its round tail, the final
    fold."""
    from latticeum_tpu_torch.crypto import challenger
    from latticeum_tpu_torch.zkvm import tables
    t_rows, dev = mz.shape[0], mz.device
    rows = 1 << (nv - r)
    shape = (t_rows + 1, 24, rows)
    if r:
        cur = torch.empty(shape, dtype=gl.DTYPE, device=dev)
        comb.lin_recon_fold_twin(mz, chals[r - 1], cur[:t_rows])
    else:
        cur = torch.zeros(shape, dtype=gl.DTYPE, device=dev)
        cur[:t_rows, :, :1] = mz
    tables.eq_table(betas, rows, dev, t_layout=True, out=cur[t_rows])
    for k in range(r, nv):
        if k == r:
            msg = comb.lin_recon_round_twin(cur, sets, degree + 1, scale)
        else:
            msg, cur = comb.lin_recon_round_twin(cur, sets, degree + 1,
                                                 scale, chals[k - 1])
        challenger.round_tail(msg, None, None, None, state,
                              pend0 if k == 0 else chals[k - 1], msgs,
                              chals, k, weighted=False)
    final = torch.empty((t_rows + 1, 24, 1), dtype=gl.DTYPE, device=dev)
    comb.lin_recon_fold_twin(cur, chals[nv - 1], final, scale)
    return final[..., 0]


def tail_case(rng, S, signs, kind, t_rows, nv, r, npts, npend=5):
    """Random inputs of a reconstruction tail (rows of p - 1 among them):
    (mz, host betas, betas, scale, state, pend0, msgs, chals, sets)."""
    sets = (comb.lin_sets(S, signs, t_rows, "cpu") if kind == "signs"
            else comb.lin_sets_general(S, rings(rng, len(S)), t_rows, "cpu"))
    mz = rnd(rng, t_rows, 24, 2 if r else 1)
    mz[0] = P - 1
    betas = [tuple(int(v) for v in rnd(rng, 3)) for _ in range(nv - r)]
    betas[-1] = (P - 1,) * 3
    chals = rnd(rng, nv, 3)
    return (tt(mz), betas, tt(np.array(betas, np.uint64)), tt(rnd(rng, 3)),
            tt(rnd(rng, 16)), tt(rnd(rng, npend)),
            torch.zeros((nv, npts, 24), dtype=torch.int64), tt(chals), sets)


@pytest.mark.parametrize("rounds,npts,kind,r,t_rows", [
    (1, 1, "signs", 3, 9), (2, 12, "rings", 0, 9), (3, 9, "signs", 3, 9),
    (3, 9, "rings", 14, 9), (4, 5, "signs", 0, 9), (4, 7, "rings", 2, 9),
    (3, 9, "signs", 14, 125)])
def test_lin_recon_tail_twin_matches_the_old_sequence(rounds, npts, kind, r,
                                                      t_rows):
    """The tail's twin (what the wrapper runs on CPU tensors) against the
    nine calls it replaced, bit for bit: messages, challenges, challenger
    state and final rows, for 1 ... 4 rounds (tables of 2 ... 16
    columns), the first round at r = 0 (mz one column wide) or later (two
    columns, folded at chals[r - 1]), +-1 signs and ring constants, 1 ...
    12 points, a random scale, rows and a beta of p - 1; the last case
    the zkVM's 125 rows and 52 multisets at 9 points."""
    from latticeum_tpu_torch.parallel import lin_mesh
    S, signs = SETS7 if t_rows == 9 else lin_mesh._zkvm_S_c()[:2]
    rng = np.random.default_rng(100 + rounds + npts + r)
    nv = r + rounds
    mz, host_b, betas, scale, state, pend0, msgs, chals, sets = tail_case(
        rng, S, signs, kind, t_rows, nv, r, npts)
    old = [x.clone() for x in (state, msgs, chals)]
    want = old_lin_reconstruct(mz, nv, r, npts - 1, sets, host_b, scale,
                               *old[:1], pend0, *old[1:])
    comb.reset_launches()
    got = comb.lin_recon_tail(mz, betas, scale, state, pend0, msgs, chals,
                              sets, r)
    assert torch.equal(got, want)
    for a, b in zip((state, msgs, chals), old):
        assert torch.equal(a, b)
    assert comb.lin_recon_tail.launches == 0


def test_lin_recon_wrappers_validate_their_arguments():
    S, signs = SETS7
    rng = np.random.default_rng(96)
    mz, _, betas, scale, state, pend0, msgs, chals, sets = tail_case(
        rng, S, signs, "signs", 9, 6, 3, 5)
    z = lambda *s: torch.zeros(s, dtype=torch.int64)  # noqa: E731

    def call(**kw):
        args = dict(mz=mz, betas=betas, scale3=scale, state=state,
                    pend0=pend0, msgs=msgs, chals=chals, sets=sets, r=3)
        args.update(kw)
        return comb.lin_recon_tail(**args)
    call()
    with pytest.raises(ValueError):        # mz one column wide after r = 0
        call(mz=z(9, 24, 1))
    with pytest.raises(ValueError):        # and not two at r = 0
        call(r=0, betas=z(4, 3), msgs=z(4, 5, 24), chals=z(4, 3))
    with pytest.raises(ValueError):        # one beta a remaining round
        call(betas=z(2, 3))
    with pytest.raises(ValueError):        # the multisets' rows
        call(mz=z(8, 24, 2))
    with pytest.raises(ValueError):        # more points than instantiated
        call(msgs=z(6, comb.MAX_LIN_PTS + 1, 24))
    with pytest.raises(ValueError):        # more rounds than the table takes
        call(r=0, mz=z(9, 24, 1), betas=z(6, 3))
    with pytest.raises(ValueError):        # no round left
        call(r=6, betas=z(0, 3))
    with pytest.raises(ValueError):
        call(scale3=z(2))
    with pytest.raises(ValueError):
        call(state=z(15))
    with pytest.raises(ValueError):        # more pending values than taken
        call(pend0=z(12))
    with pytest.raises(ValueError):        # chals of another round count
        call(chals=z(5, 3))
    with pytest.raises(ValueError):        # the table outgrows shared memory
        big = comb.lin_sets(((0,),) * 2 + tuple((j,) for j in range(1, 1200)),
                            (1,) * 1201, 1200, "cpu")
        call(mz=z(1200, 24, 2), sets=big, msgs=z(8, 5, 24), chals=z(8, 3),
             betas=z(5, 3))
    with pytest.raises(TypeError):
        call(scale3=scale.to(torch.int32))


def test_recon_eq_table_is_the_host_doubling():
    """The reconstruction's eq row as tables.eq_table builds it (t-layout,
    2^k rows of the last k betas) is the JAX package's bit-reversed host
    doubling accel_t.build_eq_table_rev, transposed, bit for bit: for two
    proofs' betas (a call's own and a replayed earlier call's) and for
    betas of p - 1."""
    from latticeum_tpu.zkvm.accel_t import build_eq_table_rev
    from latticeum_tpu_torch.zkvm import tables
    rng = np.random.default_rng(90)
    own, replayed = ([tuple(int(v) for v in rnd(rng, 3)) for _ in range(17)]
                     for _ in range(2))
    for betas in (own, replayed, [(P - 1,) * 3] * 17):
        for k in (1, 3, 5):
            got = tables.eq_table(betas[17 - k:], 1 << k, "cpu",
                                  t_layout=True)
            with B.numpy_mode():
                want = ints(build_eq_table_rev(betas[17 - k:])).T
            assert np.array_equal(gl.to_u64(got), want)


def _lin_sumcheck_case(seed, nv, n0, kind, S=((0, 1, 2), (1,), (2, 2)),
                       signs=(1, -1, 1), recon_betas=None):
    """A truncated lin sum-check (its reconstruction rounds included) on
    the host (sumcheck.prove with the eq factored) and through the port's
    chained runner, with +-1 signs or ring constants; the port's run
    takes `recon_betas` for its reconstruction rounds where given (the
    host's does not)."""
    from latticeum_tpu.crypto.transcript import Transcript
    from latticeum_tpu.field import goldilocks as gl_ref
    from latticeum_tpu.nifs import linearization as lin
    from latticeum_tpu.poly import mle, sumcheck
    from latticeum_tpu.zkvm.accel_t import bitrev_indices
    from latticeum_tpu_torch.zkvm import accel_rounds
    t_rows = max(j for s_ in S for j in s_) + 1
    degree = max(len(s_) for s_ in S) + 1
    rng = np.random.default_rng(seed)
    consts = ([H.ntt_from_u64(1 if x > 0 else P - 1) for x in signs]
              if kind == "signs" else rings(rng, len(S)))
    beta = [tuple(int(v) for v in rnd(rng, 3)) for _ in range(nv)]
    mz = rnd(rng, t_rows, n0, 24)
    with B.numpy_mode():
        eq = mle.build_eq_table(beta, max_rows=n0)
        g = (np.concatenate([limbs(mz)[0], np.asarray(eq[0])[None]]),
             np.concatenate([limbs(mz)[1], np.asarray(eq[1])[None]]))
        c = gl_ref.from_int(np.array(consts, dtype=object))
        two = lin.make_comb_fn2(S)
        th = Transcript(record_samples=True)
        host = sumcheck.prove(th, g, nv, degree, lambda v: two(v, c),
                              eq_info=(beta, t_rows))
    brev = torch.from_numpy(bitrev_indices((n0 - 1).bit_length()))
    g_t = gl.from_limbs(g).transpose(1, 2)[..., brev].contiguous()
    sets = (comb.lin_sets(S, signs, t_rows, "cpu") if kind == "signs"
            else comb.lin_sets_general(S, consts, t_rows, "cpu"))
    td = Transcript(record_samples=True)
    port = accel_rounds.run_lin_rounds_factored(td, g_t, nv, degree, sets,
                                                beta, recon_betas)
    final = ints(host[2])[:, 0]
    return ((host[0], host[1], final.tolist(), th.export_for_device(),
             th.samples),
            (port[0], port[1], gl.to_int_lists(port[2]),
             td.export_for_device(), td.samples))


@pytest.mark.parametrize("nv,n0,kind", [(6, 8, "signs"), (6, 8, "rings"),
                                        (4, 1, "signs"), (5, 4, "rings")])
def test_lin_reconstruct_matches_host_sumcheck(nv, n0, kind):
    """The whole reconstruction tail (3, 4 or 3 rounds after 3, 0 or 2
    factored ones) inside the chained runner: its messages, challenges,
    finals and transcript equal the host sum-check's."""
    host, port = _lin_sumcheck_case(nv + n0, nv, n0, kind)
    assert port == host


def _count_tails(monkeypatch):
    """The first round r of each comb.lin_recon_tail call the runner makes
    (CPU routes included, which count no launch)."""
    from latticeum_tpu_torch.zkvm import accel_rounds
    calls = []
    real = comb.lin_recon_tail

    def counted(*args, **kwargs):
        calls.append(args[-1])
        return real(*args, **kwargs)
    monkeypatch.setattr(accel_rounds.comb, "lin_recon_tail", counted)
    return calls


@pytest.mark.parametrize("nv,n0,kind", [(6, 8, "signs"), (6, 8, "rings"),
                                        (5, 1, "signs")])
def test_lin_recon_tail_at_the_zkvm_shape_matches_host_sumcheck(
        nv, n0, kind, monkeypatch):
    """The port's truncated lin sum-check with the zkVM's 125 Mz rows and
    52 multisets (degree 8, 9 message points) against the JAX package's
    numpy host sum-check (sumcheck.prove with eq_info): proof,
    challenges, finals, transcript state and samples.  At n0 = 8, 3
    factored rounds, then the main path's 3 reconstruction rounds in one
    comb.lin_recon_tail call; at n0 = 1 all 5 rounds in it."""
    from latticeum_tpu_torch.parallel import lin_mesh
    S, signs, _ = lin_mesh._zkvm_S_c()
    calls = _count_tails(monkeypatch)
    host, port = _lin_sumcheck_case(nv + n0, nv, n0, kind, S, signs)
    assert port == host
    assert calls == [3 if n0 == 8 else 0]


@pytest.mark.parametrize("nv,n0,kind", [(6, 8, "signs"), (6, 8, "rings"),
                                        (4, 1, "rings")])
def test_recon_betas_route_through_the_tail_matches_the_old_route(
        nv, n0, kind, monkeypatch):
    """The C.h9 replay's route (recon_betas: another proof's betas in the
    reconstruction rounds, scaled by _eqf_product of them over the
    factored rounds' challenges) through comb.lin_recon_tail gives the
    proof, challenges, finals and transcript of the same run through the
    nine calls the tail replaced; and both differ from the host sum-check,
    which uses the proof's own betas."""
    from latticeum_tpu_torch.zkvm import accel_rounds
    rng = np.random.default_rng(nv + n0 + 7)
    stale = [tuple(int(v) for v in rnd(rng, 3)) for _ in range(nv)]
    calls = _count_tails(monkeypatch)
    host, tail = _lin_sumcheck_case(nv + n0, nv, n0, kind,
                                    recon_betas=stale)
    assert calls == [accel_rounds._factored_rounds(n0, nv)]

    def old(mz, r, sets, betas, scale, state, pend0, msgs, chals):
        return old_lin_reconstruct(mz, msgs.shape[0], r, msgs.shape[1] - 1,
                                   sets, betas, scale, state, pend0, msgs,
                                   chals)
    monkeypatch.setattr(accel_rounds, "_lin_reconstruct", old)
    _, before = _lin_sumcheck_case(nv + n0, nv, n0, kind, recon_betas=stale)
    assert len(calls) == 1
    assert tail == before
    assert tail[0] != host[0]


@pytest.mark.parametrize("name", list(RECON_TRIALS.VARIANTS))
def test_recon_trials_variant_rewrites_recon_cu(name):
    """scripts/recon_trials.py builds each design variant from a copy of
    csrc/recon.cu: each rewrite finds its text exactly once, and the
    kernel's own variant is the source as it is."""
    with open(RECON_CU) as f:
        src = f.read()
    rewrites, _ = RECON_TRIALS.VARIANTS[name]
    out = RECON_TRIALS.variant_source(src, rewrites)
    assert (out == src) == (not rewrites)
    for _, new in rewrites:
        assert new in out


def test_recon_trials_rewrite_must_find_its_text():
    with open(RECON_CU) as f:
        src = f.read()
    with pytest.raises(RuntimeError):
        RECON_TRIALS.variant_source(src, (("no such line", "x"),))


@pytest.mark.cuda
def test_cuda_lin_recon_tail_matches_twin():
    """The reconstruction tail's kernel against its twin on the card at
    every point count 1 ... 12, each with signs and with rings, over 1 ...
    5 rounds (tables of 2 ... 32 columns) in turn, the first round at r =
    0 and after factored rounds in turn, with rows and a beta of p - 1,
    and at the zkVM's 125 rows and 52 multisets: messages, challenges,
    state and final rows.  (The twin's challenger takes about a second a
    round on the card, so the cases are dealt, not crossed.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from latticeum_tpu_torch.parallel import lin_mesh
    rng = np.random.default_rng(95)
    S, signs = SETS7
    zS, zsigns, zt = lin_mesh._zkvm_S_c()
    cases = [(S, signs, 9, kind, 1 + (npts + (kind == "rings")) %
              comb.MAX_RECON_ROUNDS, npts, 3 * (npts % 2))
             for kind in ("signs", "rings") for npts in range(1, 13)]
    cases += [(zS, zsigns, zt, kind, 3, 9, 14) for kind in ("signs", "rings")]
    comb.reset_launches()
    for S_, signs_, t_rows, kind, rounds, npts, r in cases:
        x = tail_case(rng, S_, signs_, kind, t_rows, r + rounds, r, npts)
        mz, _, betas, scale, state, pend0, msgs, chals, sets = x
        sets = (comb.lin_sets(S_, signs_, t_rows, "cuda") if kind == "signs"
                else comb.lin_sets_general(S_, gl.to_int_lists(
                    sets.rings), t_rows, "cuda"))
        dev = [t.cuda() for t in (mz, betas, scale, state, pend0, msgs,
                                  chals)]
        twin = [t.clone() for t in dev]
        got = comb.lin_recon_tail(*dev, sets, r)
        want = comb.lin_recon_tail_twin(*twin, sets, r)
        torch.cuda.synchronize()
        where = (t_rows, kind, rounds, npts, r)
        assert torch.equal(got, want), where
        for a, b in zip(dev[3:], twin[3:]):
            assert torch.equal(a, b), where
    assert comb.lin_recon_tail.launches == len(cases)


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
        args = (d(X), d(Tb), d(mu), d(rnd(rng, 3)), b_small)
        for a, b in zip(comb.fold_roundr(*args), comb.fold_roundr_twin(*args)):
            assert torch.equal(a, b)
    S, signs = SETS7
    for ls in (comb.lin_sets(S, signs, 9, dev),
               comb.lin_sets_general(S, rings(rng, len(S)), 9, dev)):
        for npts in (1, 8, 12):
            X, Tc = rnd(rng, 9, 24, 1024), rnd(rng, 24, 512)
            args = (d(X), d(Tc), ls, npts)
            assert torch.equal(comb.lin_round0(*args),
                               comb.lin_round0_twin(*args))
            X = rnd(rng, 9, 24, 2048)
            args = (d(X), d(Tc), d(rnd(rng, 3)), ls, npts)
            for a, b in zip(comb.lin_roundr(*args),
                            comb.lin_roundr_twin(*args)):
                assert torch.equal(a, b)


# -- the fold round's c pass ------------------------------------------------------

def jax_c_round(c2r, eqs, r3):
    """The XLA half of accel_rounds._make_round_pallas under numpy: the c
    rows folded at r3 (where given), the eq pair sums, the four c sums."""
    with B.numpy_mode():
        c = limbs(c2r)
        if r3 is not None:
            c = ref_fold_t(c, _fq3_limbs(r3))
        half = int(c[0].shape[-1]) // 2
        Tn = ref_pair_sum(limbs(eqs))
        Tr = (Tn[0][:2], Tn[1][:2])
        sums = [gl_ref.sum_axis(rq_ref.ntt_mul_t(
            Tr, (c[0][..., sl], c[1][..., sl])), axis=-1)
            for sl in (slice(None, half), slice(half, None))]
        return (ints(c), ints(Tn),
                np.concatenate([ints(x) for x in sums]))


def head_views(rng, w):
    """A fold head (5, 24, w) with rows of p - 1, and its interleaved c
    and eq views (row-strided, as the first round reads them)."""
    head = rnd(rng, 5, 24, w)
    head[1, :, :2] = P - 1
    head[4] = P - 1
    h = tt(head)
    return head, h[1:4:2], h[0::2]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("w", [2, 8, 64])
def test_fold_c_round_twin_matches_jax(fold, w):
    rng = np.random.default_rng(70 + w + fold)
    head, c2r, eqs = head_views(rng, w)
    c_u64 = head[1:4:2]
    r3 = None
    if fold:
        c_u64 = rnd(rng, 2, 24, 2 * w)
        c2r = tt(c_u64)
        r3 = [int(v) for v in rnd(rng, 3)]
    sums = torch.full((4, 24), 5, dtype=torch.int64)
    c, Tn = comb.fold_c_round(c2r, eqs, None if r3 is None else
                              tt(np.array(r3, np.uint64)), sums)
    want_c, want_tn, want_sums = jax_c_round(c_u64, head[0::2], r3)
    assert np.array_equal(gl.to_u64(c), want_c)
    assert np.array_equal(gl.to_u64(Tn), want_tn)
    assert np.array_equal(gl.to_u64(sums), want_sums)


@pytest.mark.parametrize("name", list(TRIALS.VARIANTS))
def test_fold_c_trials_variant_rewrites_comb_cu(name):
    """scripts/fold_c_trials.py builds each design variant from a copy of
    csrc/comb.cu: each rewrite changes one line, its constant's (or the
    line that chooses the TMA path), the others keep the kernel's values,
    and the cluster probe is appended."""
    with open(COMB_CU) as f:
        src = f.read()
    rewrites = TRIALS.VARIANTS[name]
    out = TRIALS.variant_source(src, rewrites)
    assert out.endswith(TRIALS.CLUSTERS_SRC)
    body = out[:-len(TRIALS.CLUSTERS_SRC)]
    for const in ("FC_CLUSTER", "FC_TW", "FC_STAGES"):
        pattern = rf"^#define {const} (\d+)"
        (kernel,) = re.findall(pattern, src, flags=re.M)
        assert re.findall(pattern, body, flags=re.M) == [
            str(rewrites.get(const, kernel))]
    assert ("const bool bulk = false &&" in body) == ("bulk" in rewrites)
    old, new = src.splitlines(), body.splitlines()
    assert len(old) == len(new)
    assert sum(a != b for a, b in zip(old, new)) == len(rewrites)


def test_fold_c_trials_rewrite_must_find_its_line():
    with open(COMB_CU) as f:
        src = f.read()
    with pytest.raises(RuntimeError):
        TRIALS.variant_source(src, {"FC_NOT_A_CONSTANT": 1})


@pytest.mark.parametrize("shape", [(24, 2), (24, 16), (3, 24, 8)])
def test_pair_sum_matches_jax(shape):
    rng = np.random.default_rng(80 + shape[-1])
    x = rnd(rng, *shape)
    x[..., 0] = P - 1
    got = comb.pair_sum(tt(x))
    with B.numpy_mode():
        want = ints(ref_pair_sum(limbs(x)))
    assert np.array_equal(gl.to_u64(got), want)
    assert got.shape == shape[:-1] + (shape[-1] // 2,)


@pytest.mark.parametrize("w", [1, 4])
def test_fold_c_end_twin_matches_jax(w):
    rng = np.random.default_rng(90 + w)
    c2r, eqs, t_s = rnd(rng, 2, 24, 2 * w), rnd(rng, 3, 24, w), \
        rnd(rng, 6, 24, 2 * w)
    eqs[0] = P - 1
    r3, E = [int(v) for v in rnd(rng, 3)], rnd(rng, 3, 3)
    got = comb.fold_c_end(tt(c2r), tt(eqs), tt(t_s),
                          tt(np.array(r3, np.uint64)), tt(E))
    cf, tf = ref_fold(c2r, r3), ref_fold(t_s, r3)
    with B.numpy_mode():
        eqr = [ints(rq_ref.ntt_scalar_mul_t(
            limbs(eqs[i]), _fq3_limbs(E[i]))) for i in range(3)]
    want = np.concatenate([np.stack([eqr[0], cf[0], eqr[1], cf[1], eqr[2]]),
                           tf])
    assert np.array_equal(gl.to_u64(got), want)


def test_fold_c_wrappers_validate_their_arguments():
    eqs = torch.zeros((3, 24, 8), dtype=torch.int64)
    sums = torch.zeros((4, 24), dtype=torch.int64)
    with pytest.raises(ValueError):          # c rows of the wrong width
        comb.fold_c_round(torch.zeros((2, 24, 4), dtype=torch.int64), eqs,
                          None, sums)
    with pytest.raises(ValueError):          # unfolded c rows twice as wide
        comb.fold_c_round(torch.zeros((2, 24, 8), dtype=torch.int64), eqs,
                          torch.zeros(3, dtype=torch.int64), sums)
    with pytest.raises(ValueError):          # rows not contiguous
        comb.fold_c_round(torch.zeros((2, 24, 16), dtype=torch.int64)[..., ::2],
                          eqs, None, sums)
    with pytest.raises(ValueError):
        comb.pair_sum(torch.zeros((24, 3), dtype=torch.int64))
    with pytest.raises(TypeError):
        comb.pair_sum(torch.zeros((24, 4), dtype=torch.int32))
    with pytest.raises(ValueError):          # E not (3, 3)
        comb.fold_c_end(torch.zeros((2, 24, 2), dtype=torch.int64),
                        eqs[..., :1].contiguous(),
                        torch.zeros((4, 24, 2), dtype=torch.int64),
                        torch.zeros(3, dtype=torch.int64),
                        torch.zeros((3,), dtype=torch.int64))
    comb.reset_launches()
    comb.pair_sum(torch.zeros((24, 4), dtype=torch.int64))
    assert comb.fold_c_round.launches == 0      # the twin ran


@pytest.mark.cuda
def test_cuda_fold_c_matches_twins():
    """fold_c_round (first round on the head's interleaved rows, folded
    rounds, one and several column blocks, widths where the grid stops at
    FC_MAX_BX blocks a slot), pair_sum (one row, three rows) and
    fold_c_end against their twins on the card, rows of p - 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(96)
    dev = "cuda"

    def d(u):
        return tt(u).to(dev)
    comb.reset_launches()
    calls = 0
    for w in (2, 4, 256, 1 << 12, 1 << 16):
        head = rnd(rng, 5, 24, w)
        head[1] = P - 1
        head[0, :, :w // 2] = P - 1
        hd = d(head)
        for fold in (False, True):
            c2r = d(rnd(rng, 2, 24, 2 * w)) if fold else hd[1:4:2]
            r3 = d(rnd(rng, 3)) if fold else None
            got_s = torch.zeros((4, 24), dtype=torch.int64, device=dev)
            want_s = got_s.clone()
            got = comb.fold_c_round(c2r, hd[0::2], r3, got_s)
            want = comb.fold_c_round_twin(c2r, hd[0::2], r3)
            calls += 1
            assert torch.equal(got[0], want[0]), (w, fold)
            assert torch.equal(got[1], want[1]), (w, fold)
            want_s.copy_(want[2])
            assert torch.equal(got_s, want_s), (w, fold)
        for x in (hd[0], hd[0::2]):
            assert torch.equal(comb.pair_sum(x), comb.pair_sum_twin(x))
            calls += 1
    for w in (1, 3):
        c2r, eqs = d(rnd(rng, 2, 24, 2 * w)), d(rnd(rng, 5, 24, w))[0::2]
        t_s, r3, E = d(rnd(rng, 90, 24, 2 * w)), d(rnd(rng, 3)), \
            d(rnd(rng, 3, 3))
        assert torch.equal(comb.fold_c_end(c2r, eqs, t_s, r3, E),
                           comb.fold_c_end_twin(c2r, eqs, t_s, r3, E))
        calls += 1
    assert comb.fold_c_round.launches == calls


@pytest.mark.cuda
def test_cuda_fold_c_round_on_two_streams():
    """Two fold_c_round launches in flight at once, on two streams (round
    0 at w = 2^17 on the head's strided rows and a folded round at 2^16,
    each a full grid), eight times over, each against its twin: no state
    is shared between launches (ROADMAP C.h10).  Both streams wait for a
    gate (a 1 ms spin on a third stream, so that the host has queued both
    launches when it opens); the second stream spins some 30 us more and
    has the higher priority, so its blocks are handed out while the first
    launch runs, before the rest of the first launch's.  The roles swap
    every time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(97)
    dev = "cuda"
    cases = []
    for w, fold in ((1 << 17, False), (1 << 16, True)):
        head = tt(rnd(rng, 5, 24, w)).to(dev)
        c2r = tt(rnd(rng, 2, 24, 2 * w)).to(dev) if fold else head[1:4:2]
        r3 = tt(rnd(rng, 3)).to(dev) if fold else None
        args = (c2r, head[0::2], r3)
        cases.append((args, comb.fold_c_round_twin(*args)))
    streams = (torch.cuda.Stream(priority=0), torch.cuda.Stream(priority=-1))
    gate = torch.cuda.Stream()
    comb.reset_launches()
    torch.cuda.synchronize()
    for rep in range(8):
        order = cases if rep % 2 == 0 else cases[::-1]
        with torch.cuda.stream(gate):
            torch.cuda._sleep(2_000_000)
        opened = torch.cuda.Event()
        opened.record(gate)
        outs = []
        for k, (stream, (args, want)) in enumerate(zip(streams, order)):
            with torch.cuda.stream(stream):
                stream.wait_event(opened)
                if k:
                    torch.cuda._sleep(60_000)
                sums = torch.empty((4, 24), dtype=torch.int64, device=dev)
                outs.append((comb.fold_c_round(*args, sums) + (sums,), want))
        torch.cuda.synchronize()
        for got, want in outs:
            for a, b in zip(got, want):
                assert torch.equal(a, b), rep
    assert comb.fold_c_round.launches == 16
