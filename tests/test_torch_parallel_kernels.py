"""The port's plain-torch array cores (latticeum_tpu_torch/parallel/
kernels.py) against latticeum_tpu/parallel/kernels.py under the JAX
backend on XLA:CPU, on the JAX package's rand_mles inputs from one numpy
seed.  Tolerance: none (integers mod p)."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import goldilocks as gl_ref
from latticeum_tpu.parallel import kernels as K_jax
from latticeum_tpu.poly import mle as mle_jax
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.parallel import kernels as K

SEED = 9


def inputs(k, n, seed=SEED):
    """JAX rand_mles limbs (numpy) and the same values as a port tensor."""
    with B.numpy_mode():
        lo, hi = K_jax.rand_mles(k, n, seed)
    return (np.asarray(lo), np.asarray(hi)), gl.from_limbs((lo, hi))


def jax_run(fn, *args):
    """fn under the JAX backend on numpy limb pairs -> u64 numpy."""
    with B.jax_mode():
        args = [tuple(B.xp.asarray(a) for a in x) if isinstance(x, tuple)
                else x for x in args]
        out = fn(*args)
    return gl_ref.to_int((np.asarray(out[0]), np.asarray(out[1]))).astype(
        np.uint64)


def same(x, u64):
    return np.array_equal(gl.to_u64(x), u64)


@pytest.mark.parametrize("degree", [1, 3])
def test_sumcheck_round_evals_matches_jax(degree):
    limbs, t = inputs(3, 8)
    want = jax_run(lambda m: K_jax.sumcheck_round_evals(
        m, degree, K_jax.product_comb), limbs)
    assert same(K.sumcheck_round_evals(t, degree, K.product_comb), want)


def test_fix_variable_dev_matches_jax():
    limbs, t = inputs(3, 8)
    r = (123456789, gl.P - 2, 1 << 40)
    with B.jax_mode():
        r_limbs = mle_jax.fq3_const(r)
    want = jax_run(lambda m: K_jax.fix_variable_dev(m, r_limbs), limbs)
    assert same(K.fix_variable_dev(t, gl.from_int(list(r))), want)


def test_ajtai_commit_kernel_matches_jax():
    mat_l, mat = inputs(4, 8)
    f_l, f = inputs(1, 8, SEED + 1)
    f_l = (f_l[0][0], f_l[1][0])
    want = jax_run(K_jax.ajtai_commit_kernel, mat_l, f_l)
    assert same(K.ajtai_commit_kernel(mat, f[0]), want)


def test_product_comb_matches_jax():
    limbs, t = inputs(4, 8)
    assert same(K.product_comb(t), jax_run(K_jax.product_comb, limbs))


def test_fold_step_core_matches_jax():
    m_l, m = inputs(3, 8)
    a_l, a = inputs(4, 8, SEED + 2)
    f_l, f = inputs(1, 8, SEED + 3)
    f_l = (f_l[0][0], f_l[1][0])
    with B.jax_mode():
        evals, cm = K_jax.fold_step_core(
            *(tuple(B.xp.asarray(x) for x in v) for v in (m_l, a_l, f_l)), 2)
    got = K.fold_step_core(m, a, f[0], 2)
    for x, y in zip(got, (evals, cm)):
        assert same(x, gl_ref.to_int((np.asarray(y[0]), np.asarray(y[1])))
                    .astype(np.uint64))


def test_rand_mles_canonical_and_seeded():
    """Every value below p, halves in range, the same values for the
    same generator seed, other values for another."""
    a = K.rand_mles(2, 64, torch.Generator().manual_seed(1))
    b = K.rand_mles(2, 64, torch.Generator().manual_seed(1))
    c = K.rand_mles(2, 64, torch.Generator().manual_seed(2))
    assert a.shape == (2, 64, 24) and a.dtype == gl.DTYPE
    assert torch.equal(a, b) and not torch.equal(a, c)
    u = gl.to_u64(a)
    assert (u < np.uint64(gl.P)).all()
    assert ((u >> np.uint64(32)) < np.uint64(0xFFFFFFFF)).all()
