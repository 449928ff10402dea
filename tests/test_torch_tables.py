"""The port's eq tables and fold-head alpha-pass (zkvm/tables.py, kernels
in csrc/tables.cu) against the JAX package.

* ``eq_table``: the twin (what a CPU tensor runs) against JAX
  ``DeviceEngine.eq_table`` on XLA:CPU and against the host
  ``poly/mle.build_eq_table``, over several point lengths and ``max_rows``
  truncations (skipped top variables folded into every row), in the
  standard layout and in the bit-reversed t-layout.
* ``head_alpha``: the twin plus the challenged-z COO part, i.e. the whole
  ``TorchNifs._build_head``, against JAX ``DeviceNifs._build_head`` on the
  ``nifs/test_fixtures.py`` shapes, with ring and with scalar matrix
  values; and the alpha-sums alone against a Python-int oracle.
* On the card (``cuda`` marker): each kernel against its twin on random
  canonical inputs with rows of p - 1.

Tolerance: none (exact integers)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import goldilocks as gl_ref, host as H
from latticeum_tpu.nifs.nifs import DecompositionParams
from latticeum_tpu.nifs.structs import TAU
from latticeum_tpu.nifs.test_fixtures import (TEST_B, TEST_B_SMALL, TEST_K,
                                              TEST_L, get_test_ccs)
from latticeum_tpu.poly import mle
from latticeum_tpu.zkvm.accel_t import bitrev_indices
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.zkvm import tables
from latticeum_tpu_torch.zkvm.accel import Engine
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs

PARAMS = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                             K=TEST_K)
P = gl.P
# (nv, max_rows): full tables, power-of-two and ragged truncations
EQ_CASES = [(0, None), (1, None), (3, None), (4, 16), (5, 5), (6, 64),
            (7, 32), (9, 100), (10, None)]


def rand_point(rng, nv):
    return [tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
            for _ in range(nv)]


def u64(limbs):
    return gl_ref.to_int((np.asarray(limbs[0]), np.asarray(limbs[1]))
                         ).astype(np.uint64)


def rand_u64(rng, *shape):
    return torch.from_numpy(gl.to_i64_bits(
        rng.integers(0, P, shape, dtype=np.uint64)))


@pytest.fixture(scope="module")
def jax_engine():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from latticeum_tpu.zkvm.accel import DeviceEngine
    ccs = get_test_ccs()
    return DeviceEngine(ccs, PARAMS)


def host_eq(point, max_rows):
    """The host MLE table; truncated, the kept variables' table times the
    skipped ones' prod(1 - r_j) (DeviceEngine.eq_table semantics)."""
    n_dbl, tail = tables.eq_shape(point, max_rows)
    with B.numpy_mode():
        tab = mle.build_eq_table(point[:n_dbl])
        tab = mle.rq.ntt_scalar_mul(tab, mle.fq3_const(tail))
    return u64(tab)


@pytest.mark.parametrize("t_layout", [False, True])
@pytest.mark.parametrize("nv,max_rows", EQ_CASES)
def test_eq_table_matches_jax_and_host(jax_engine, nv, max_rows, t_layout):
    rng = np.random.default_rng(100 * nv + (max_rows or 0))
    point = rand_point(rng, nv)
    got = gl.to_u64(Engine(get_test_ccs(), "cpu").eq_table(
        point, max_rows, t_layout=t_layout))
    want = u64(jax_engine.eq_table(point, max_rows))
    np.testing.assert_array_equal(host_eq(point, max_rows), want)
    if t_layout:
        want = want.T[:, bitrev_indices((want.shape[0] - 1).bit_length())]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_eq_table_writes_into_out_and_checks_its_shape():
    rng = np.random.default_rng(3)
    point = rand_point(rng, 5)
    head = torch.zeros((3, 24, 32), dtype=torch.int64)
    out = tables.eq_table(point, None, "cpu", t_layout=True, out=head[1])
    assert out.data_ptr() == head[1].data_ptr()
    assert torch.equal(head[1], tables.eq_table_twin(point, None, "cpu",
                                                     t_layout=True))
    assert not head[0].any() and not head[2].any()
    with pytest.raises(ValueError):
        tables.eq_table(point, None, "cpu", t_layout=False, out=head[1])


def test_eq_factors_are_the_layouts_bit_order():
    """Row j of the kernel's product is f[0] prod_k f[1 + 2k + bit_k(j)];
    the factor tables of the two layouts are each other's bit reversal."""
    rng = np.random.default_rng(4)
    point = rand_point(rng, 6)
    for t_layout in (False, True):
        f, n_dbl = tables.eq_factors(point, 16, t_layout)
        vals = gl.to_int_lists(f)
        assert n_dbl == 4 and len(vals) == 9
        assert tuple(vals[0]) == tables.eq_shape(point, 16)[1]
        for k in range(n_dbl):
            r = point[n_dbl - 1 - k if t_layout else k]
            assert tuple(vals[2 + 2 * k]) == r
            assert tuple(vals[1 + 2 * k]) == H.fq3_sub((1, 0, 0), r)


def test_brev_host_is_built_once_per_size():
    a = tables.brev_host(16)
    assert tables.brev_host(16) is a
    assert tables.brev_on(16, torch.device("cpu")) is a
    assert a.tolist() == bitrev_indices(4).tolist()


def test_head_alpha_matches_python_ints():
    rng = np.random.default_rng(6)
    half, m = 3, 5
    tail = rand_u64(rng, 2 * half, 24, m)
    alpha = rand_u64(rng, 2 * half, 3)
    c1 = torch.zeros((24, m), dtype=torch.int64)
    c2 = torch.zeros((24, m), dtype=torch.int64)
    tables.head_alpha(tail, alpha, c1, c2)
    t, a = gl.to_int_lists(tail), gl.to_int_lists(alpha)
    for out, lo in ((c1, 0), (c2, half)):
        want = [[0] * m for _ in range(24)]
        for s in range(8):
            for col in range(m):
                acc = (0, 0, 0)
                for idx in range(lo, lo + half):
                    v = tuple(t[idx][3 * s + c][col] for c in range(3))
                    acc = H.fq3_add(acc, H.fq3_mul(v, tuple(a[idx])))
                for c in range(3):
                    want[3 * s + c][col] = acc[c]
        assert gl.to_int_lists(out) == want


def test_head_alpha_checks_shapes():
    tail = torch.zeros((4, 24, 8), dtype=torch.int64)
    c = torch.zeros((24, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        tables.head_alpha(tail, torch.zeros((3, 3), dtype=torch.int64), c, c)
    with pytest.raises(ValueError):
        tables.head_alpha(tail[:3], torch.zeros((3, 3), dtype=torch.int64),
                          c, c)


def scalar_test_ccs():
    """The test CCS with its values (c, 0, 0) x 8 held as base-field
    scalars c (SparseScalarMatrix), the zkVM's kind of matrix."""
    from latticeum_tpu.nifs.structs import SparseScalarMatrix
    ccs = get_test_ccs()
    mats = []
    for M in ccs.M:
        c = u64(M.vals)[:, 0]
        mats.append(SparseScalarMatrix(
            M.nrows, M.ncols, M.rows, M.cols,
            ((c & np.uint64(0xFFFFFFFF)).astype(np.uint32),
             (c >> np.uint64(32)).astype(np.uint32))))
    return dataclasses.replace(ccs, M=mats)


@pytest.mark.parametrize("kind", ["ring", "scalar"])
def test_fold_head_matches_jax_build_head(jax_engine, kind):
    """TorchNifs._build_head (eq rows and alpha-sums by tables, the COO
    part by the CSR segment sums, Engine.mz_challenged) against
    DeviceNifs._build_head, on the test CCS (ring values) and on its
    scalar form, with random tail, z, alpha, zeta and points."""
    from latticeum_tpu.zkvm.accel import DeviceEngine
    from latticeum_tpu.zkvm.accel_nifs import DeviceNifs
    ccs = get_test_ccs() if kind == "ring" else scalar_test_ccs()
    if kind == "scalar":
        jax_engine = DeviceEngine(ccs, PARAMS)
    K, m = PARAMS.K, ccs.m
    rng = np.random.default_rng(8)
    tail = rand_u64(rng, 2 * K * TAU, 24, m)
    tail[0] = gl.P_I64 - 1                   # a row of p - 1
    zs = rand_u64(rng, 2 * K, ccs.n, 24)
    alpha_s, zeta_s = rand_point(rng, 2 * K), rand_point(rng, 2 * K)
    r1, r2, beta_s = (rand_point(rng, ccs.s) for _ in range(3))
    cm_i_s = [types.SimpleNamespace(r=[H.ntt_from_fq3(x) for x in r])
              for r in [r1] * K + [r2] * K]

    scheme = types.SimpleNamespace(row_constant=True,
                                   rows_limbs=(np.zeros((4, 24), np.uint32),
                                               np.zeros((4, 24), np.uint32)))
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)
    got = dn._build_head(tail, zs, alpha_s, zeta_s, (r1, r2, beta_s))

    jn = DeviceNifs(jax_engine, ccs, PARAMS, [[0] * 24] * 4, t_layout=True)

    def put(x):
        u = gl.to_u64(x)
        return jax_engine.put(((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                               (u >> np.uint64(32)).astype(np.uint32)))
    want = jn._build_head(put(tail), [put(z) for z in zs], cm_i_s, alpha_s,
                          zeta_s, beta_s, K)
    np.testing.assert_array_equal(gl.to_u64(got), u64(want))


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_eq_table_kernel_matches_twin_on_cuda():
    dev = _cuda()
    rng = np.random.default_rng(21)
    for nv, max_rows in EQ_CASES + [(17, None), (17, 1 << 14), (12, 3000)]:
        for point in (rand_point(rng, nv), [(P - 1,) * 3] * nv):
            for t_layout in (False, True):
                before = tables.eq_table.launches
                got = tables.eq_table(point, max_rows, dev, t_layout)
                assert tables.eq_table.launches == before + 1
                want = tables.eq_table_twin(point, max_rows, "cpu", t_layout)
                assert torch.equal(got.cpu(), want), (nv, max_rows, t_layout)


@pytest.mark.cuda
def test_head_alpha_kernel_matches_twin_on_cuda():
    dev = _cuda()
    rng = np.random.default_rng(22)
    for half, m in ((1, 1), (3, 300), (45, 4096)):
        tail = rand_u64(rng, 2 * half, 24, m)
        tail[0] = gl.P_I64 - 1
        tail[-1, :, 0] = gl.P_I64 - 1
        alpha = rand_u64(rng, 2 * half, 3)
        alpha[0] = gl.P_I64 - 1
        want = [torch.zeros((24, m), dtype=torch.int64) for _ in range(2)]
        tables.head_alpha_twin(tail, alpha, *want)
        got = [torch.zeros((24, m), dtype=torch.int64, device=dev)
               for _ in range(2)]
        before = tables.head_alpha.launches
        tables.head_alpha(tail.to(dev), alpha.to(dev), *got)
        assert tables.head_alpha.launches == before + 1
        assert torch.equal(got[0].cpu(), want[0]) and \
            torch.equal(got[1].cpu(), want[1]), (half, m)
