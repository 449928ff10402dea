"""The port's COO segment sums (``zkvm/accel.py``: ``build_csr``,
``coo_matvec``, kernel in ``csrc/coo.cu``) against the code they replace
and against the JAX package.

* The CSR wrapper's twin (what a CPU tensor runs) against
  ``goldilocks.segment_sum`` of the unsorted COO, the port's code before
  the CSR, on random COOs with empty segments and one segment of more
  than 700 entries, in both value kinds (base-field scalars, rings), the
  three output forms (standard, t-layout, the fold head's challenged z
  added in place); the heavy segments the kernel gives a block each.
* ``Engine.mz_stack``, ``Engine.mt_eq_stack`` and ``TorchNifs.lin_g_t``
  against JAX ``DeviceEngine.matvecs``, ``DeviceNifs.eqT`` and
  ``DeviceNifs.lin_g_t`` on XLA:CPU, on the test CCS (ring values) and
  on its scalar form (the zkVM's kind).
* On the card (``cuda`` marker): the kernel against its twin in every
  mode, heavy segments included.

Tolerance: none (exact integers)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from latticeum_tpu.field import goldilocks as gl_ref
from latticeum_tpu.nifs.nifs import DecompositionParams
from latticeum_tpu.nifs.structs import SparseScalarMatrix
from latticeum_tpu.nifs.test_fixtures import (TEST_B, TEST_B_SMALL, TEST_K,
                                              TEST_L, get_test_ccs)
from latticeum_tpu.zkvm.accel_t import bitrev_indices
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.ring import rq
from latticeum_tpu_torch.zkvm import accel
from latticeum_tpu_torch.zkvm.accel import Engine, build_csr, coo_matvec
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs

P = gl.P
PARAMS = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                             K=TEST_K)
FORMS = ("standard", "t_layout", "head")


def rand_u64(rng, *shape):
    return rng.integers(0, P, shape, dtype=np.uint64)


def tt(u):
    return torch.from_numpy(gl.to_i64_bits(u))


def random_coo(rng, ring, n_mats=3, per=50, rows_in=40, heavy=705):
    """Entries over n_mats blocks of `per` segments: a few random ones
    (most segments stay empty), `heavy` into one segment and 30 into each
    of five others of the last block; values with p - 1 among them."""
    nseg = n_mats * per
    last = nseg - per
    seg = np.concatenate([rng.integers(0, nseg, nseg // 4),
                          np.full(heavy, last + 7),
                          np.repeat(np.arange(last + 20, last + 25), 30)])
    nnz = seg.shape[0]
    gather = rng.integers(0, rows_in, nnz)
    gather[:3] = rows_in - 1
    mats = seg // per
    vals = rand_u64(rng, nnz, 24) if ring else rand_u64(rng, nnz)
    vals[:5] = P - 1
    return seg, gather, mats, vals, nseg, per, rows_in


def old_segment_sums(seg, gather, mats, vals, nseg, x, zeta=None):
    """The port's code before the CSR: gather (the head's challenged z per
    entry), product, gl.segment_sum over the unsorted entries."""
    g = torch.from_numpy(gather)
    if zeta is None:
        y = x[g]
    else:
        y = None
        for i in range(x.shape[0]):
            zc = zeta[i][torch.from_numpy(mats)]
            term = rq.ntt_scalar_mul(x[i][g], tuple(zc[:, c]
                                                    for c in range(3)))
            y = term if y is None else gl.add(y, term)
    v = tt(vals)
    prod = gl.mul(v[:, None], y) if v.dim() == 1 else rq.ntt_mul(v, y)
    return gl.segment_sum(prod, torch.from_numpy(seg), nseg)


def coo_case(rng, ring, form, nwit=3):
    """(csr, x, zeta, out, t_layout, want) for one form."""
    seg, gather, mats, vals, nseg, per, rows_in = random_coo(
        rng, ring, n_mats=1 if form == "head" else 3)
    csr = build_csr(seg, gather, mats, vals, nseg, per, "cpu")
    zeta = None
    if form == "head":
        x = tt(rand_u64(rng, nwit, rows_in, 24))
        zeta = tt(rand_u64(rng, nwit, 3, 3))
        zeta[0, 0] = gl.P_I64 - 1
    else:
        x = tt(rand_u64(rng, rows_in, 24))
    x.view(-1)[:24] = gl.P_I64 - 1
    s = old_segment_sums(seg, gather, mats, vals, nseg, x, zeta)
    s = s.reshape(-1, per, 24)
    if form == "standard":
        return csr, x, zeta, torch.empty_like(s), False, s
    s = s.transpose(1, 2).contiguous()
    if form == "t_layout":
        return csr, x, zeta, torch.empty_like(s), True, s
    base = tt(rand_u64(rng, 24, per))
    return csr, x, zeta, base.clone(), True, gl.add(base, s[0])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("ring", [False, True])
def test_csr_twin_matches_segment_sum(ring, form):
    rng = np.random.default_rng(3 + 2 * FORMS.index(form) + ring)
    csr, x, zeta, out, t_layout, want = coo_case(rng, ring, form)
    accel.coo_matvec.launches = 0
    got = coo_matvec(csr, x, out, t_layout, zeta)
    assert got is out
    assert torch.equal(out, want)
    assert accel.coo_matvec.launches == 0          # the twin ran
    counts = (csr.off[1:] - csr.off[:-1]).numpy()
    assert (counts == 0).sum() > csr.nseg // 2       # empty segments
    assert counts.max() > 700


@pytest.mark.parametrize("nwit", [1, 15])
def test_csr_heavy_segments_lead_the_size_order(nwit):
    """The kernel's heavy segments (entries x witnesses > COO_LIGHT) are
    exactly the first n_heavy of by_size, whose sizes are the segments'
    entry counts, most first, every non-empty segment once."""
    rng = np.random.default_rng(5)
    seg, gather, mats, vals, nseg, per, _ = random_coo(rng, False)
    csr = build_csr(seg, gather, mats, vals, nseg, per, "cpu")
    counts = np.bincount(seg, minlength=nseg)
    by = csr.by_size.numpy()
    assert sorted(by.tolist()) == np.flatnonzero(counts).tolist()
    assert np.array_equal(csr.sizes, counts[by])
    assert np.all(np.diff(csr.sizes) <= 0)
    k = csr.n_heavy(nwit)
    assert set(by[:k].tolist()) == set(
        np.flatnonzero(counts * nwit > accel.COO_LIGHT).tolist())
    assert np.array_equal(csr.off.numpy(),
                          np.concatenate([[0], np.cumsum(counts)]))


def test_coo_matvec_validates_its_arguments():
    rng = np.random.default_rng(6)
    csr, x, zeta, out, t_layout, _ = coo_case(rng, False, "standard")
    with pytest.raises(ValueError):                  # output laid out wrong
        coo_matvec(csr, x, out, True)
    with pytest.raises(ValueError):                  # too few input rows
        coo_matvec(csr, x[:5].contiguous(), out, False)
    with pytest.raises(TypeError):
        coo_matvec(csr, x.to(torch.int32), out, False)
    with pytest.raises(ValueError):                  # not contiguous
        coo_matvec(csr, x.t().contiguous().t(), out, False)
    with pytest.raises(ValueError):
        build_csr(np.array([0, 5]), np.array([0, 0]), np.array([0, 0]),
                  np.array([1, 1], np.uint64), 4, 2, "cpu")


# -- the Engine's stacks against the JAX package ------------------------------

def scalar_ccs():
    """The test CCS with its ring values (c, 0, 0) x 8 held as base-field
    scalars c, the zkVM's kind of matrix."""
    ccs = get_test_ccs()
    mats = []
    for M in ccs.M:
        u = gl_ref.to_int((np.asarray(M.vals[0]), np.asarray(M.vals[1])))
        u = np.asarray(u, dtype=np.uint64)
        assert np.all(u[:, 1::3] == 0) and np.all(u[:, 2::3] == 0)
        assert np.all(u[:, 0::3] == u[:, :1])
        c = u[:, 0]
        mats.append(SparseScalarMatrix(
            M.nrows, M.ncols, M.rows, M.cols,
            ((c & np.uint64(0xFFFFFFFF)).astype(np.uint32),
             (c >> np.uint64(32)).astype(np.uint32))))
    return dataclasses.replace(ccs, M=mats)


CCS_KINDS = {"ring": get_test_ccs, "scalar": scalar_ccs}


@pytest.fixture(scope="module")
def jax_side():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from latticeum_tpu.zkvm.accel import DeviceEngine
    from latticeum_tpu.zkvm.accel_nifs import DeviceNifs

    def make(ccs):
        e = DeviceEngine(ccs, PARAMS)
        return e, DeviceNifs(e, ccs, PARAMS, [[0] * 24] * 4, t_layout=True)
    return make


def u64(limbs):
    return np.asarray(gl_ref.to_int((np.asarray(limbs[0]),
                                     np.asarray(limbs[1])))).astype(np.uint64)


def port_nifs(ccs):
    scheme = types.SimpleNamespace(row_constant=True,
                                   rows_limbs=(np.zeros((4, 24), np.uint32),
                                               np.zeros((4, 24), np.uint32)))
    return TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)


def put(engine, x):
    u = gl.to_u64(x)
    return engine.put(((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (u >> np.uint64(32)).astype(np.uint32)))


@pytest.mark.parametrize("kind", list(CCS_KINDS))
def test_engine_stacks_match_jax(jax_side, kind):
    ccs = CCS_KINDS[kind]()
    je, jn = jax_side(ccs)
    dn = port_nifs(ccs)
    assert dn.e.scalar == (kind == "scalar")
    rng = np.random.default_rng(11)
    z = tt(rand_u64(rng, ccs.n, 24))
    z[0] = gl.P_I64 - 1
    point = [tuple(int(v) for v in rand_u64(rng, 3)) for _ in range(ccs.s)]
    beta = [tuple(int(v) for v in rand_u64(rng, 3)) for _ in range(ccs.s)]

    cap = dn.e.cap_pow2
    mz = dn.e.mz_stack(z)                                 # (t, 24, cap)
    brev = torch.from_numpy(bitrev_indices((cap - 1).bit_length()))
    want = u64(je.matvecs(put(je, z), cap))               # (t, cap, 24)
    assert np.array_equal(gl.to_u64(mz[..., brev].transpose(1, 2)), want)

    g = dn.lin_g_t(z, beta)
    assert np.array_equal(gl.to_u64(g), u64(jn.lin_g_t(put(je, z), beta)))

    assert np.array_equal(gl.to_u64(dn.eqT(point)), u64(jn.eqT(point)))


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_coo_matvec_matches_twin():
    """Every form and value kind, with 1 and 15 witnesses in the head mode
    (the heavy segments then change), against the twin on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    accel.coo_matvec.launches = 0
    calls = 0
    for ring in (False, True):
        for form in FORMS:
            for nwit in ((1, 15) if form == "head" else (1,)):
                csr, x, zeta, out, t_layout, _ = coo_case(
                    rng, ring, form, nwit)
                want = out.clone()
                accel.coo_matvec_twin(csr, x, want, t_layout, zeta)
                csr_d = dataclasses.replace(csr, **{
                    k: getattr(csr, k).to(dev)
                    for k in ("off", "gather", "mats", "vals", "by_size")})
                got = out.to(dev)
                coo_matvec(csr_d, x.to(dev), got, t_layout,
                           None if zeta is None else zeta.to(dev))
                calls += 1
                assert torch.equal(got.cpu(), want), (ring, form, nwit)
    assert accel.coo_matvec.launches == calls
