"""The port's fold step (TorchNifs) against the host NIFS, and the state
converters between the two packages.

Two chained folds through ONE TorchNifs must equal host ``nifs.prove`` in
transcript state, accumulator, every proof message (lin and fold sum-checks,
decomposition claims, theta/eta) and the folded witness -- the
tests/test_accel_chain.py pattern, on the CPU twins.  The test CCS has a
truncated lin stack (cap 4 < m = 8), so the eq-table reconstruction rounds
run too.  Tolerance: none (exact integers)."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.commit.ajtai import AjtaiScheme
from latticeum_tpu.crypto.transcript import Transcript
from latticeum_tpu.field import goldilocks as gl_ref, host as H
from latticeum_tpu.nifs import decomposition as dec, folding as fold
from latticeum_tpu.nifs import linearization as lin
from latticeum_tpu.nifs import nifs
from latticeum_tpu.nifs.nifs import DecompositionParams
from latticeum_tpu.nifs.structs import CCCS, Witness
from latticeum_tpu.nifs.test_fixtures import (TEST_B, TEST_B_SMALL, TEST_K,
                                              TEST_L, get_dummy_ccs,
                                              get_dummy_z, get_test_ccs,
                                              get_test_z, z_to_device)
from latticeum_tpu.poly import mle, sumcheck
from latticeum_tpu.zkvm.accel_t import bitrev_indices
from latticeum_tpu_torch import convert
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.zkvm import accel_rounds, claims, comb
from latticeum_tpu_torch.zkvm.accel import Engine
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs
from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver

PARAMS = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                             K=TEST_K)


def same(x, limbs):
    return np.array_equal(gl.to_u64(x), gl_ref.to_int(
        (np.asarray(limbs[0]), np.asarray(limbs[1]))).astype(np.uint64))


def fixture_chain():
    """Test CCS, two CCCS instances with witnesses, the initial accumulator."""
    ccs = get_test_ccs()
    scheme, cms, wits = None, [], []
    for x in (3, 5):
        z = get_test_z(x)
        wit = Witness.from_w_ccs(z_to_device(z[2:]), TEST_B, TEST_L)
        if scheme is None:
            scheme = AjtaiScheme.from_seed(kappa=4, n=wit.f[0].shape[0])
        cms.append(CCCS(cm=scheme.commit_host(wit.f), x_ccs=z[:1]))
        wits.append(wit)
    acc_wit = Witness.from_w_ccs(gl_ref.zeros((ccs.n - ccs.l - 1, 24)),
                                 TEST_B, TEST_L)
    acc, _, _ = lin.prove(CCCS(cm=scheme.commit_host(acc_wit.f),
                               x_ccs=[H.ntt_zero()]), acc_wit, Transcript(),
                          ccs)
    return ccs, scheme, cms, wits, acc, acc_wit


def torch_nifs(ccs, scheme, device):
    return TorchNifs(Engine(ccs, device), ccs, PARAMS, scheme)


def check_chain(device):
    ccs, scheme, cms, wits, acc, acc_wit = fixture_chain()
    dn = torch_nifs(ccs, scheme, device)
    acc_h, w_h, acc_d = acc, acc_wit, acc
    w_d = dn.build_witness(dn.e.put(acc_wit.w_ccs))
    for step, (cm_i, wit) in enumerate(zip(cms, wits)):
        th, td = Transcript(), Transcript()
        acc_h, w_h, ph = nifs.prove(acc_h, w_h, cm_i, wit, th, ccs, scheme,
                                    PARAMS)
        w_i = dn.build_witness(dn.e.put(wit.w_ccs))
        assert dn.commit(w_i.f) == cm_i.cm
        acc_d, w_d, pd = dn.prove(acc_d, w_d, cm_i, w_i, td)
        assert list(td.ch.state) == list(th.ch.state), f"transcript, fold {step}"
        assert acc_d == convert.lcccs(acc_h), f"accumulator, fold {step}"
        for part in ("linearization", "decomposition_l", "decomposition_r",
                     "folding"):
            assert pd[part] == ph[part], f"{part}, fold {step}"
        w_ref = convert.witness_to_torch(w_h, device)
        for k in ("w_ccs", "f_coeff", "f", "f_hat"):
            assert torch.equal(getattr(w_d, k), getattr(w_ref, k)), k


def test_two_chained_folds_match_host():
    check_chain("cpu")


@pytest.mark.cuda
def test_two_chained_folds_match_host_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    check_chain("cuda")


@pytest.mark.parametrize("nv,n0", [(3, 8), (6, 8)])
def test_lin_rounds_match_host_sumcheck(nv, n0):
    """The eq-factored lin rounds against the host sum-check on the same
    (Mz..., eq) MLEs, full width (3, 8) and truncated to 8 of 2^6 columns
    (3 factored rounds, then 3 eq-table reconstruction rounds, the shape of
    the production lin stack's last rounds)."""
    S, signs = [(0, 1, 2), (1,), (2, 2)], (1, -1, 1)
    rng = np.random.default_rng(nv)
    beta = [tuple(int(v) for v in rng.integers(0, gl.P, 3, dtype=np.uint64))
            for _ in range(nv)]
    mz = rng.integers(0, gl.P, (3, n0, 24), dtype=np.uint64)
    with B.numpy_mode():
        eq = mle.build_eq_table(beta, max_rows=n0)
        g = (np.concatenate([(mz & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                             np.asarray(eq[0])[None]]),
             np.concatenate([(mz >> np.uint64(32)).astype(np.uint32),
                             np.asarray(eq[1])[None]]))
        c = gl_ref.from_int(np.array([H.ntt_from_u64(1 if x > 0 else gl.P - 1)
                                      for x in signs], dtype=object))
        two = lin.make_comb_fn2(S)
        th = Transcript(record_samples=True)
        ph, ch, fh = sumcheck.prove(th, g, nv, 4, lambda v: two(v, c),
                                    eq_info=(beta, 3))
    brev = torch.from_numpy(bitrev_indices((n0 - 1).bit_length()))
    g_t = gl.from_limbs(g).transpose(1, 2)[..., brev].contiguous()
    td = Transcript(record_samples=True)
    pd, cd, fd = accel_rounds.run_lin_rounds_factored(
        td, g_t, nv, 4, comb.lin_sets(S, signs, 3, "cpu"), beta)
    assert pd == ph and cd == ch
    assert list(td.ch.state) == list(th.ch.state)
    assert same(fd, (np.asarray(fh[0])[:, 0], np.asarray(fh[1])[:, 0]))
    assert_same_transcript(td, th)


def assert_same_transcript(td, th):
    """What the chained sum-check leaves in the host transcript equals
    what the host sum-check leaves: the challenger's state and pending
    input, the absorptions and the recorded samples (which the collector's
    ReplayTranscript replays, ROADMAP C.h8)."""
    assert td.export_for_device() == th.export_for_device()
    assert td.absorptions == th.absorptions
    assert td.samples == th.samples


@pytest.mark.parametrize("nv,K", [(3, 1), (4, 2)])
def test_fold_rounds_match_host_sumcheck(nv, K):
    """The eq-factored fold rounds against the host sum-check with the
    fold's comb on the same MLEs: [eq_r1, c1, eq_r2, c2, eq_beta] and 2K*TAU
    rows of balanced digits in {-1, 0, 1} (b_small = 2, so the round-0
    zero-skip holds), with one fetch."""
    b_small, tau = 2, 3
    rng = np.random.default_rng(100 + nv)
    n = 1 << nv

    def point():
        return [tuple(int(v) for v in rng.integers(0, gl.P, 3,
                                                   dtype=np.uint64))
                for _ in range(nv)]
    r1, r2, beta = point(), point(), point()
    mu_s = [tuple(int(v) for v in rng.integers(0, gl.P, 3, dtype=np.uint64))
            for _ in range(2 * K - 1)] + [(1, 0, 0)]
    digits = np.zeros((2 * K * tau, n, 24), np.uint64)
    digits[..., 0::3] = np.array([gl.P - 1, 0, 1], np.uint64)[
        rng.integers(0, 3, (2 * K * tau, n, 8))]
    c_rows = rng.integers(0, gl.P, (2, n, 24), dtype=np.uint64)
    with B.numpy_mode():
        eqs = [gl_ref.to_int(mle.build_eq_table(p)).astype(np.uint64)
               for p in (r1, r2, beta)]
        g = np.stack([eqs[0], c_rows[0], eqs[1], c_rows[1], eqs[2]]
                     + list(digits))
        g = ((g & np.uint64(0xFFFFFFFF)).astype(np.uint32),
             (g >> np.uint64(32)).astype(np.uint32))
        th = Transcript(record_samples=True)
        ph, ch, fh = sumcheck.prove(th, g, nv, 2 * b_small,
                                    fold.make_comb_fn(mu_s, b_small, K))
    brev = torch.from_numpy(bitrev_indices(nv))
    g_t = gl.from_limbs(g).transpose(1, 2)[..., brev].contiguous()
    td = Transcript(record_samples=True)
    before = accel_rounds.fetches
    pd, cd, fd = accel_rounds.run_fold_rounds_factored(
        td, g_t[:5], g_t[5:], nv, 2 * b_small, mu_s, (r1, r2, beta), b_small,
        K)
    assert accel_rounds.fetches == before + 1
    assert pd == ph and cd == ch
    assert same(fd, (np.asarray(fh[0])[:, 0], np.asarray(fh[1])[:, 0]))
    assert_same_transcript(td, th)


def test_engine_primitives_match_reference():
    ccs = get_dummy_ccs(2, 13, L=1)
    e = Engine(ccs, "cpu")
    rng = np.random.default_rng(1)
    z = rng.integers(0, gl.P, (ccs.n, 24), dtype=np.uint64)
    zl = ((z & np.uint64(0xFFFFFFFF)).astype(np.uint32),
          (z >> np.uint64(32)).astype(np.uint32))
    point = [tuple(int(v) for v in rng.integers(0, gl.P, 3, dtype=np.uint64))
             for _ in range(ccs.s)]
    with B.numpy_mode():
        # the t-layout stack (t, 24, cap_pow2), row i at column bitrev(i)
        mz = e.mz_stack(e.put(zl))
        cap = e.cap_pow2
        mz = mz[..., torch.from_numpy(bitrev_indices(
            (cap - 1).bit_length()))].transpose(1, 2)
        assert same(mz, ccs.matvecs(zl, cap))
        for rows in (None, 5, 1 << ccs.s):
            assert same(e.eq_table(point, rows),
                        mle.build_eq_table(point, max_rows=rows)
                        if rows is None or rows >= (1 << ccs.s) else
                        _eq_trunc(point, rows))
        assert same(e.mt_eq_stack(e.eq_table(point, ccs.m)),
                    dec.eq_transposed_rows(ccs, point))
        eqT = e.mt_eq_stack(e.eq_table(point, ccs.m))
        u = claims.eval_claims(eqT, e.put(zl)[None])
        assert gl.to_int_lists(u[0]) == dec.eval_claims_via_eqT(
            dec.eq_transposed_rows(ccs, point), zl)


def _eq_trunc(point, rows):
    """Reference truncated eq table (DeviceEngine.eq_table semantics):
    2^ceil(log2 rows) rows, skipped variables folded into every row."""
    n_dbl = (rows - 1).bit_length()
    tail = (1, 0, 0)
    for r in point[n_dbl:]:
        tail = H.fq3_mul(tail, H.fq3_sub((1, 0, 0), r))
    tab = mle.build_eq_table(point[:n_dbl])
    return mle.rq.ntt_scalar_mul(tab, mle.fq3_const(tail))


def test_witness_pipeline_matches_host_witness():
    ccs, scheme, cms, wits, acc, acc_wit = fixture_chain()
    dn = torch_nifs(ccs, scheme, "cpu")
    for wit in wits:
        w = dn.build_witness(dn.e.put(wit.w_ccs))
        ref = convert.witness_to_torch(wit)
        for k in ("w_ccs", "f_coeff", "f", "f_hat"):
            assert torch.equal(getattr(w, k), getattr(ref, k)), k
        for other in (dn.witness_from_f(w.f), dn.witness_from_f_coeff(
                w.f_coeff)):
            for k in ("w_ccs", "f_coeff", "f", "f_hat"):
                assert torch.equal(getattr(other, k), getattr(ref, k)), k
        assert dn.commit(w.f) == scheme.commit_host(wit.f)
        point = [tuple(int(v) for v in np.random.default_rng(2).integers(
            0, gl.P, 3, dtype=np.uint64)) for _ in range(ccs.s)]
        v = claims.eval_fhat(w.f_hat, dn.e.eq_table(
            point, w.f_hat.shape[-1], t_layout=True))
        assert gl.to_int_lists(v) == lin.evaluate_mles_host(wit.f_hat, point)


def test_convert_round_trips():
    ccs, scheme, cms, wits, acc, acc_wit = fixture_chain()
    tw = convert.witness_to_torch(wits[0])
    back = convert.witness_from_torch(tw)
    for k in ("w_ccs", "f_coeff", "f", "f_hat"):
        a, b = getattr(back, k), getattr(wits[0], k)
        assert np.array_equal(a[0], np.asarray(b[0])), k
        assert np.array_equal(a[1], np.asarray(b[1])), k
    assert (convert.lcccs_from_torch(convert.lcccs_to_torch(acc))
            == convert.lcccs(acc))
    rows = convert.ajtai_rows(scheme)
    lo, hi = gl.to_limbs(rows)
    assert np.array_equal(lo, scheme.rows_limbs[0])
    assert np.array_equal(hi, scheme.rows_limbs[1])
    for (r, c, v), M in zip(convert.ccs_coo_limbs(convert.ccs_coo(ccs)),
                            ccs.M):
        assert np.array_equal(r, M.rows) and np.array_equal(c, M.cols)
        assert np.array_equal(v[0], M.vals[0])
        assert np.array_equal(v[1], M.vals[1])
    e = Engine(ccs, "cpu")
    lo, hi = e.get(e.put(wits[1].f))
    assert np.array_equal(lo, wits[1].f[0]) and np.array_equal(hi, wits[1].f[1])


def test_t_layout_witness_from_jax_round_trips():
    """A DeviceWitness-style t-layout f_hat converts without re-layout."""
    ccs, scheme, cms, wits, acc, acc_wit = fixture_chain()
    std = convert.witness_to_torch(wits[0])
    tl = gl.to_limbs(std.f_hat)
    dw = Witness(wits[0].w_ccs, wits[0].f_coeff, wits[0].f, tl)
    assert torch.equal(convert.witness_to_torch(dw, t_layout=True).f_hat,
                       std.f_hat)


@pytest.mark.slow
def test_jax_device_lin_reuses_first_betas_in_reconstruction():
    """ROADMAP C.h9.  The JAX package's device lin sum-check bakes the betas
    of its first call into the jitted reconstruction rounds of a truncated
    lin stack (cap 64 of m = 256 here).  A later call with other betas then
    leaves the host sum-check at the first reconstruction round, and equals
    the port with that reuse replayed (chip_smoke.stale_lin_betas)."""
    import importlib.util
    import os

    import jax
    jax.config.update("jax_platforms", "cpu")
    from latticeum_tpu.zkvm.accel import DeviceEngine
    from latticeum_tpu.zkvm.accel_nifs import DeviceNifs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    x_len, params = 4, DecompositionParams(B=1 << 15, L=5, B_SMALL=2, K=15)
    ccs = get_dummy_ccs(x_len, 50, L=params.L)
    z = get_dummy_z(x_len, 50)
    wit = Witness.from_w_ccs(z_to_device(z[x_len + 1:]), params.B, params.L)
    scheme = AjtaiScheme.from_seed(kappa=4, n=wit.f[0].shape[0])
    cm_i = CCCS(cm=scheme.commit_host(wit.f), x_ccs=z[:x_len])
    rows = [[int(v) for v in r] for r in gl_ref.to_int(scheme.rows_limbs)]

    def transcripts():
        fresh, other = Transcript(), Transcript()
        other.absorb_u64(7)
        return fresh, other

    def run(prove):
        out = []
        for t in transcripts():
            pr = prove(t)
            out.append((pr["sumcheck"], pr["v"], pr["u"], list(t.ch.state)))
        return out

    host = run(lambda t: lin.prove(cm_i, wit, t, ccs)[1])
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, params, scheme)
    w_t = dn.build_witness(dn.e.put(wit.w_ccs))
    assert run(lambda t: dn.lin_prove(cm_i, w_t, t)[1]) == host
    with smoke.stale_lin_betas():
        replay = run(lambda t: dn.lin_prove(cm_i, w_t, t)[1])
    engine = DeviceEngine(ccs, params, tail_threshold=8)
    jdn = DeviceNifs(engine, ccs, params, rows, t_layout=True)
    w_j = jdn.build_witness(engine.put(wit.w_ccs))
    jax_dev = run(lambda t: jdn.lin_prove(cm_i, w_j, t)[1])
    assert jax_dev[0] == host[0] and replay[0] == host[0]
    first_recon = (dn._cap_pow2 - 1).bit_length()
    assert jax_dev[1][0][:first_recon] == host[1][0][:first_recon]
    assert jax_dev[1][0][first_recon] != host[1][0][first_recon]
    assert jax_dev[1] == replay[1]


def test_cuda_prover_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        TorchZkVmProver(device="cuda")
