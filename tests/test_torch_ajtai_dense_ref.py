"""The port's dense (binding) Ajtai commitment against the benchmark's
plain reference (`zkbench/ref`: numpy and pure Python, nothing of the
port), on the CPU at small kappa and n.  Exact integers throughout.

  * the port's `AjtaiScheme.from_seed_general` matrix equals the
    reference's limb for limb;
  * `TorchNifs._commit_many` under that matrix equals the reference's
    `commit_dense` where the witness lies in its exact float64 range, and
    the slot-wise definition (`commit_host`) always: balanced small-digit
    witnesses, uniform field witnesses, and one coefficient a step past
    the exact range (the reference's `commit_coeff` falls back there), one
    at a time and as one batch;
  * one CPU `TorchNifs` fold under the dense matrix is accepted by the
    reference's NIFS verifier, which folds to the port's accumulator, and
    the port's folded witness opens its commitment under the reference's
    matrix;
  * with the tracer on, one `commit` and one fold record the span
    `ajtai.dense` once for the commit and once for each dec, and the
    counters `ajtai.dense.witnesses` (2(K - 1) + 1) and `ajtai.dense.gemms`
    (8 slots x chunks x contractions); under the row-constant scheme none
    of them.
"""

import numpy as np
import pytest
import torch

from latticeum_tpu_torch.field import goldilocks as gl, mxu
from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme as Port
from latticeum_tpu_torch.host.crypto.transcript import Transcript
from latticeum_tpu_torch.host.field import host as PH
from latticeum_tpu_torch.host.nifs.nifs import DecompositionParams
from latticeum_tpu_torch.host.nifs.structs import CCCS
from latticeum_tpu_torch.host.nifs.test_fixtures import (
    A_ROWS, B_ROWS, C_ROWS, TEST_B, TEST_B_SMALL, TEST_K, TEST_L,
    get_test_ccs, get_test_z)
from latticeum_tpu_torch.host.utils import tracing
from latticeum_tpu_torch.zkvm.accel import Engine
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs
from zkbench import check
from zkbench.ref.commit.ajtai import EXACT, P, AjtaiScheme as Ref
from zkbench.ref.crypto.transcript import Transcript as RefTranscript
from zkbench.ref.field import host as RH
from zkbench.ref.nifs import nifs as ref_nifs, structs as ref_structs
from zkbench.ref.ring import rq as ref_rq

SEEDS = (5, 2**31 + 99)
SIZES = ((3, 7), (4, 300), (8, 2000))
PARAMS = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                             K=TEST_K)


def nifs(scheme):
    ccs = get_test_ccs()
    return TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)


def field(values):
    """Signed ints -> their canonical u64 residues."""
    v = np.asarray(values, dtype=object) % P
    return np.array(v.tolist(), dtype=np.uint64)


def witnesses(n, rng):
    """(name, coefficients u64 (n, 24), inside commit_dense's exact range)."""
    limit = (EXACT - 1) // (n * 0xFFFF)
    digits = rng.integers(-(1 << 15) + 1, 1 << 15, (n, 24))
    past = digits.astype(object)
    past[n // 2, 7] = -(limit + 1)
    uniform = rng.integers(0, P, (n, 24), dtype=np.uint64)
    return [("digits", field(digits), True), ("past", field(past), False),
            ("uniform", uniform, False)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kappa,n", SIZES)
def test_the_matrix_equals_the_references_limb_for_limb(kappa, n, seed):
    port, ref = (Port.from_seed_general(kappa, n, seed),
                 Ref.from_seed_general(kappa, n, seed))
    for a, b in zip(port.matrix, ref.matrix):
        assert np.asarray(a).shape == (kappa, n, 24)
        assert np.array_equal(np.asarray(a), b)
    assert not ref.row_constant and not getattr(port, "row_constant", False)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kappa,n", SIZES)
def test_commit_many_equals_commit_dense_and_the_definition(kappa, n, seed):
    dn = nifs(Port.from_seed_general(kappa, n, seed))
    assert dn.general_ajtai
    ref = Ref.from_seed_general(kappa, n, seed)
    cases = witnesses(n, np.random.default_rng([seed, n]))
    fs, wants = [], []
    for name, coeff, exact in cases:
        limbs = check.u64_limbs(coeff)
        f = ref_rq.crt(limbs)
        want = ref.commit_host(f)                       # the definition
        x = ref.small_coeffs(limbs)
        assert (x is not None) == exact, name
        if exact:
            assert ref.commit_dense(x) == want, name
        assert ref.commit_coeff(limbs, f) == want, name
        fs.append(gl.from_limbs(f))
        wants.append(want)
        got = gl.to_int_lists(dn._commit_many(fs[-1][None]))
        assert got == [want], name
    assert gl.to_int_lists(dn._commit_many(torch.stack(fs))) == wants


def ref_test_ccs():
    """The test CCS (x^3 + x + 5 = y, padded) built from the reference's
    own structures."""
    n, l, m = 6, 1, 8

    def sparse(rows):
        return ref_structs.SparseRingMatrix.from_host(m, n, [
            (r, c, RH.ntt_from_u64(v)) for r, row in enumerate(rows)
            for c, v in enumerate(row) if v])
    return ref_structs.CCS(m=m, n=n, l=l, t=3, q=2, d=2,
                           M=[sparse(R) for R in (A_ROWS, B_ROWS, C_ROWS)],
                           S=[[0, 1], [2]],
                           c=[RH.ntt_from_u64(1),
                              RH.ntt_neg(RH.ntt_from_u64(1))])


KAPPA, SEED = 4, 2**31 + 7


def traced_fold(kind):
    """One CPU fold of the test CCS under scheme `kind`, the commit of its
    incoming witness and the fold traced: (tracer, n, accumulator in,
    cm_i, proof, folded accumulator, folded witness)."""
    ccs = get_test_ccs()
    n = (ccs.n - ccs.l - 1) * TEST_L
    make = {"general": Port.from_seed_general, "row_constant": Port.from_seed}
    dn = nifs(make[kind](KAPPA, n, seed=SEED))
    assert dn.general_ajtai == (kind == "general")
    w_acc = dn.build_witness(dn.e.ints([PH.ntt_zero()] * (n // TEST_L)))
    acc, _, _ = dn.lin_prove(CCCS(cm=dn.commit(w_acc.f),
                                  x_ccs=[PH.ntt_zero()]), w_acc, Transcript())
    z = get_test_z(3)
    w_i = dn.build_witness(dn.e.ints(z[2:]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "GLOBAL", tracing.Tracer(enabled=True))
        cm_i = CCCS(cm=dn.commit(w_i.f), x_ccs=z[:1])
        folded, w0, proof = dn.prove(acc, w_acc, cm_i, w_i, Transcript())
        return tracing.GLOBAL, n, acc, cm_i, proof, folded, w0


@pytest.fixture(scope="module")
def folds():
    return {kind: traced_fold(kind) for kind in ("general", "row_constant")}


def test_a_dense_fold_is_accepted_by_the_reference_verifier(folds):
    _, n, acc, cm_i, proof, folded, w0 = folds["general"]
    dp = ref_nifs.DecompositionParams(B=TEST_B, L=TEST_L,
                                      B_SMALL=TEST_B_SMALL, K=TEST_K)
    got = ref_nifs.verify(
        check.lcccs(acc), ref_structs.CCCS(
            cm=[list(c) for c in cm_i.cm],
            x_ccs=[list(x) for x in cm_i.x_ccs]),
        proof, RefTranscript(), ref_test_ccs(), dp)
    assert check.same_acc(got, check.lcccs(folded))
    # the folded witness opens the folded commitment under the matrix
    ref = Ref.from_seed_general(KAPPA, n, SEED)
    wit = ref_structs.Witness.from_f_coeff(
        check.u64_limbs(w0.f_coeff.numpy().view(np.uint64)), TEST_B, TEST_L)
    assert ref.commit_coeff(wit.f_coeff, wit.f) == [list(c)
                                                    for c in folded.cm]
    assert ref.commit_host(wit.f) == [list(c) for c in folded.cm]


def test_the_dense_commitments_record_their_spans_and_counters(folds):
    tr, n, *_ = folds["general"]
    spans = [s for s in tr.spans if s[0] == "ajtai.dense"]
    assert len(spans) == 3                      # the commit, then dec x2
    outer = {name: (a, b) for name, a, b in tr.spans}
    assert spans[0][2] <= outer["nifs.lin"][0]          # before the fold
    for name, (_, a, b) in zip(("nifs.dec_l", "nifs.dec_r"), spans[1:]):
        assert outer[name][0] <= a <= b <= outer[name][1], name
    assert tr.counts["ajtai.dense"] == 1
    assert tr.counts["nifs.dec_l/ajtai.dense"] == 1
    assert tr.counts["nifs.dec_r/ajtai.dense"] == 1
    chunks = len(range(0, mxu.plane_shape(1, n)[1], mxu.CHUNK_N))
    assert tr.counters["ajtai.dense.witnesses"] == 2 * (TEST_K - 1) + 1
    assert tr.counters["ajtai.dense.gemms"] == 8 * chunks * 3


def test_the_row_constant_scheme_records_none_of_them(folds):
    tr = folds["row_constant"][0]
    assert {"nifs.lin", "nifs.dec_l", "nifs.dec_r", "nifs.fold"} <= {
        s[0] for s in tr.spans}
    assert not [s for s in tr.spans if s[0].startswith("ajtai.")]
    assert not [k for k in tr.counters if k.startswith("ajtai.")]


@pytest.mark.parametrize("kappa,n", [(3, 7), (1, mxu.CHUNK_N + 5)])
def test_contract_gemms_counts_the_int_mm_launches(monkeypatch, kappa, n):
    calls = [0]
    int_mm = torch._int_mm

    def counted(*args, **kwargs):
        calls[0] += 1
        return int_mm(*args, **kwargs)
    monkeypatch.setattr(torch, "_int_mm", counted)
    rng = np.random.default_rng(n)
    a = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, P, (kappa, n, 24), dtype=np.uint64)))
    pb = mxu.digit_split(a[:1].contiguous())
    mxu.contract(mxu.digit_split(a), pb)
    assert calls[0] == mxu.contract_gemms(pb) == 8 * -(-n // mxu.CHUNK_N)
