"""The Ajtai scheme a configuration names is the one the program and the
reference build: the harness's map from `scheme.kind` to the prover's
arguments, its refusal of a kind it does not know, the reference's copy
of the program's dense matrix, and its dense commitment, held to the
slot-wise definition and to the program's digit-plane commit."""

import sys

import numpy as np
import pytest

from zkbench import check, harness
from zkbench.ref.commit.ajtai import EXACT, AjtaiScheme, P
from zkbench.ref.nifs.structs import Witness
from zkbench.ref.ring import rq
from zkbench.ref.zkvm.params import resolve
from zkbench.tests.test_zkb_reference import SMALL

SEEDS = (5, 2**31 + 99)
N_SMALL = 43408          # SMALL's witness: w_size 10,852 times L = 4


def config(sch):
    return {"name": "c", "scheme": sch} if sch is not None else {"name": "c"}


@pytest.mark.parametrize("sch,kind,kw", [
    ({"kind": "row_constant", "seed": "--seed"}, "row_constant", {}),
    ({"kind": "general", "seed": "--seed"}, "general",
     {"general_ajtai": True}),
])
def test_a_known_kind_maps_to_the_prover_and_the_reference(sch, kind, kw):
    assert harness.scheme(config(sch)) == (kind, kw)
    assert kind in check.SCHEMES


@pytest.mark.parametrize("sch", [
    None, {}, {"seed": "--seed"}, {"kind": "dense", "seed": "--seed"},
    {"kind": "General", "seed": "--seed"}, {"kind": "general", "seed": 7},
])
def test_a_missing_or_unknown_scheme_is_refused(sch):
    with pytest.raises(harness.Refused, match="Ajtai scheme"):
        harness.scheme(config(sch))


def test_the_harness_and_the_reference_know_the_same_kinds():
    assert set(harness.SCHEMES) == set(check.SCHEMES)


def test_an_unknown_kind_exits_2_without_a_result(monkeypatch, capsys):
    from zkbench import run
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX",
                "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "1")
    monkeypatch.setattr(sys, "path", list(sys.path))
    w, conf, mix, metrics = harness.cell_files("fib_1mb.loop")
    conf = dict(conf, scheme={"kind": "binding", "seed": "--seed"})
    monkeypatch.setattr(harness, "cell_files",
                        lambda name: (w, conf, mix, metrics))
    rc = run.main(["--workload", "fib_1mb.loop", "--seed", "7",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == ""
    assert "'binding'" in err


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kappa,n", [(3, 7), (8, N_SMALL)])
def test_the_dense_matrix_equals_the_programs_limb_for_limb(kappa, n, seed):
    from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme as Port
    ours, theirs = (AjtaiScheme.from_seed_general(kappa, n, seed),
                    Port.from_seed_general(kappa, n, seed))
    for a, b in zip(ours.matrix, theirs.matrix):
        assert a.dtype == np.uint32 and np.array_equal(a, np.asarray(b))
    assert not ours.row_constant


def field(values):
    """Signed ints -> their canonical u64 residues."""
    v = np.asarray(values, dtype=object) % P
    return np.array(v.tolist(), dtype=np.uint64)


def witnesses(n, rng):
    """(name, f_coeff u64, within the dense path's exact range): balanced
    digits, digits at the range's edge, one coefficient a step past it,
    and uniform field elements."""
    limit = (EXACT - 1) // (n * 0xFFFF)
    digits = rng.integers(-(1 << 15) + 1, 1 << 15, (n, 24))
    edge = rng.choice([-limit, limit], (n, 24))
    past = digits.astype(object)
    past[n // 2, 5] = -(limit + 1)
    uniform = rng.integers(0, P, (n, 24), dtype=np.uint64)
    return [("digits", field(digits), True), ("edge", field(edge), True),
            ("past", field(past), False), ("uniform", uniform, False)]


@pytest.mark.parametrize("kappa,n,seed", [(3, 7, 5), (4, 300, 2**31 + 7),
                                          (8, N_SMALL, 2**31 + 99)])
def test_the_dense_commit_equals_the_definition_and_the_program(kappa, n,
                                                                seed):
    from latticeum_tpu_torch.field import goldilocks as gl
    from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme as Port
    from latticeum_tpu_torch.host.nifs.nifs import DecompositionParams
    from latticeum_tpu_torch.host.nifs.test_fixtures import get_test_ccs
    from latticeum_tpu_torch.zkvm.accel import Engine
    from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs
    ccs = get_test_ccs()
    dn = TorchNifs(Engine(ccs, "cpu"), ccs,
                   DecompositionParams(B=1024, L=2, B_SMALL=2, K=10),
                   Port.from_seed_general(kappa, n, seed))
    assert dn.general_ajtai
    scheme = AjtaiScheme.from_seed_general(kappa, n, seed)
    rng = np.random.default_rng(seed)
    cases = witnesses(n, rng)
    if n == N_SMALL:                  # the slot-wise definition is slow
        cases = [cases[0], cases[2]]
    for name, f_coeff, exact in cases:
        limbs = check.u64_limbs(f_coeff)
        f = rq.crt(limbs)
        x = scheme.small_coeffs(limbs)
        assert (x is not None) == exact, name
        want = scheme.commit_host(f)                      # the definition
        assert scheme.commit_coeff(limbs, f) == want, name
        if exact:
            assert scheme.commit_dense(x) == want, name
        assert dn.commit(gl.from_limbs(f)) == want, name


def test_the_row_constant_and_the_general_reference_commit_apart():
    params = resolve(**SMALL)
    refs = {k: check.Reference(params, 2**31 + 99, k) for k in check.SCHEMES}
    assert refs["row_constant"].scheme.row_constant
    assert not refs["general"].scheme.row_constant
    rng = np.random.default_rng(9)
    w = rng.integers(0, P, (refs["general"].layout.w_size, 24),
                     dtype=np.uint64)
    cms = {k: r.commit(check.u64_limbs(w)) for k, r in refs.items()}
    assert cms["row_constant"] != cms["general"]
    # the general commitment is the dense one, not the row sums'
    wit = Witness.from_w_ccs(check.u64_limbs(w), params.B, params.L)
    assert refs["general"].scheme.small_coeffs(wit.f_coeff) is not None
    assert cms["general"] == refs["general"].scheme.commit_dense(
        refs["general"].scheme.small_coeffs(wit.f_coeff))
    assert refs["general"].ajtai_s > 0

