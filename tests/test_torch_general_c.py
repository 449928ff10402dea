"""The port's linearization over a CCS whose constants c_i are not +-1
(ROADMAP C.h4) against the host NIFS.

The test CCS (x^3 + x + 5 = y) with c = [rho, -rho] in place of [1, -1]
still holds for the test witnesses, so the host verifier accepts its folds.
rho is the scalar 3, or a full ring made from a numpy seed.  The CCS has a
truncated lin stack (cap 4 < m = 8), so the eq-table reconstruction rounds
run with the same constants.  Its lin rounds call the lin comb kernels'
wrappers with the rings as constants (on these CPU tensors the wrappers
run their twins); the +-1 CCS calls them with signs.
Tolerance: none (exact integers)."""

import dataclasses

import numpy as np
import pytest

from latticeum_tpu.commit.ajtai import AjtaiScheme
from latticeum_tpu.crypto.transcript import Transcript
from latticeum_tpu.field import goldilocks as gl_ref, host as H
from latticeum_tpu.nifs import linearization as lin, nifs
from latticeum_tpu.nifs.nifs import DecompositionParams
from latticeum_tpu.nifs.structs import CCCS, Witness
from latticeum_tpu.nifs.test_fixtures import (TEST_B, TEST_B_SMALL, TEST_K,
                                              TEST_L, get_test_ccs,
                                              get_test_z, z_to_device)
from latticeum_tpu_torch import convert
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.zkvm import accel_rounds, comb
from latticeum_tpu_torch.zkvm.accel import Engine
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs, lin_c_signs

PARAMS = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                             K=TEST_K)


def general_ccs(kind):
    """The test CCS with c = [rho, -rho]."""
    ccs = get_test_ccs()
    if kind == "scalar":
        rho = H.ntt_from_u64(3)
    else:
        rho = [int(v) for v in np.random.default_rng(61).integers(
            0, gl.P, 24, dtype=np.uint64)]
    return dataclasses.replace(ccs, c=[rho, H.ntt_neg(rho)])


def instances(ccs):
    """The Ajtai scheme, two CCCS instances with witnesses, the initial
    accumulator and its witness."""
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
    return scheme, cms, wits, acc, acc_wit


@pytest.mark.parametrize("kind", ["scalar", "ring"])
def test_general_c_lin_prove_matches_host(kind):
    ccs = general_ccs(kind)
    assert lin_c_signs(ccs.c) is None
    scheme, cms, wits, _, _ = instances(ccs)
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)
    assert dn._lin_sets.signs is None
    assert dn._cap_pow2 < ccs.m          # the reconstruction rounds run
    for cm_i, wit in zip(cms, wits):
        th, td = Transcript(record_samples=True), Transcript(
            record_samples=True)
        lh, ph, _ = lin.prove(cm_i, wit, th, ccs)
        before = accel_rounds.fetches
        ld, pd, _ = dn.lin_prove(cm_i, dn.build_witness(dn.e.put(wit.w_ccs)),
                                 td)
        assert accel_rounds.fetches == before + 1
        assert pd == ph
        assert ld == convert.lcccs(lh)
        assert td.export_for_device() == th.export_for_device()
        assert td.absorptions == th.absorptions
        assert td.samples == th.samples


@pytest.mark.parametrize("kind", ["scalar", "ring"])
def test_general_c_folds_match_host_and_pass_its_verifier(kind):
    """Two chained TorchNifs.prove folds equal host nifs.prove (transcript,
    proof, accumulator), and the host verifier folds each proof to the
    same accumulator."""
    ccs = general_ccs(kind)
    scheme, cms, wits, acc, acc_wit = instances(ccs)
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)
    acc_h, w_h, acc_d = acc, acc_wit, acc
    w_d = dn.build_witness(dn.e.put(acc_wit.w_ccs))
    for step, (cm_i, wit) in enumerate(zip(cms, wits)):
        th, td = Transcript(), Transcript()
        acc_prev = acc_h
        acc_h, w_h, ph = nifs.prove(acc_h, w_h, cm_i, wit, th, ccs, scheme,
                                    PARAMS)
        acc_d, w_d, pd = dn.prove(acc_d, w_d, cm_i,
                                  dn.build_witness(dn.e.put(wit.w_ccs)), td)
        assert list(td.ch.state) == list(th.ch.state), f"fold {step}"
        assert pd == ph, f"fold {step}"
        assert acc_d == convert.lcccs(acc_h), f"fold {step}"
        folded = nifs.verify(acc_prev, cm_i, pd, Transcript(), ccs, PARAMS)
        assert convert.lcccs(folded) == acc_d, f"fold {step}"


@pytest.mark.parametrize("general", [False, True])
def test_lin_route_follows_the_constants(monkeypatch, general):
    """Both CCS call the lin comb kernels' wrappers (which launch the
    kernels on the card) in every factored round: the +-1 one with its
    signs, any other with its rings, which the wrappers hand on as the
    kernels' constants."""
    ccs = general_ccs("ring") if general else get_test_ccs()
    scheme, cms, wits, _, _ = instances(ccs)
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)
    sets = dn._lin_sets
    if general:
        assert sets.signs is None and sets.sgn is None
        assert gl.to_int_lists(sets.rings) == [[int(v) % gl.P for v in c]
                                              for c in ccs.c]
    else:
        assert sets.signs == (1, -1) and sets.rings is None
    calls = {}
    for name in ("lin_round0", "lin_roundr"):
        def counted(*a, _f=getattr(comb, name), _n=name):
            assert a[-2] is sets
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a)
        monkeypatch.setattr(comb, name, counted)
    dn.lin_prove(cms[0], dn.build_witness(dn.e.put(wits[0].w_ccs)),
                 Transcript())
    n_fact = accel_rounds._factored_rounds(dn._cap_pow2, ccs.s)
    assert n_fact >= 2
    assert (calls.get("lin_round0", 0), calls.get("lin_roundr", 0)) == (
        1, n_fact - 1)
