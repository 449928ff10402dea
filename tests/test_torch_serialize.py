"""The port's copies of the proof encoding (host/nifs/serialize.py), the
MSIS check (host/utils/security.py) and the span tracer
(host/utils/tracing.py).

A fold proven by the port's TorchNifs (on the CPU twins) round-trips
through the byte encoding, whose bytes equal the JAX package's encoding
of the same proof, and the port's host verifier accepts the proof read
back from the bytes, as tests/test_nifs.py does for a host proof.  The
security check and the tracer against the originals.  Exact."""

import numpy as np

from latticeum_tpu.nifs import serialize as ser_jax
from latticeum_tpu.utils import security as sec_jax, tracing as tr_jax
from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme
from latticeum_tpu_torch.host.crypto.transcript import Transcript
from latticeum_tpu_torch.host.field import goldilocks as gl_host, host as H
from latticeum_tpu_torch.host.nifs import linearization as lin, nifs
from latticeum_tpu_torch.host.nifs import serialize as ser
from latticeum_tpu_torch.host.nifs import test_fixtures as fx
from latticeum_tpu_torch.host.nifs.nifs import DecompositionParams
from latticeum_tpu_torch.host.nifs.structs import CCCS, Witness
from latticeum_tpu_torch.host.utils import security as sec, tracing as tr
from latticeum_tpu_torch.zkvm.accel import Engine
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs

PARAMS = DecompositionParams(B=fx.TEST_B, L=fx.TEST_L,
                             B_SMALL=fx.TEST_B_SMALL, K=fx.TEST_K)


def port_fold():
    """One fold of the test CCS by TorchNifs on the CPU: (acc, cm_i,
    proof, folded accumulator)."""
    ccs = fx.get_test_ccs()
    z = fx.get_test_z(3)
    wit = Witness.from_w_ccs(fx.z_to_device(z[2:]), fx.TEST_B, fx.TEST_L)
    scheme = AjtaiScheme.from_seed(kappa=4, n=wit.f[0].shape[0])
    cm_i = CCCS(cm=scheme.commit_host(wit.f), x_ccs=z[:1])
    zero = Witness.from_w_ccs(gl_host.zeros((ccs.n - ccs.l - 1, 24)),
                              fx.TEST_B, fx.TEST_L)
    acc, _, _ = lin.prove(CCCS(cm=scheme.commit_host(zero.f),
                               x_ccs=[H.ntt_zero()]), zero, Transcript(), ccs)
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)
    folded, _, proof = dn.prove(acc, dn.build_witness(dn.e.put(zero.w_ccs)),
                                cm_i, dn.build_witness(dn.e.put(wit.w_ccs)),
                                Transcript())
    return ccs, acc, cm_i, proof, folded


def test_port_proof_serialization_roundtrip():
    ccs, acc, cm_i, proof, folded = port_fold()
    blob = ser.serialize_proof(proof)
    assert blob == ser_jax.serialize_proof(proof)
    assert ser.proof_size_bytes(proof) == len(blob)
    back = ser.deserialize_proof(blob)
    assert back["linearization"]["u"] == [list(u) for u in
                                         proof["linearization"]["u"]]
    assert back["folding"]["theta_s"] == [[list(t) for t in ts]
                                          for ts in proof["folding"]["theta_s"]]
    assert back["decomposition_l"]["y_s"] == [
        [list(y) for y in ys] for ys in proof["decomposition_l"]["y_s"]]
    # re-verify from the bytes: the host verifier folds to the same
    # accumulator the port proved
    assert nifs.verify(acc, cm_i, back, Transcript(), ccs, PARAMS) == folded


def test_security_check_reference_params():
    # production params: B=2^15, kappa=32, n=98815 (ccs.rs:26-50)
    assert sec.check_ring_modulus_128_bits_security(1 << 15, 32, 98815)
    assert sec.msis_l2_bound(32) > 0
    for kappa in (1, 8, 32, 64):
        assert sec.msis_l2_bound(kappa) == sec_jax.msis_l2_bound(kappa)
        for B, n in ((1 << 15, 98815), (1 << 40, 1 << 20)):
            assert (sec.check_ring_modulus_128_bits_security(B, kappa, n)
                    == sec_jax.check_ring_modulus_128_bits_security(
                        B, kappa, n))
    rows = np.random.default_rng(0).integers(0, H.P, (3, 24),
                                             dtype=np.uint64).tolist()
    rows[0][0] = H.P - 1
    assert sec.linf_norm(rows) == sec_jax.linf_norm(rows)
    assert sec.l2_norm_squared(rows) == sec_jax.l2_norm_squared(rows)


def test_tracer_spans_nest_and_count():
    """Nested spans record per path totals and calls, as the original's;
    a disabled tracer records nothing."""
    got = []
    for mod in (tr, tr_jax):
        lines = []
        t = mod.Tracer(enabled=True, log=lines.append)
        for _ in range(2):
            with t.span("fold"):
                with t.span("lin"):
                    pass
        got.append((dict(t.counts), sorted(t.totals), len(lines),
                    t.summary().splitlines()[0]))
        off = mod.Tracer(enabled=False, log=lines.append)
        with off.span("x"):
            pass
        assert not off.totals and len(lines) == 4
    assert got[0] == got[1]
    assert got[0][0] == {"fold/lin": 2, "fold": 2}
