"""The port prover's options against the JAX package and the host copy:
the general (dense) and the reference Ajtai schemes, the debug relation
check, checkpoint/resume and the CLI.

Pins (tolerance: none, exact integers):
  * the general commit (a digit-plane contraction against the dense
    matrix, of which TorchNifs keeps only the planes) equals a Python-int
    matvec and the plain chunked slot products;
  * two chained TorchNifs folds under ``from_seed_general`` equal the host
    NIFS with the same scheme, and the host verifier accepts them;
  * the reference-scheme commit equals the host ``AjtaiScheme.commit``;
  * the relation residual is zero on a valid test-CCS z and equals the
    host ``ccs.relation_residual``; with one entry changed it is nonzero
    and the check raises;
  * a checkpoint of the port's state restores it exactly;
  * the CLI asks for the card unless told otherwise.
The ``cuda`` test folds steps 1-3 of a guest continuously, then 1-2 with a
checkpoint, then resumes in a fresh prover (tests/test_resume_chain.py)."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.commit.ajtai import AjtaiScheme as JaxAjtaiScheme
from latticeum_tpu.crypto.transcript import Transcript
from latticeum_tpu.field import goldilocks as gl_ref, host as H
from latticeum_tpu.nifs import linearization as lin, nifs
from latticeum_tpu.nifs.nifs import DecompositionParams
from latticeum_tpu.nifs.structs import CCCS, Witness
from latticeum_tpu.nifs.test_fixtures import (TEST_B, TEST_B_SMALL, TEST_K,
                                              TEST_L, get_test_ccs,
                                              get_test_z, z_to_device)
from latticeum_tpu.ring import ref_impl as RI
from latticeum_tpu_torch import convert
from latticeum_tpu_torch.field import goldilocks as gl, mxu
from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme
from latticeum_tpu_torch.host.nifs.structs import LCCCS
from latticeum_tpu_torch.host.vm.assembler import fib_const_guest
from latticeum_tpu_torch.host.vm.vm import new_vm_1mb
from latticeum_tpu_torch.host.zkvm import checkpoint as ckpt
from latticeum_tpu_torch.host.zkvm.params import resolve
from latticeum_tpu_torch.zkvm import accel_nifs, cli
from latticeum_tpu_torch.zkvm import prover as prover_mod
from latticeum_tpu_torch.zkvm.accel import Engine
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs
from latticeum_tpu_torch.zkvm.prover import IVCState, TorchZkVmProver

PARAMS = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                             K=TEST_K)
SMALL = dict(B=1 << 16, L=4, B_SMALL=4, K=8, KAPPA=8)


def test_general_commit_matches_int_matvec():
    kappa, n = 3, 7
    scheme = AjtaiScheme.from_seed_general(kappa, n, seed=5)
    dn = TorchNifs(Engine(get_test_ccs(), "cpu"), get_test_ccs(), PARAMS,
                   scheme)
    assert dn.general_ajtai and dn.ajtai_rows is None
    rng = np.random.default_rng(1)
    f_int = rng.integers(0, gl.P, size=(n, 24), dtype=np.uint64).astype(
        object)
    f = gl.from_int(f_int)
    mat_t = gl.from_limbs(scheme.matrix)
    assert torch.equal(dn._ajtai_planes.data, mxu.digit_split(mat_t).data)
    mat = gl.to_int_lists(mat_t)
    want = []
    for k in range(kappa):
        acc = H.ntt_zero()
        for i in range(n):
            acc = H.ntt_add(acc, RI.ntt_mul(mat[k][i],
                                            [int(v) for v in f_int[i]]))
        want.append(acc)
    assert dn.commit(f) == want
    assert gl.to_int_lists(accel_nifs.matvec_general(mat_t, f)) == want
    with B.numpy_mode():
        assert scheme.commit_host(gl.to_limbs(f)) == want


def _chain_fixture(make_scheme):
    """Test CCS, two CCCS with witnesses and the initial accumulator, all
    committed with the JAX package's scheme from `make_scheme(n)`."""
    ccs = get_test_ccs()
    scheme, cms, wits = None, [], []
    for x in (3, 5):
        z = get_test_z(x)
        wit = Witness.from_w_ccs(z_to_device(z[2:]), TEST_B, TEST_L)
        if scheme is None:
            scheme = make_scheme(int(wit.f[0].shape[0]))
        cms.append(CCCS(cm=scheme.commit_host(wit.f), x_ccs=z[:1]))
        wits.append(wit)
    acc_wit = Witness.from_w_ccs(gl_ref.zeros((ccs.n - ccs.l - 1, 24)),
                                 TEST_B, TEST_L)
    acc, _, _ = lin.prove(CCCS(cm=scheme.commit_host(acc_wit.f),
                               x_ccs=[H.ntt_zero()]), acc_wit, Transcript(),
                          ccs)
    return ccs, scheme, cms, wits, acc, acc_wit


def test_general_scheme_folds_match_host():
    ccs, scheme, cms, wits, acc, acc_wit = _chain_fixture(
        lambda n: JaxAjtaiScheme.from_seed_general(4, n, seed=2))
    port_scheme = AjtaiScheme.from_seed_general(4, scheme.n, seed=2)
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, port_scheme)
    assert dn.general_ajtai
    acc_h, w_h, acc_d = acc, acc_wit, acc
    w_d = dn.build_witness(dn.e.put(acc_wit.w_ccs))
    for step, (cm_i, wit) in enumerate(zip(cms, wits)):
        th, td = Transcript(), Transcript()
        acc_prev = acc_h
        acc_h, w_h, ph = nifs.prove(acc_h, w_h, cm_i, wit, th, ccs, scheme,
                                    PARAMS)
        w_i = dn.build_witness(dn.e.put(wit.w_ccs))
        assert dn.commit(w_i.f) == cm_i.cm
        acc_d, w_d, pd = dn.prove(acc_d, w_d, cm_i, w_i, td)
        assert list(td.ch.state) == list(th.ch.state), f"transcript {step}"
        assert acc_d == convert.lcccs(acc_h), f"accumulator, fold {step}"
        assert pd == ph, f"proof, fold {step}"
        ver = nifs.verify(acc_prev, cm_i, pd, Transcript(), ccs, PARAMS)
        assert convert.lcccs(ver) == acc_d


def test_reference_scheme_commit_matches_host():
    ccs = get_test_ccs()
    wit = Witness.from_w_ccs(z_to_device(get_test_z(3)[2:]), TEST_B, TEST_L)
    n = int(wit.f[0].shape[0])
    scheme = AjtaiScheme.from_reference_rng(4, n)
    dn = TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)
    assert not dn.general_ajtai
    f = dn.build_witness(dn.e.put(wit.w_ccs)).f
    want = scheme.commit_host(gl.to_limbs(f))
    assert dn.commit(f) == want
    assert want == JaxAjtaiScheme.from_reference_rng(4, n).commit_host(wit.f)


def test_prover_schemes_and_options():
    params = resolve(**SMALL)
    ref = TorchZkVmProver(params, device="cpu", reference_scheme=True,
                          debug=True)
    n = ref.layout.w_size * params.L
    assert ref.debug and ref.scheme.row_constant
    assert torch.equal(ref.dn.ajtai_rows, gl.from_limbs(
        AjtaiScheme.from_reference_rng(params.KAPPA, n).rows_limbs))
    gen = TorchZkVmProver(params, device="cpu", general_ajtai=True,
                          scheme_seed=3)
    assert gen.dn.general_ajtai and not gen.debug
    mat = gl.from_limbs(
        AjtaiScheme.from_seed_general(params.KAPPA, n, seed=3).matrix)
    assert torch.equal(gen.dn._ajtai_planes.data, mxu.digit_split(mat).data)
    rng = np.random.default_rng(0)
    f = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, gl.P, (2, n, 24), dtype=np.uint64)))
    assert torch.equal(gen.dn._commit_many(f),
                       accel_nifs.matvec_general(mat, f))


def test_relation_residual_matches_host_and_check_raises():
    ccs = get_test_ccs()
    e = Engine(ccs, "cpu")
    z = get_test_z(3)
    res = prover_mod.relation_residual(e, ccs, e.ints(z))
    with B.numpy_mode():
        host = ccs.relation_residual(ccs.matvecs(z_to_device(z)))
    host = gl_ref.to_int((np.asarray(host[0]), np.asarray(host[1])))
    rows = res.shape[0]
    assert gl.to_int_lists(res) == host[:rows].tolist()
    assert not host[rows:].any() and not res.any()
    prover_mod.check_relation(e, ccs, e.ints(z), "test z")
    bad = [list(r) for r in z]
    bad[3] = [(v + 1) % gl.P for v in bad[3]]
    res_bad = prover_mod.relation_residual(e, ccs, e.ints(bad))
    with B.numpy_mode():
        host_bad = ccs.relation_residual(ccs.matvecs(z_to_device(bad)))
    host_bad = gl_ref.to_int((np.asarray(host_bad[0]),
                              np.asarray(host_bad[1])))
    assert res_bad.any()
    assert gl.to_int_lists(res_bad) == host_bad[:rows].tolist()
    with pytest.raises(AssertionError, match="CCS relation failed for bad z"):
        prover_mod.check_relation(e, ccs, e.ints(bad), "bad z")


def test_checkpoint_restores_state(tmp_path):
    """save_checkpoint then load_checkpoint in a fresh prover: the witness
    (rebuilt on the device from its f_coeff limbs), the accumulator, the
    commitments and the VM's machine state come back exactly."""
    params = resolve(**SMALL)
    p1 = TorchZkVmProver(params, device="cpu")
    rng = np.random.default_rng(9)

    def rings(k):
        return [[int(v) for v in rng.integers(0, gl.P, 24, dtype=np.uint64)]
                for _ in range(k)]

    w = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, gl.P, (p1.layout.w_size, 24), dtype=np.uint64)))
    wit = p1.dn.build_witness(w)
    acc = LCCCS(r=rings(p1.ccs.s), v=rings(3), cm=rings(params.KAPPA),
                u=rings(p1.ccs.t), x_w=rings(4), h=rings(1)[0])
    state = IVCState(ivc_step_comm=([1, 2, 3, 4], [[5, 6], [7, 8]]),
                     ivc_step=2, z_0_comm=[9, 10, 11, 12],
                     z_i_comm=[13, 14, 15, 16], acc_comm=[17, 18, 19, 20],
                     acc=acc, w_acc=wit, folding_proof=None,
                     folding_proof_vars=[[21, 22], 23])
    vm = new_vm_1mb().load_elf_data(fib_const_guest(0xC594BFC3))
    vm.pc, vm.regs[5] = vm.pc + 8, 77
    vm.memory[3][:4] = b"\x01\x02\x03\x04"
    path = str(tmp_path / "ivc_step_2.npz")
    p1.save_checkpoint(path, state, vm, [24, 25, 26, 27])
    assert ckpt.latest(str(tmp_path)) == path

    p2 = TorchZkVmProver(params, device="cpu")
    vm2 = new_vm_1mb().load_elf_data(fib_const_guest(0xC594BFC3))
    meta, acc2, wit2, step_comm = p2.load_checkpoint(path, vm2)
    for k in ("w_ccs", "f_coeff", "f", "f_hat"):
        assert torch.equal(getattr(wit2, k), getattr(wit, k)), k
    assert acc2 == acc and step_comm == state.ivc_step_comm
    assert (meta["step"], meta["z_0_comm"], meta["z_i_comm"],
            meta["acc_comm"], meta["mem_ops_comm"],
            meta["folding_proof_vars"]) == (
        2, state.z_0_comm, state.z_i_comm, state.acc_comm,
        [24, 25, 26, 27], state.folding_proof_vars)
    assert (vm2.pc, vm2.regs) == (vm.pc, vm.regs)
    assert all(bytes(a) == bytes(b) for a, b in zip(vm2.memory, vm.memory))


def test_cli_asks_for_the_card():
    args = ["--builtin", "fib100", "--max-steps", "1", "--vm-size", "1mb"]
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    with pytest.raises(SystemExit):
        cli.main(args + ["--device", "tpu"])


@pytest.mark.cuda
def test_resume_chain_matches_continuous_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    params = resolve(**SMALL)

    def vm():
        return new_vm_1mb().load_elf_data(fib_const_guest(0xC594BFC3))

    prover = TorchZkVmProver(params, device="cuda")
    st_a = prover.prove_vm(vm(), max_steps=3)
    prover.prove_vm(vm(), max_steps=2, checkpoint_dir=str(tmp_path),
                    checkpoint_every=2)
    fresh = TorchZkVmProver(params, device="cuda", debug=True)
    st_c = fresh.prove_vm(vm(), max_steps=3, checkpoint_dir=str(tmp_path),
                          resume=True)
    assert st_c.steps == st_a.steps == 3
    assert len(fresh.timings["relation_check"]) == 1
    for k in ("acc_comm", "z_i_comm", "ivc_step_comm", "folding_proof_vars"):
        assert getattr(st_c, k) == getattr(st_a, k), k
    for k in ("h", "r", "v", "cm", "u"):
        assert getattr(st_c.acc, k) == getattr(st_a.acc, k), k
