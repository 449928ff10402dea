"""The port's host copy (latticeum_tpu_torch/host/) against the JAX package.

The port runs its own copies of the JAX package's host modules (CCS builder,
VM, NIFS host prover, commitments); each must compute what the original
does on the same inputs: the zkVM CCS at small params, the first VM traces
of a real guest, two chained host NIFS folds of the test fixtures, and the
zkVM commitments.  Tolerance: none (exact integers).  The two packages'
objects are different classes, so they are compared field by field."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from latticeum_tpu.crypto.transcript import Transcript as JaxTranscript
from latticeum_tpu.field import goldilocks as gl_jax
from latticeum_tpu.nifs import linearization as lin_jax, nifs as nifs_jax
from latticeum_tpu.nifs import test_fixtures as fx_jax
from latticeum_tpu.nifs.nifs import DecompositionParams as DpJax
from latticeum_tpu.nifs.structs import CCCS as CccsJax, Witness as WitJax
from latticeum_tpu.commit.ajtai import AjtaiScheme as AjtaiJax
from latticeum_tpu.vm.assembler import xorshift_guest as xs_jax
from latticeum_tpu.vm.vm import new_vm_1mb as vm_jax
from latticeum_tpu.zkvm import commitments as comm_jax
from latticeum_tpu.zkvm.builder import create_riscv_ccs as ccs_jax
from latticeum_tpu.zkvm.layout import CCSLayout as LayoutJax
from latticeum_tpu.zkvm.params import resolve as resolve_jax
from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme
from latticeum_tpu_torch.host.crypto.transcript import Transcript
from latticeum_tpu_torch.host.field import goldilocks as gl
from latticeum_tpu_torch.host.nifs import linearization as lin, nifs
from latticeum_tpu_torch.host.nifs import test_fixtures as fx
from latticeum_tpu_torch.host.nifs.nifs import DecompositionParams
from latticeum_tpu_torch.host.nifs.structs import CCCS, Witness
from latticeum_tpu_torch.host.vm.assembler import xorshift_guest
from latticeum_tpu_torch.host.vm.vm import new_vm_1mb
from latticeum_tpu_torch.host.zkvm import commitments as comm
from latticeum_tpu_torch.host.zkvm.builder import create_riscv_ccs
from latticeum_tpu_torch.host.zkvm.layout import CCSLayout
from latticeum_tpu_torch.host.zkvm.params import resolve
from latticeum_tpu_torch.zkvm.commitments import ZkVmCommitter

SMALL = dict(B=1 << 16, L=4, B_SMALL=4, K=8, KAPPA=8)
TRACES = 20


def arr(x):
    return np.asarray(x)


def same_limbs(a, b):
    return (np.array_equal(arr(a[0]), arr(b[0]))
            and np.array_equal(arr(a[1]), arr(b[1])))


# -- the zkVM CCS ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ccs_pair():
    return (create_riscv_ccs(CCSLayout(resolve(**SMALL))),
            ccs_jax(LayoutJax(resolve_jax(**SMALL))))


@pytest.mark.parametrize("part", ["dims", "matrices", "S", "c"])
def test_riscv_ccs_matches_jax(ccs_pair, part):
    ours, theirs = ccs_pair
    if part == "dims":
        keys = ("m", "n", "l", "t", "q", "d")
        assert ([getattr(ours, k) for k in keys]
                == [getattr(theirs, k) for k in keys])
    elif part == "matrices":
        assert len(ours.M) == len(theirs.M)
        for a, b in zip(ours.M, theirs.M):
            assert (a.nrows, a.ncols) == (b.nrows, b.ncols)
            assert np.array_equal(arr(a.rows), arr(b.rows))
            assert np.array_equal(arr(a.cols), arr(b.cols))
            assert same_limbs(a.vals, b.vals)
    else:
        assert ([list(map(int, x)) for x in getattr(ours, part)]
                == [list(map(int, x)) for x in getattr(theirs, part)])


# -- the VM -----------------------------------------------------------------------

def first_traces(vm):
    out = []

    def intercept(trace, _vm):
        if len(out) == TRACES:
            raise StopIteration
        out.append(dataclasses.asdict(trace))
    try:
        vm.run(intercept)
    except StopIteration:
        pass
    return out


@pytest.fixture(scope="module")
def trace_pair():
    return (first_traces(new_vm_1mb().load_elf_data(xorshift_guest(8))),
            first_traces(vm_jax().load_elf_data(xs_jax(8))))


@pytest.mark.parametrize("cycle", range(TRACES))
def test_vm_trace_matches_jax(trace_pair, cycle):
    ours, theirs = trace_pair
    assert len(ours) == len(theirs) == TRACES
    assert ours[cycle] == theirs[cycle]


# -- two chained host NIFS folds ----------------------------------------------------

def fold_chain(pkg):
    """Test CCS, two chained nifs.prove folds from the linearized zero
    accumulator; returns the accumulators, witnesses, proofs, transcript
    states of every fold."""
    (fxm, Wit, Cccs, Ajtai, glm, linm, nifsm, Tr, Dp) = pkg
    params = Dp(B=fxm.TEST_B, L=fxm.TEST_L, B_SMALL=fxm.TEST_B_SMALL,
                K=fxm.TEST_K)
    ccs = fxm.get_test_ccs()
    scheme, cms, wits = None, [], []
    for x in (3, 5):
        z = fxm.get_test_z(x)
        wit = Wit.from_w_ccs(fxm.z_to_device(z[2:]), fxm.TEST_B, fxm.TEST_L)
        if scheme is None:
            scheme = Ajtai.from_seed(kappa=4, n=wit.f[0].shape[0])
        cms.append(Cccs(cm=scheme.commit_host(wit.f), x_ccs=z[:1]))
        wits.append(wit)
    w = Wit.from_w_ccs(glm.zeros((ccs.n - ccs.l - 1, 24)), fxm.TEST_B,
                       fxm.TEST_L)
    acc, _, _ = linm.prove(Cccs(cm=scheme.commit_host(w.f),
                                x_ccs=[fxm.H.ntt_zero()]), w, Tr(), ccs)
    out = []
    for cm_i, wit in zip(cms, wits):
        t = Tr()
        acc, w, proof = nifsm.prove(acc, w, cm_i, wit, t, ccs, scheme,
                                    params)
        out.append(dict(acc=acc, w=w, proof=proof, state=list(t.ch.state)))
    return out


@pytest.fixture(scope="module")
def nifs_pair():
    return (fold_chain((fx, Witness, CCCS, AjtaiScheme, gl, lin, nifs,
                        Transcript, DecompositionParams)),
            fold_chain((fx_jax, WitJax, CccsJax, AjtaiJax, gl_jax, lin_jax,
                        nifs_jax, JaxTranscript, DpJax)))


@pytest.mark.parametrize("fold", [0, 1])
@pytest.mark.parametrize("part", ["proof", "accumulator", "transcript",
                                  "witness"])
def test_host_nifs_prove_matches_jax(nifs_pair, fold, part):
    ours, theirs = nifs_pair[0][fold], nifs_pair[1][fold]
    if part == "proof":
        assert ours["proof"] == theirs["proof"]
    elif part == "accumulator":
        for k in ("r", "v", "cm", "u", "x_w", "h"):
            assert getattr(ours["acc"], k) == getattr(theirs["acc"], k), k
    elif part == "transcript":
        assert ours["state"] == theirs["state"]
    else:
        for k in ("w_ccs", "f_coeff", "f", "f_hat"):
            assert same_limbs(getattr(ours["w"], k), getattr(theirs["w"], k))


# -- zkVM commitments ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["vm_code_comm", "acc_comm",
                                   "ivc_step_comm", "mem_ops_vec_comm"])
def test_commitments_match_jax(nifs_pair, which):
    ours, theirs = comm.ZkVmCommitter(), comm_jax.ZkVmCommitter()
    if which == "vm_code_comm":
        code = new_vm_1mb().load_elf_data(xorshift_guest(8)).elf.raw_code.bytes
        want = theirs.vm_code_comm(code)
        assert ours.vm_code_comm(code) == want
        assert ZkVmCommitter("cpu").vm_code_comm(code) == want
    elif which == "acc_comm":
        for a, b in zip(nifs_pair[0], nifs_pair[1]):
            assert ours.acc_comm(a["acc"]) == theirs.acc_comm(b["acc"])
    elif which == "ivc_step_comm":
        args = (3, [1, 2, 3, 4], [5, 6, 7, gl.P - 1], [0, 9, 10, 11])
        assert ours.ivc_step_comm(*args) == theirs.ivc_step_comm(*args)
    else:
        op = dataclasses.make_dataclass("Op", ["cycle", "address", "value"])(
            7, 0x11004, 0xDEADBEEF)
        assert (ours.vm_mem_ops_vec_comm([1, 2, 3, 4], op)
                == theirs.vm_mem_ops_vec_comm([1, 2, 3, 4], op))


# -- verbatim copies --------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _api(path):
    """The top-level names of a module, and the methods of its classes."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef)}
        if isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


@pytest.mark.parametrize("rel", ["ring/models.py", "nifs/generic.py",
                                 "nifs/serialize.py", "utils/security.py",
                                 "utils/tracing.py"])
def test_copy_is_verbatim(rel):
    """The ring models, the generic NIFS, the proof encoding and the MSIS
    check are copied unchanged: each reads its imports relative to the
    host tree, which keeps the original's layout.  The tracer is the
    port's own, extended in place: it keeps every name and method of the
    original.  Their behaviour against the originals:
    tests/test_torch_ring_models.py, tests/test_torch_generic_nifs.py,
    tests/test_torch_serialize.py."""
    ours = ROOT / "latticeum_tpu_torch" / "host" / rel
    theirs = ROOT / "latticeum_tpu" / rel
    if rel == "utils/tracing.py":
        assert _api(theirs) <= _api(ours)
    else:
        assert ours.read_text() == theirs.read_text()
