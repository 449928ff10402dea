"""IVC driver with the fold step and the state trees on a torch device.

Counterpart of ``latticeum_tpu/zkvm/prover.py`` (``ZkVmProver`` with
``device=True``): run a guest, arithmetize each trace, commit, fold with a
fresh transcript per fold, collect the verifier vars, recompute the
state/acc/step commitments (main.rs:53-235 of the reference zkVM).

Arithmetization, the collector and the transcript are the host copy
(``..host``).  ``commit_z`` and the NIFS fold run as torch tensors on
`device` (``TorchNifs``), and the memory and code Merkle trees are built
there through the sponge8 and perm8 kernels (``commitments.py``);
``timings["trees"]`` is their host time in each ``prove_vm``.  With
``debug``, every step checks the CCS relation of its z on the device
before the commit (``timings["relation_check"]``) and every fold against
the host NIFS verifier (``timings["native_verify"]``).

    TorchZkVmProver(device="cuda").prove_vm(vm, max_steps=...)
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..field import goldilocks as gl
from ..host.commit.ajtai import AjtaiScheme
from ..host.crypto.transcript import ReplayTranscript, Transcript
from ..host.field import host as H
from ..host.nifs import nifs as nifs_mod
from ..host.nifs.nifs import DecompositionParams
from ..host.nifs.structs import CCCS
from ..host.zkvm import checkpoint as ckpt
from ..host.zkvm.builder import create_riscv_ccs
from ..host.zkvm.collect import generate_verification_witness_vars
from ..host.zkvm.commitments import ZERO_COMM, hash_wide
from ..host.zkvm.layout import CCSLayout
from ..host.zkvm.params import default_params
from ..host.zkvm.witness import IVCStepInput, arithmetize
from ..ring import rq
from .accel import Engine
from .accel_nifs import TorchNifs
from .commitments import IncrementalMemTree, ZkVmCommitter
from .tables import brev_on


@dataclass
class IVCState:
    ivc_step_comm: tuple
    ivc_step: int
    z_0_comm: list
    z_i_comm: list
    acc_comm: list
    acc: object
    w_acc: object
    folding_proof: object
    folding_proof_vars: object


class TorchZkVmProver:
    def __init__(self, params=None, scheme_seed: int = 0, device="cuda",
                 log=None, debug: bool = False,
                 reference_scheme: bool = False, general_ajtai: bool = False):
        """The prover runs on `device`, a card unless the caller names the
        CPU.  The Ajtai scheme: row-constant from `scheme_seed` (the
        default), the reference's matrix (`reference_scheme`, one ring
        element drawn from ark_std::test_rng, row-constant too), or a dense
        uniform matrix from `scheme_seed` (`general_ajtai`, a binding
        commitment; about 0.6 GB on the device at production size)."""
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchZkVmProver(device='cuda'): no CUDA device")
        self.params = params or default_params()
        self.layout = CCSLayout(self.params)
        self.ccs = create_riscv_ccs(self.layout)
        self.dp = DecompositionParams(B=self.params.B, L=self.params.L,
                                      B_SMALL=self.params.B_SMALL,
                                      K=self.params.K)
        n_ajtai = self.layout.w_size * self.params.L
        if reference_scheme:
            self.scheme = AjtaiScheme.from_reference_rng(self.params.KAPPA,
                                                         n_ajtai)
        elif general_ajtai:
            self.scheme = AjtaiScheme.from_seed_general(
                self.params.KAPPA, n_ajtai, seed=scheme_seed)
        else:
            self.scheme = AjtaiScheme.from_seed(self.params.KAPPA, n_ajtai,
                                                seed=scheme_seed)
        self.device = dev
        self.debug = debug
        self.committer = ZkVmCommitter(dev)
        self.timings = {}
        self.log = log
        self.dn = TorchNifs(Engine(self.ccs, dev), self.ccs, self.params,
                            self.scheme)

    # -- pieces ----------------------------------------------------------
    def initialize_accumulator(self, initial_step_comm=ZERO_COMM):
        """(main.rs:305-344): zero witness -> linearization -> initial acc."""
        x_ccs = [H.ntt_from_u64(int(v)) for v in initial_step_comm]
        w = np.zeros((self.layout.w_size, 24), np.uint32)
        wit = self.dn.build_witness(self.dn.e.put((w, w)))
        cm_i = CCCS(cm=self.dn.commit(wit.f), x_ccs=x_ccs)
        acc, _, _ = self.dn.lin_prove(cm_i, wit, Transcript(), log=self.log)
        return acc, wit

    def commit_z(self, z_rings):
        """(main.rs:347-367): split z, build the witness, Ajtai commit."""
        x_ccs = z_rings[:self.ccs.l]
        wit = self.dn.build_witness(self.dn.e.ints(z_rings[self.ccs.l + 1:]))
        return CCCS(cm=self.dn.commit(wit.f), x_ccs=x_ccs), wit

    def fold(self, acc, w_acc, cm_i, w_i):
        """Fresh transcript per fold (main.rs:379-404).  It records its
        sample stream so the verifier-vars collector replays the challenges
        without re-hashing."""
        t = Transcript(record_samples=True)
        self._last_fold_samples = t.samples
        return self.dn.prove(acc, w_acc, cm_i, w_i, t, log=self.log,
                             timings=self.timings)

    def verify_fold(self, acc, cm_i, proof):
        return nifs_mod.verify(acc, cm_i, proof, Transcript(), self.ccs,
                               self.dp)

    def check_relation(self, z_rings, trace):
        """Raise AssertionError unless z satisfies the CCS relation."""
        check_relation(self.dn.e, self.ccs, self.dn.e.ints(z_rings),
                       trace.instruction.name)

    def save_checkpoint(self, path, state, vm, mem_ops_comm):
        """The host checkpoint of `state`; the witness is kept as its
        f_coeff limbs."""
        host_w = SimpleNamespace(f_coeff=gl.to_limbs(state.w_acc.f_coeff))
        ckpt.save(path, dataclasses.replace(state, w_acc=host_w), vm,
                  mem_ops_comm, self.params)

    def load_checkpoint(self, path, vm):
        """(meta, acc, witness on the device, ivc_step_comm) of a checkpoint;
        restores the VM's machine state."""
        meta, acc, w_host, step_comm = ckpt.load(path, vm, self.params)
        f_coeff = self.dn.e.put((np.asarray(w_host.f_coeff[0]),
                                 np.asarray(w_host.f_coeff[1])))
        return meta, acc, self.dn.witness_from_f_coeff(f_coeff), step_comm

    # -- main loop --------------------------------------------------------
    def prove_vm(self, vm, max_steps=None, on_step=None,
                 checkpoint_dir=None, checkpoint_every=10, resume=False):
        """Run the loaded VM, folding every instruction. Returns IVCState.

        With checkpoint_dir, the resumable IVC state is written every
        `checkpoint_every` folds; resume=True restores the newest checkpoint
        (VM machine state included) and continues from there.
        """
        committer = self.committer
        t0 = time.perf_counter()
        code_comm = committer.vm_code_comm(vm.elf.raw_code.bytes)
        t_code = time.perf_counter() - t0

        start_cycle = 0
        resumed = None
        if resume and checkpoint_dir:
            path = ckpt.latest(checkpoint_dir)
            if path:
                resumed = self.load_checkpoint(path, vm)

        # one page tree on the device gives both the root and the levels;
        # both trees end in a fetch to the host, so the clock is synchronized
        t0 = time.perf_counter()
        mem_tree = IncrementalMemTree(vm, self.device, timings=self.timings)
        mem_comm = mem_tree.root
        self.timings.setdefault("trees.code", []).append(t_code)
        self.timings.setdefault("trees", []).append(
            t_code + time.perf_counter() - t0)

        if resumed is None:
            mem_ops_comm = list(ZERO_COMM)
            z_0_comm = self._state_comm(code_comm, vm.pc, mem_comm, vm.regs,
                                        mem_ops_comm)
            acc, w_acc = self.initialize_accumulator()
            acc_0_comm = committer.acc_comm(acc)
            step0_comm = committer.ivc_step_comm(0, z_0_comm, z_0_comm,
                                                 acc_0_comm)
            state = IVCState(ivc_step_comm=step0_comm, ivc_step=0,
                             z_0_comm=z_0_comm, z_i_comm=z_0_comm,
                             acc_comm=acc_0_comm, acc=acc, w_acc=w_acc,
                             folding_proof=None, folding_proof_vars=None)
        else:
            meta, acc_r, w_acc_r, step_comm_r = resumed
            mem_ops_comm = list(meta["mem_ops_comm"])
            state = IVCState(ivc_step_comm=step_comm_r,
                             ivc_step=meta["step"],
                             z_0_comm=meta["z_0_comm"],
                             z_i_comm=meta["z_i_comm"],
                             acc_comm=meta["acc_comm"], acc=acc_r,
                             w_acc=w_acc_r, folding_proof=None,
                             folding_proof_vars=meta["folding_proof_vars"])
            start_cycle = meta["step"]

        steps = [state.ivc_step]

        def intercept(trace, vm_ref):
            step = trace.cycle + 1
            if max_steps is not None and step > max_steps:
                raise StopIteration
            t0 = time.time()
            mem_op = trace.side_effects.memory_op
            nonlocal mem_comm, mem_ops_comm
            if mem_op is not None:
                page_idx, _ = vm_ref.physical_addr(mem_op.address & ~0b11)
                mem_tree.update_page(page_idx)
                mem_comm = mem_tree.root
                mem_ops_comm = committer.vm_mem_ops_vec_comm(mem_ops_comm,
                                                             mem_op)

            inp = IVCStepInput(
                ivc_step_comm=state.ivc_step_comm,
                ivc_step=step - 1,
                state_0_comm=state.z_0_comm,
                state_comm=state.z_i_comm,
                acc_comm=state.acc_comm,
                acc=state.acc,
                folding_proof_vars=state.folding_proof_vars,
                w_acc=state.w_acc,
                trace=trace,
            )

            def mark(name, _t=[t0]):
                now = time.time()
                self.timings.setdefault(name, []).append(now - _t[0])
                if self.log:
                    self.log(f" step.{name}: {now-_t[0]:.2f}s")
                _t[0] = now

            z = arithmetize(inp, self.layout)
            mark("arithmetize")
            if self.debug:
                self.check_relation(z, trace)
                mark("relation_check")
            cm_i, w_i = self.commit_z(z)
            mark("commit_z")
            folded_acc, folded_w, proof = self.fold(state.acc, state.w_acc,
                                                    cm_i, w_i)
            mark("fold_total")
            if self.debug:
                if self.verify_fold(state.acc, cm_i, proof) != folded_acc:
                    raise AssertionError(f"fold of step {step}: the host "
                                         "NIFS verifier disagrees")
                mark("native_verify")
            # replay the prover's recorded transcript samples (bit-exact)
            samples = self._last_fold_samples
            fvars = generate_verification_witness_vars(
                state.acc, cm_i, proof, self.ccs, self.dp,
                lambda: ReplayTranscript(samples))
            mark("collector")

            state_i_comm = self._state_comm(code_comm, trace.output.pc,
                                            mem_comm, trace.output.regs,
                                            mem_ops_comm)
            mark("state_comms")
            acc_comm = committer.acc_comm(folded_acc)
            step_comm = committer.ivc_step_comm(step, state.z_0_comm,
                                                state_i_comm, acc_comm)
            state.ivc_step_comm = step_comm
            state.ivc_step = step
            state.z_i_comm = state_i_comm
            state.acc_comm = acc_comm
            state.acc = folded_acc
            state.w_acc = folded_w
            state.folding_proof = proof
            state.folding_proof_vars = fvars
            steps[0] = step
            self.timings.setdefault("step_times", []).append(time.time() - t0)
            if checkpoint_dir and step % checkpoint_every == 0:
                os.makedirs(checkpoint_dir, exist_ok=True)
                self.save_checkpoint(os.path.join(
                    checkpoint_dir, f"ivc_step_{step}.npz"), state, vm_ref,
                    mem_ops_comm)
            if on_step:
                on_step(step, state)

        try:
            vm.run(intercept, start_cycle=start_cycle)
        except StopIteration:
            pass
        state.steps = steps[0]
        return state

    def _state_comm(self, code_comm, pc, mem_comm, regs, mem_ops_comm):
        regs_c = hash_wide(list(regs))
        return hash_wide(list(code_comm) + [pc] + list(mem_comm)
                         + list(regs_c) + list(mem_ops_comm))


def relation_residual(engine, ccs, z):
    """The CCS relation's residual sum_i c_i prod_{j in S_i} M_j z over the
    rows the matrices reach, rounded up to a power of two (at most m):
    (rows, 24), zero where z satisfies it.  Counterpart of the JAX
    ``ZkVmProver._relation_residual_device`` (prover.py:402)."""
    mz = engine.mz_stack(z)                                # (t, 24, rows)
    mz = mz[..., brev_on(mz.shape[-1], mz.device)].transpose(1, 2)
    consts = gl.from_int([list(c) for c in ccs.c], engine.device)
    total = None
    for c, S in zip(consts, ccs.S):
        prod = mz[S[0]]
        for j in S[1:]:
            prod = rq.ntt_mul(prod, mz[j])
        term = rq.ntt_mul(prod, c[None])
        total = term if total is None else gl.add(total, term)
    return total


def check_relation(engine, ccs, z, what):
    """Raise AssertionError naming `what` and the first failing rows unless
    the residual of z is zero."""
    bad = torch.nonzero((relation_residual(engine, ccs, z) != 0).any(-1))
    if len(bad):
        raise AssertionError(f"CCS relation failed for {what} at rows "
                             f"{bad[:10, 0].tolist()}")
