"""IVC checkpoint / resume.

The reference keeps IVC state only in memory; its 9.5-hour EVM run died with
no recovery path (dp3 evaluation.tex:113-121).  Here the full resumable
state — step counter, commitments, running accumulator (LCCCS), accumulator
witness (stored compactly as f_coeff), memory-op chain, and the VM machine
state — is serialized to a single .npz so a prover process can restart from
the last completed fold.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..field import goldilocks as gl
from ..nifs.structs import LCCCS, Witness


def _rings_to_np(rings):
    return np.array([[int(v) & 0xFFFFFFFFFFFFFFFF for v in r]
                     for r in rings], dtype=np.uint64)


def _np_to_rings(arr):
    return [[int(v) for v in row] for row in arr]


def save(path: str, state, vm, mem_ops_comm, params):
    """Serialize IVCState + VM machine state after a completed fold."""
    acc = state.acc
    lo = np.asarray(state.w_acc.f_coeff[0])
    hi = np.asarray(state.w_acc.f_coeff[1])
    meta = {
        "step": state.ivc_step,
        "z_0_comm": state.z_0_comm,
        "z_i_comm": state.z_i_comm,
        "acc_comm": state.acc_comm,
        "mem_ops_comm": mem_ops_comm,
        "pc": vm.pc,
        "regs": vm.regs,
        "heap": [vm.heap.start, vm.heap.end, vm.heap.next],
        "reserved": vm.reserved_word_addr,
    }
    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        acc_r=_rings_to_np(acc.r), acc_v=_rings_to_np(acc.v),
        acc_cm=_rings_to_np(acc.cm), acc_u=_rings_to_np(acc.u),
        acc_xw=_rings_to_np(acc.x_w), acc_h=_rings_to_np([acc.h]),
        # the collected verifier vars of the LAST fold feed the NEXT step's
        # folding-proof witness region — dropping them diverges the chain
        # (different z, different h_i) on the first post-resume step
        fvars=json.dumps(state.folding_proof_vars, default=int),
        w_f_coeff_lo=lo, w_f_coeff_hi=hi,
        memory=np.frombuffer(
            b"".join(bytes(p) for p in vm.memory), dtype=np.uint8),
        step_comm_digest=np.array(state.ivc_step_comm[0], dtype=np.uint64),
        step_comm_states=json.dumps(state.ivc_step_comm[1]),
    )


def load(path: str, vm, params):
    """Restore (state_fields dict, acc LCCCS, w_acc Witness) and mutate vm."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    meta["folding_proof_vars"] = (
        json.loads(str(data["fvars"])) if "fvars" in data else None)
    acc = LCCCS(
        r=_np_to_rings(data["acc_r"]), v=_np_to_rings(data["acc_v"]),
        cm=_np_to_rings(data["acc_cm"]), u=_np_to_rings(data["acc_u"]),
        x_w=_np_to_rings(data["acc_xw"]),
        h=_np_to_rings(data["acc_h"])[0])
    f_coeff = (data["w_f_coeff_lo"], data["w_f_coeff_hi"])
    w_acc = Witness.from_f_coeff(f_coeff, params.B, params.L)
    # restore VM
    raw = data["memory"].tobytes()
    page_bytes = 4 * vm.words_per_page
    for i in range(vm.page_count):
        vm.memory[i][:] = raw[i * page_bytes:(i + 1) * page_bytes]
    vm.pc = meta["pc"]
    vm.regs = list(meta["regs"])
    vm.heap.start, vm.heap.end, vm.heap.next = meta["heap"]
    vm.reserved_word_addr = meta["reserved"]
    step_comm = ([int(v) for v in data["step_comm_digest"]],
                 json.loads(str(data["step_comm_states"])))
    return meta, acc, w_acc, step_comm


def latest(checkpoint_dir: str):
    """Most recent checkpoint file in a directory, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    files = [f for f in os.listdir(checkpoint_dir)
             if f.startswith("ivc_step_") and f.endswith(".npz")]
    if not files:
        return None
    files.sort(key=lambda f: int(f.split("_")[2].split(".")[0]))
    return os.path.join(checkpoint_dir, files[-1])
