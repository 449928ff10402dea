"""Two IVC steps of the torch port against the host prover at small params.

The full zkVM pipeline (all 125 matrices and 52 multisets) at the smallest
legal parameterization, B_SMALL = 4 (so the comb kernels' b_small stays
generic).  The port runs on the CPU twins here; the host reference is
``ZkVmProver(device=False)``.  Both must give the same ``acc_comm`` and
``ivc_step_comm`` after every step.  The host path takes minutes per step.
"""

import pytest

from latticeum_tpu.vm.assembler import fib_const_guest
from latticeum_tpu.vm.vm import new_vm_1mb
from latticeum_tpu.zkvm.params import resolve
from latticeum_tpu.zkvm.prover import ZkVmProver
from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver

STEPS = 2


def _run(prover):
    seen = []
    vm = new_vm_1mb().load_elf_data(fib_const_guest(0xC594BFC3))
    prover.prove_vm(vm, max_steps=STEPS,
                    on_step=lambda step, st: seen.append(
                        (step, list(st.acc_comm), st.ivc_step_comm)))
    return seen


@pytest.mark.slow
def test_small_params_two_steps_match_host():
    params = resolve(B=1 << 16, L=4, B_SMALL=4, K=8, KAPPA=8)
    port = _run(TorchZkVmProver(params=params, device="cpu"))
    host = _run(ZkVmProver(params=params, device=False))
    assert len(port) == STEPS
    assert port == host
