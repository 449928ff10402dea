"""statecomm_s: seconds a step in the state, accumulator and IVC step
commitments, spans around `_state_comm`, `acc_comm` and `ivc_step_comm`
as the prover calls them (the last two have no mark of the program's)."""

_M = "latticeum_tpu_torch.zkvm.prover"
TARGETS = {"statecomm_s": [(_M, "TorchZkVmProver._state_comm"),
                           (_M, "ZkVmCommitter.acc_comm"),
                           (_M, "ZkVmCommitter.ivc_step_comm")]}


def read(w):
    return w.span_per_step("statecomm_s")
