"""proof_setup_s: seconds of `prove_vm`'s set-up before its first step
(the code and memory trees, the initial accumulator and the first state
commitments): from the call of `prove_vm` to the first call of
`arithmetize`."""

_M = "latticeum_tpu_torch.zkvm.prover"
TARGETS = {"proof_setup_s": [(_M, "TorchZkVmProver.prove_vm")],
           "proof_setup_s.first_step": [(_M, "arithmetize")]}


def read(w):
    start = w.spans.first("proof_setup_s")
    step = w.spans.first("proof_setup_s.first_step")
    if start is None or step is None:
        return None
    return step[0] - start[0]
