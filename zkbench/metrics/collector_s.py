"""collector_s: seconds a step in the verifier-vars collector, the
program's mark "collector".  The span only names the device's idle
gaps."""

TARGETS = {"collector": [("latticeum_tpu_torch.zkvm.prover",
                          "generate_verification_witness_vars")]}


def read(w):
    return w.timing_per_step("collector")
