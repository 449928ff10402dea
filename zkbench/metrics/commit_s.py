"""commit_s: seconds a step in `commit_z` (witness pipeline and Ajtai
commitment), the program's mark "commit_z", which ends in a fetch to the
host.  The span only names the device's idle gaps."""

TARGETS = {"commit": [("latticeum_tpu_torch.zkvm.prover",
                       "TorchZkVmProver.commit_z")]}


def read(w):
    return w.timing_per_step("commit_z")
