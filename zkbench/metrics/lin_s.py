"""lin_s: seconds a step in the linearization, the program's mark "lin"
of `TorchNifs.prove` (synchronized).  The span only names the device's
idle gaps."""

TARGETS = {"lin": [("latticeum_tpu_torch.zkvm.accel_nifs",
                    "TorchNifs.lin_prove")]}


def read(w):
    return w.timing_per_step("lin")
