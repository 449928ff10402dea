"""dec_s: seconds a step in the two decompositions, the program's marks
"dec_l" + "dec_r" of `TorchNifs.prove` (synchronized).  The span only
names the device's idle gaps."""

TARGETS = {"dec": [("latticeum_tpu_torch.zkvm.accel_nifs",
                    "TorchNifs.dec_prove")]}


def read(w):
    return w.timing_per_step("dec_l", "dec_r")
