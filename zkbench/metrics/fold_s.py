"""fold_s: seconds a step in the folding, the program's mark "fold" of
`TorchNifs.prove` (synchronized).  The span only names the device's idle
gaps."""

TARGETS = {"fold": [("latticeum_tpu_torch.zkvm.accel_nifs",
                     "TorchNifs.fold_prove")]}


def read(w):
    return w.timing_per_step("fold")
