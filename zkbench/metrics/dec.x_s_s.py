"""dec.x_s_s: seconds a step in the host's `compute_x_s` (the statement's
decomposition inside each dec), the span around it as `accel_nifs` calls
it (`dec.compute_x_s`)."""

TARGETS = {"dec.x_s_s": [("latticeum_tpu_torch.zkvm.accel_nifs",
                          "dec.compute_x_s")]}


def read(w):
    return w.span_per_step("dec.x_s_s")
