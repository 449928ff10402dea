"""prog.dec.x_s_s: seconds a step in the host's `compute_x_s` inside the
two decompositions, the program's span `nifs.dec.compute_x_s`."""

from zkbench import progtrace


def read(w):
    return progtrace.span_per_step(w, "nifs.dec.compute_x_s")
