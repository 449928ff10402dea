"""prog.ajtai.dense_s: seconds a step in the dense Ajtai commitments (the
witnesses' digit split, the digit-plane contraction against the matrix),
the program's span `ajtai.dense`.  It does not wait for the device: it is
the host's time to launch the contraction."""

from zkbench import progtrace


def read(w):
    return progtrace.span_per_step(w, "ajtai.dense")
