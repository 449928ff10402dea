"""prog.statecomm_s: seconds a step in the state, accumulator and IVC step
commitments, the program's span `step.state_comms`."""

from zkbench import progtrace


def read(w):
    return progtrace.span_per_step(w, "step.state_comms")
