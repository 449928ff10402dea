"""prog.ckpt_s: seconds a step in writing checkpoints (every tenth fold),
the program's span `step.checkpoint`, averaged over all the window's
steps."""

from zkbench import progtrace


def read(w):
    return progtrace.span_per_step(w, "step.checkpoint")
