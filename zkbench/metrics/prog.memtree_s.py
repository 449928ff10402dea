"""prog.memtree_s: seconds a step in the memory tree's page update and the
memory-op chain, the program's span `step.memtree`."""

from zkbench import progtrace


def read(w):
    return progtrace.span_per_step(w, "step.memtree")
