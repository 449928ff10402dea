"""prog.arith_s: seconds a step in the host arithmetization, the program's
own span `step.arithmetize` (`arithmetize` alone; the page update is
`step.memtree`)."""

from zkbench import progtrace


def read(w):
    return progtrace.span_per_step(w, "step.arithmetize")
