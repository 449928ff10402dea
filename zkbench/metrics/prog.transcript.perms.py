"""prog.transcript.perms: width-16 permutations of the host challenger a
step, the program's counter `transcript.perms` (from the native state's
buffer lengths around each call)."""

from zkbench import progtrace


def read(w):
    return progtrace.counter_per_step(w, "transcript.perms")
