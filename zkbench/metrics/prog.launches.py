"""prog.launches: device kernels a step launched through the port's hand
kernel wrappers, the program's counter `kernel.launches` (each wrapper's
`launches`, times the kernels one call launches; `kernels.COUNTED`)."""

from zkbench import progtrace


def read(w):
    return progtrace.counter_per_step(w, "kernel.launches")
