"""prog.fetches: device -> host copies a step made through the port's fetch
helpers (`goldilocks.to_u64`/`to_limbs`, the sum-checks' one fetch), the
program's counter `fetch.count`."""

from zkbench import progtrace


def read(w):
    return progtrace.counter_per_step(w, "fetch.count")
