"""arith_s: seconds a step in the host arithmetization, the benchmark's
span around `arithmetize` as the prover module calls it (the program's
own mark "arithmetize" also holds the page update and the memory-op
chain)."""

TARGETS = {"arith_s": [("latticeum_tpu_torch.zkvm.prover", "arithmetize")]}


def read(w):
    return w.span_per_step("arith_s")
