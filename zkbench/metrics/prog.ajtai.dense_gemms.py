"""prog.ajtai.dense_gemms: `torch._int_mm` launches a step made for the
dense Ajtai commitments, the program's counter `ajtai.dense.gemms` (the
evaluation claims' contractions are not counted)."""

from zkbench import progtrace


def read(w):
    return progtrace.counter_per_step(w, "ajtai.dense.gemms")
