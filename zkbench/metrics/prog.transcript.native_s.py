"""prog.transcript.native_s: seconds a step inside the native Poseidon2
core's challenger calls (`observe_many`, `observe`, `sample`) and its state
access in export and import, the program's timer `transcript.native_s`;
`prog.transcript_s` less this is the Python around the core."""

from zkbench import progtrace


def read(w):
    return progtrace.counter_per_step(w, "transcript.native_s")
