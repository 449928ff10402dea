"""prog.transcript_s: seconds a step in the host transcript, the program's
timer `transcript.s` around each absorb, sample, export and import method
of `Transcript` and `ReplayTranscript` (a call inside another counts
once), from the step records."""

from zkbench import progtrace


def read(w):
    return progtrace.counter_per_step(w, "transcript.s")
