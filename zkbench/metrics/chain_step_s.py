"""chain_step_s: the window's wall time over the IVC steps folded in it,
step_s's own quantity, read per layer in the cells whose runs spread too
widely to bound it end to end (traced, so the profiler's cost is in it)."""


def read(w):
    if not w.steps:
        return None
    return (w.t1 - w.t0) / w.steps
