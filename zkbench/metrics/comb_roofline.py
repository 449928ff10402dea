"""comb_roofline: of the comb kernels in the window's trace
(fold_round0, fold_roundr, lin_round0, lin_roundr), the sum over their
launches of each launch's least time on the H100 (bounds.py), over the
sum of their measured durations, in %.  A kernel whose launches do not
match the main path's count is left out; other kernels are not
counted (they are named in the breakdown)."""

from zkbench import bounds


def read(w):
    if w.trace is None:
        return None
    return bounds.roofline_pct(w.trace.by_kernel(), w.steps)
