"""The program's own spans and counters in a traced window.

The port's tracer (`latticeum_tpu_torch.host.utils.tracing.GLOBAL`) records
while a `torch.profiler` session runs, so a `--trace 1` run holds the
program's layer spans, (name, start, end) on `time.perf_counter()`, the
clock of the window's `w.t0` and `w.t1`, and one step record a step,
(start, end, {counter: change}).  A reader counts only the spans and step
records that lie inside [w.t0, w.t1], over `w.steps`.  Where the program
has no such tracer (a checkout before it), or recorded nothing there, every
reader here returns None.

The spans share a clock with the device trace through two anchors: the
harness opens its window range (`w.trace.window`, profiler microseconds)
right before it reads `w.t0`, and closes it right after it reads `w.t1`.
A program instant maps linearly through the two.
"""

from __future__ import annotations

import re

STEP = "step"


def tracer():
    """The program's tracer, or None where it keeps no spans and steps."""
    try:
        from latticeum_tpu_torch.host.utils import tracing
    except ImportError:
        return None
    t = getattr(tracing, "GLOBAL", None)
    if not isinstance(getattr(t, "spans", None), list) or \
            not isinstance(getattr(t, "steps", None), list):
        return None
    return t


def spans_in(w, name=None):
    """[(name, start, end)] of the program's spans inside the window (of
    `name` only, where given)."""
    t = tracer()
    if t is None or not w.steps:
        return []
    return [(n, a, b) for n, a, b in t.spans
            if (name is None or n == name) and a >= w.t0 and b <= w.t1]


def span_per_step(w, name):
    """Seconds a step inside the program's span `name`; None if it never
    ran in the window."""
    found = spans_in(w, name)
    if not found:
        return None
    return sum(b - a for _, a, b in found) / w.steps


def steps_in(w):
    """The step records ({counter: change}) of the window's steps."""
    t = tracer()
    if t is None or not w.steps:
        return []
    return [d for a, b, d in t.steps if a >= w.t0 and b <= w.t1]


def counter_per_step(w, name):
    """The change in counter `name` over the window's steps, a step; None
    where no step record holds it."""
    recs = [d for d in steps_in(w) if name in d]
    if not recs:
        return None
    return sum(d[name] for d in recs) / w.steps


# -- the program's spans on the device trace's clock ------------------------
def anchors(w):
    """(scale, offset): profiler us = offset + scale * perf_counter s, the
    line through (w.t0, window start) and (w.t1, window end); None
    without a window."""
    if w.trace is None or w.trace.window is None or w.t1 <= w.t0:
        return None
    lo, hi = w.trace.window
    scale = (hi - lo) / (w.t1 - w.t0)
    return scale, lo - scale * w.t0


def anchor_drift_us(w):
    """How far the two anchors' offsets (profiler us - perf_counter us)
    differ, in us: the clocks' disagreement over the window."""
    if anchors(w) is None:
        return None
    lo, hi = w.trace.window
    return (hi - w.t1 * 1e6) - (lo - w.t0 * 1e6)


def mapped(w, spans):
    """Program (name, start, end) -> (name, start_us, end_us) on the
    profiler's clock."""
    scale, off = anchors(w)
    return [(n, off + scale * a, off + scale * b) for n, a, b in spans]


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys):
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_unspanned_pct(w):
    """Of the device's idle time in the window, the share under no layer
    span of the program (the step's own span not counted), in %."""
    layers = [s for s in spans_in(w) if s[0] != STEP]
    if not layers or anchors(w) is None:
        return None
    gaps = [list(g) for g in w.trace.idle_gaps()]
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    covered = union((a, b) for _, a, b in mapped(w, layers))
    return 100.0 * (idle - overlap(gaps, covered)) / idle


# -- the counters against the device trace ----------------------------------
def kernel_pattern(names):
    return re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
        re.escape(n) for n in names) + r")(?![A-Za-z0-9_])")


def hand_kernels():
    """The device kernel names of the port's hand kernels, or None."""
    try:
        from latticeum_tpu_torch import kernels
    except ImportError:
        return None
    table = getattr(kernels, "DEVICE_KERNELS", None)
    if not table:
        return None
    return sorted({k for ks in table.values() for k in ks})


def device_launches(w, names):
    """{kernel name: launches} of the device events that start in the
    window and carry one of `names`."""
    lo, hi = w.trace.window
    pat = kernel_pattern(names)
    out = {}
    for name, a, _ in w.trace.device:
        m = pat.search(name) if lo <= a < hi else None
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def device_copies(w, kind="DtoH"):
    """Launches of the window's memcpy events of `kind`, by name."""
    lo, hi = w.trace.window
    out = {}
    for name, a, _ in w.trace.device:
        if lo <= a < hi and "Memcpy" in name and kind in name:
            out[name] = out.get(name, 0) + 1
    return out


def launches_outside(w, names, span):
    """Launches of `names` in the window that start outside every mapped
    program span `span`: (outside, all)."""
    spans = union((a, b) for _, a, b in mapped(w, spans_in(w, span)))
    lo, hi = w.trace.window
    pat = kernel_pattern(names)
    starts = [a for n, a, _ in w.trace.device
              if lo <= a < hi and pat.search(n)]
    outside = sum(1 for a in starts
                  if not any(s <= a <= e for s, e in spans))
    return outside, len(starts)
