"""prog.idle_unspanned_pct: of the device's idle time in the window, the
share under no layer span of the program (its `step` span not counted),
each span mapped onto the profiler's clock through the window's two
anchors (`progtrace.anchors`)."""

from zkbench import progtrace


def read(w):
    return progtrace.idle_unspanned_pct(w)
