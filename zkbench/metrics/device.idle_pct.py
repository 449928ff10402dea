"""device.idle_pct: the share of the window's wall time in which nothing
(no kernel, copy or set) ran on the card, from the torch.profiler trace
of the window."""


def read(w):
    if w.trace is None or not w.trace.device:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s())
