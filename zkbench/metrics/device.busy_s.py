"""device.busy_s: seconds a step in which something ran on the card (the
union of the device's activity in the window's trace), a step."""


def read(w):
    if w.trace is None or not w.trace.device:
        return None
    return w.trace.busy_s() / w.steps
