"""The device's side of a traced window, from `torch.profiler`.

`Trace.read(prof, range_names)` takes the profiler's events once: the device's
activities (kernels, copies, sets) as intervals, and the benchmark's host
spans (its `record_function` ranges) as intervals on the same clock.
The window is the range named `WINDOW`, which the harness opens when the
measured window starts and closes when it ends.
"""

from __future__ import annotations

WINDOW = "zkb.window"
TOP = 10


class Trace:
    def __init__(self, device, ranges, window):
        self.device = device          # [(name, start_us, end_us)], sorted
        self.ranges = ranges          # [(name, start_us, end_us)]
        self.window = window          # (start_us, end_us)

    @staticmethod
    def read(prof, range_names):
        """The events of `prof`; `range_names` are the host spans that
        were opened as ranges."""
        from torch.autograd import DeviceType
        device, ranges, window = [], [], None
        for e in prof.events():
            tr = e.time_range
            if e.name == WINDOW or e.name in range_names:
                if e.device_type == DeviceType.CUDA:
                    continue              # a range's image on the device
                if e.name == WINDOW:
                    window = (tr.start, tr.end)
                else:
                    ranges.append((e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CUDA:
                device.append((e.name, tr.start, tr.end))
        device.sort(key=lambda d: d[1])
        return Trace(device, ranges, window)

    def in_window(self):
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.device
                if b > lo and a < hi]

    def busy_intervals(self):
        """The union of the device's activity inside the window."""
        out = []
        for _, a, b in self.in_window():
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def idle_gaps(self):
        """[(start_us, end_us)] where nothing ran on the device, inside
        the window, its two ends included."""
        lo, hi = self.window
        gaps, last = [], lo
        for a, b in self.busy_intervals():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if hi > last:
            gaps.append((last, hi))
        return gaps

    def top_ops(self, n=TOP):
        """[[kernel name, seconds in the window]], the n largest."""
        by = sorted(self.by_kernel().items(), key=lambda kv: -kv[1][1])
        return [[k, s] for k, (_, s) in by[:n]]

    def by_kernel(self):
        """{name: (launches, seconds)} inside the window."""
        out = {}
        for name, a, b in self.in_window():
            k, s = out.get(name, (0, 0.0))
            out[name] = (k + 1, s + (b - a) / 1e6)
        return out

    def gaps_by_span(self, n=TOP):
        """[[host span, idle seconds]]: the device's idle time inside the
        window, each instant given to the innermost benchmark span open
        then (the spans nest, as calls do), summed by name; time under no
        span goes to "(no span)".  The n largest."""
        # a sweep over every boundary: 0 closes a range, 1 opens one,
        # 2 ends a gap, 3 starts one (ties: close before open)
        marks = []
        for i, (_, a, b) in enumerate(self.ranges):
            marks += [(a, 1, i), (b, 0, i)]
        for a, b in self.idle_gaps():
            marks += [(a, 3, -1), (b, 2, -1)]
        marks.sort()
        out, stack, idle, last = {}, [], False, None
        for t, kind, i in marks:
            if idle and last is not None and t > last:
                name = self.ranges[stack[-1]][0] if stack else "(no span)"
                out[name] = out.get(name, 0.0) + (t - last) / 1e6
            last = t
            if kind == 1:
                stack.append(i)
            elif kind == 0:
                if i in stack:
                    stack.remove(i)
            else:
                idle = kind == 3
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:n]]
