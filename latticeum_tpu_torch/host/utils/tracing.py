"""The prover's tracer: layer spans, counters and timers, and a summary.

The analog of the reference's `tracing` + span-close timing setup
(zkvm/src/main.rs:56-63, #[instrument] spans on commitment/folding phases).

One tracer a process, `GLOBAL`, on where LATTICEUM_TRACE=1 (read once, at
import) and, besides, for as long as a `torch.profiler` session runs.  Off,
a span or counter costs a check of that state and records nothing.  On:

  * a span records (name, start, end) on `time.perf_counter()` as it
    closes, and its seconds under the path of the spans open around it
    (`totals`, `counts`, as the original's);
  * a counter is an integer (`add`), a timer a counter of seconds
    (`timer`, `timed`) that records no span; a timer opened inside one of
    its own name counts once;
  * the span named STEP records, as it closes, the change over it in every
    counter and in every registered source (`source`: a function giving a
    running total, such as the kernel wrappers' launch counters): one
    (start, end, {counter: change}) in `steps` a span.

A span given `timings` (a dict of lists) and `key` appends its seconds to
timings[key] on every call, on or off; one given `wait` calls it before it
reads the clock to close (a device synchronize); one given `log` prints a
line to it as it closes.  No span opens a profiler range.  A tracer prints
a line a span only to the `log` its maker gives.
"""

from __future__ import annotations

import functools
import os
import time
from collections import defaultdict

try:
    from torch.autograd import profiler as _profiler
except ImportError:                  # the host protocol runs without torch
    class _profiler:                 # noqa: N801
        _is_profiler_enabled = False

ENV = os.environ.get("LATTICEUM_TRACE", "0") == "1"
STEP = "step"
SOURCES = {}            # counter name -> function giving its running total


class _Off:
    """The span or timer of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "on", "timings", "key", "wait", "log",
                 "t0", "before")

    def __init__(self, tracer, name, on, timings, key, wait, log):
        self.tracer, self.name, self.on = tracer, name, on
        self.timings, self.key, self.wait, self.log = timings, key, wait, log

    def __enter__(self):
        if self.on:
            self.tracer._stack.append(self.name)
            if self.name == STEP:
                self.before = self.tracer.running()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tracer
        if exc_type is None and self.wait is not None:
            self.wait()
        t1 = time.perf_counter()
        dt = t1 - self.t0
        if self.on:
            full = "/".join(tr._stack)
            tr._stack.pop()
        if exc_type is not None:
            return False
        if self.timings is not None:
            self.timings.setdefault(self.key, []).append(dt)
        if self.log:
            self.log(f"  {self.name}: {dt:.2f}s")
        if self.on:
            tr.totals[full] += dt
            tr.counts[full] += 1
            tr.spans.append((self.name, self.t0, t1))
            if self.name == STEP:
                now = tr.running()
                tr.steps.append((self.t0, t1, {
                    k: v - self.before.get(k, 0) for k, v in now.items()}))
            if tr.log:
                tr.log(f"[trace] {full}: {dt:.3f}s")
        return False


class _Timer:
    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        if self.name in self.tracer._timing:
            self.t0 = None                    # the outer call counts it
        else:
            self.tracer._timing.add(self.name)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            self.tracer.counters[self.name] += time.perf_counter() - self.t0
            self.tracer._timing.discard(self.name)
        return False


class Tracer:
    def __init__(self, enabled: bool | None = None, log=None):
        """`enabled`: True or False, or None to follow the process
        (LATTICEUM_TRACE=1, or a torch.profiler session running).
        `log`: where a line goes as each span closes (none by default)."""
        self.enabled = enabled
        self.log = log
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = []              # (name, start, end), in closing order
        self.counters = defaultdict(int)
        self.steps = []              # (start, end, {counter: change})
        self._stack = []
        self._timing = set()

    def on(self) -> bool:
        if self.enabled is None:
            return ENV or _profiler._is_profiler_enabled
        return self.enabled

    def span(self, name: str, timings=None, key=None, wait=None, log=None):
        on = self.on()
        if not on and timings is None and wait is None and log is None:
            return OFF
        return _Span(self, name, on, timings, key, wait, log)

    def add(self, name: str, n=1):
        """Counter `name` += n (the caller has checked `on()`)."""
        self.counters[name] += n

    def timer(self, name: str):
        return _Timer(self, name) if self.on() else OFF

    def running(self) -> dict:
        """Every counter's value and every source's running total now."""
        now = dict(self.counters)
        for name, fn in SOURCES.items():
            now[name] = fn()
        return now

    def summary(self) -> str:
        lines = ["phase timings (total seconds / calls):"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"  {name}: {self.totals[name]:.2f}s "
                         f"x{self.counts[name]}")
        now = self.running() if self.steps or self.counters else {}
        if now:
            lines.append("counters (totals):")
            lines += [f"  {k}: {v:.3f}" if isinstance(v, float)
                      else f"  {k}: {v}" for k, v in sorted(now.items())]
        return "\n".join(lines)


GLOBAL = Tracer()


def span(name, timings=None, key=None, wait=None, log=None):
    return GLOBAL.span(name, timings, key, wait, log)


def active() -> bool:
    return GLOBAL.on()


def add(name, n=1):
    GLOBAL.add(name, n)


def timer(name):
    return GLOBAL.timer(name)


def timed(name):
    """Decorator: the calls of the function are timer `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not GLOBAL.on():
                return fn(*args, **kwargs)
            with _Timer(GLOBAL, name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def source(name, fn):
    """Register `fn`, a running total, as counter `name` of the steps."""
    SOURCES[name] = fn
