"""Lightweight span tracing: per-phase wall times, counters, and a summary.

The analog of the reference's `tracing` + span-close timing setup
(zkvm/src/main.rs:56-63, #[instrument] spans on commitment/folding phases).
Zero-dependency; enable with LATTICEUM_TRACE=1 or Tracer(enabled=True).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class Tracer:
    def __init__(self, enabled: bool | None = None, log=None):
        if enabled is None:
            enabled = os.environ.get("LATTICEUM_TRACE", "0") == "1"
        self.enabled = enabled
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.log = log or (lambda msg: print(msg, flush=True))
        self._stack = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time()
        self._stack.append(name)
        try:
            yield
        finally:
            dt = time.time() - t0
            full = "/".join(self._stack)
            self._stack.pop()
            self.totals[full] += dt
            self.counts[full] += 1
            self.log(f"[trace] {full}: {dt:.3f}s")

    def summary(self) -> str:
        lines = ["phase timings (total seconds / calls):"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"  {name}: {self.totals[name]:.2f}s "
                         f"x{self.counts[name]}")
        return "\n".join(lines)


GLOBAL = Tracer()


def span(name):
    return GLOBAL.span(name)
