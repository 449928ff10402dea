"""Host spans that the benchmark puts around the program's layers.

A per-layer metric declares the functions it times as `(module, path)`
pairs, the function or method as the calling module sees it: module
`latticeum_tpu_torch.zkvm.prover` and path `arithmetize` wraps the name
`arithmetize` in that module; path `ZkVmCommitter.acc_comm` wraps the
method on the class that the module names `ZkVmCommitter`.  A target that
no longer exists is skipped and reported, so a renamed layer leaves its
metric without a reading instead of breaking the run.

Every call of a wrapped target records one span (name, start, end) on the
host clock; a span that is already open under the same name (a nested or
recursive call) is not opened again, so nested calls count once.  With a
profiler, each span also opens a `torch.profiler.record_function` range
of the same name.
"""

from __future__ import annotations

import functools
import importlib
import time


class Spans:
    """The recorded spans of one run: `closed` holds (name, start, end)."""

    def __init__(self, ranges: bool = False):
        self.closed = []
        self.ranges = ranges
        self._open = {}
        self._undo = []
        self.missing = []

    def wrap(self, name, fn):
        spans = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if spans._open.get(name):
                return fn(*args, **kwargs)
            spans._open[name] = True
            rf = None
            if spans.ranges:
                from torch.profiler import record_function
                rf = record_function(name)
                rf.__enter__()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.closed.append((name, t0, time.perf_counter()))
                if rf is not None:
                    rf.__exit__(None, None, None)
                spans._open[name] = False
        return wrapped

    def install(self, name, targets):
        """Wrap every (module, path) of `targets` under the span `name`.
        Returns the number wrapped; the missing ones go to `missing`."""
        done = 0
        for module, path in targets:
            owner, attr = resolve(module, path)
            if owner is None:
                self.missing.append(f"{module}:{path}")
                continue
            had = attr in vars(owner)
            self._undo.append((owner, attr, had, vars(owner).get(attr)))
            setattr(owner, attr, self.wrap(name, getattr(owner, attr)))
            done += 1
        return done

    def uninstall(self):
        for owner, attr, had, orig in reversed(self._undo):
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()

    def total(self, name, lo, hi):
        """Seconds inside span `name` that lie wholly in [lo, hi]."""
        return sum(t1 - t0 for n, t0, t1 in self.closed
                   if n == name and t0 >= lo and t1 <= hi)

    def first(self, name):
        """The earliest (start, end) of span `name`, or None."""
        found = [(t0, t1) for n, t0, t1 in self.closed if n == name]
        return min(found) if found else None


def resolve(module, path):
    """(object that holds the last name of `path`, that name), or
    (None, None) where the module or a name along the path is missing."""
    try:
        obj = importlib.import_module(module)
    except ImportError:
        return None, None
    *heads, last = path.split(".")
    for h in heads:
        obj = getattr(obj, h, None)
        if obj is None:
            return None, None
    if not hasattr(obj, last) or not callable(getattr(obj, last)):
        return None, None
    return obj, last
