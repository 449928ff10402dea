"""Hold the program's own spans and counters against the device trace of one
traced run of a cell.

    python3 zkbench/tracecheck.py --workload fib_1mb.loop --seed 7 \\
        --seconds 40 [--out tracecheck_fib.json]

Runs the cell as `run.py --trace 1` does (the same harness, profiler and
judging), then prints one JSON object as its last line, also written to
`--out`: the run's result, and

  * `anchor_drift_us`: how far the window's two clock anchors disagree
    (and `anchor_drift_unix_us`, the same against the wall clock read
    beside each anchor);
  * `launches`: the hand kernels' launches in the window's trace, by
    kernel and in all, beside the program's `kernel.launches` over the
    window's steps;
  * `dtoh`: the window's device -> host copies in the trace, in all and
    inside the program's `step` spans, beside its `fetch.count`;
  * `fold_launches_outside_nifs_fold`: fold_round0/fold_roundr launches
    that start outside every mapped `nifs.fold` span, of all of them;
  * `twins`: each program metric beside the outside one of the same
    quantity read in the same run;
  * `idle_by_program_span`: the device's idle seconds in the window, each
    instant given to the innermost program span open then;
  * `dtoh_by_program_span`: the window's device -> host copies by the
    innermost program span open as each starts.

A check, not a metric: nothing here is part of the benchmark's result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TWINS = (("prog.arith_s", "arith_s"), ("prog.dec.x_s_s", "dec.x_s_s"),
         ("prog.transcript_s", "transcript_s"),
         ("prog.statecomm_s", "statecomm_s"), ("prog.memtree_s", "memtree_s"),
         ("prog.ckpt_s", "ckpt_s"))


def checks(w, metrics):
    from zkbench import progtrace
    from zkbench.devtrace import Trace
    out = {"steps": w.steps, "window_s": w.t1 - w.t0,
           "anchor_drift_us": progtrace.anchor_drift_us(w)}
    steps = progtrace.steps_in(w)
    total = {k: sum(d.get(k, 0) for d in steps)
             for k in ("kernel.launches", "fetch.count", "transcript.perms")}
    by_kernel = progtrace.device_launches(w, progtrace.hand_kernels())
    out["launches"] = {"program": total["kernel.launches"],
                       "trace": sum(by_kernel.values()),
                       "trace_by_kernel": by_kernel,
                       "step_records": len(steps)}
    copies = progtrace.device_copies(w)
    in_steps = progtrace.union(
        (a, b) for _, a, b in progtrace.mapped(
            w, progtrace.spans_in(w, progtrace.STEP)))
    lo, hi = w.trace.window
    inside = sum(1 for n, a, _ in w.trace.device
                 if lo <= a < hi and "Memcpy" in n and "DtoH" in n
                 and any(s <= a <= e for s, e in in_steps))
    out["dtoh"] = {"program": total["fetch.count"],
                   "trace": sum(copies.values()), "trace_by_name": copies,
                   "trace_inside_steps": inside}
    out["fold_launches_outside_nifs_fold"] = progtrace.launches_outside(
        w, ["fold_round0_kernel", "fold_roundr_kernel"], "nifs.fold")
    twins = {}
    for prog, outside in TWINS:
        if prog in metrics and outside in metrics:
            a, b = metrics[prog]["value"], metrics[outside]["value"]
            twins[prog] = {"program": a, "outside": b, "diff": a - b,
                           "rel": (a - b) / b if b else None}
    out["twins"] = twins
    spans = progtrace.mapped(w, progtrace.spans_in(w))
    out["idle_by_program_span"] = Trace(
        w.trace.device, spans, w.trace.window).gaps_by_span(n=30)
    out["dtoh_by_program_span"] = innermost(
        spans, [a for n, a, _ in w.trace.device
                if lo <= a < hi and "Memcpy" in n and "DtoH" in n])
    return out


def innermost(spans, instants):
    """{span name: instants} of each instant given to the innermost
    (shortest) span holding it; "(no span)" where none does."""
    out = {}
    for t in instants:
        holding = [(e - s, n) for n, s, e in spans if s <= t <= e]
        name = min(holding)[1] if holding else "(no span)"
        out[name] = out.get(name, 0) + 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"             # as run.py, before numpy loads
    sys.path.insert(0, str(ROOT))
    import run as run_mod                 # zkbench/run.py: the same set-up
    from zkbench import harness

    seen = []
    init = harness.Window.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        seen.append(self)
    harness.Window.__init__ = keep
    # the wall clock beside the window's two anchors, read right after the
    # harness reads perf_counter for each
    unix = {}
    after = harness.Closed.after

    def after_and_unix(self, step):
        r = after(self, step)
        if r in ("open", "close"):
            unix[r] = (time.time(), time.perf_counter())
        return r
    harness.Closed.after = after_and_unix
    result = {}

    def run(*a, **kw):
        res, bad, tr = orig(*a, **kw)
        result.update(res)
        return res, bad, tr
    orig = harness.run
    harness.run = run
    rc = run_mod.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or not seen:
        return rc or 1
    w = seen[0]
    out = {"workload": args.workload, "seed": args.seed,
           "result": result, "checks": checks(w, result["metrics"])}
    if len(unix) == 2 and w.trace.window:
        lo, hi = w.trace.window
        out["checks"]["anchor_drift_unix_us"] = (
            (hi - unix["close"][0] * 1e6) - (lo - unix["open"][0] * 1e6))
        out["checks"]["unix_minus_perf_drift_us"] = 1e6 * (
            (unix["close"][0] - unix["close"][1])
            - (unix["open"][0] - unix["open"][1]))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
