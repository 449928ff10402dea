"""Time IVC steps of the port on the card, so that two versions compare in
one call.

    python3 latticeum_tpu_torch/step_timing.py [--root DIR] [--steps N]
        [--profile] [--label NAME] [--combs]

Proves ``--steps`` steps (default 3) of ``xorshift_guest(64)`` on
``new_vm_1mb()`` with ``TorchZkVmProver(default_params(), device="cuda")``
imported from the checkout at ``--root`` (default: the one holding this
file), so that a parent commit unpacked beside this checkout is timed by
the same script on the same card.  Prints one JSON line: the label, the
card (``nvidia-smi`` name and power limit), ``acc_comm[0]`` after each step,
every step's time and its parts (``prover.timings``, seconds), the wall
time of every lin and fold sum-check (``sumcheck_s``: each call of
``zkvm/accel_rounds.py``'s two runners, the card synchronized before and
after it) and the peak device memory.  ``--combs`` times the four comb
kernels of that checkout at the production round shapes instead (its
``chip_smoke.kernel_checks``, CUDA events) and prints their ms.  With
``--profile`` the lin and fold sum-checks of the third-to-last step's fold
run under ``torch.profiler`` (``sumcheck_busy``: the summed durations of
the kernels each one launched, and their number, beside the unprofiled
``sumcheck_s`` of the other steps), the second-to-last step's fold runs
under cProfile (its 30 largest cumulative entries are printed) and the last
step's fold under ``torch.profiler``: the device's busy time is the sum of
the durations of the kernels it traced, beside the fold's wall time.
Those three steps' times include the profilers.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--label", default="")
    ap.add_argument("--combs", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("step_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from latticeum_tpu_torch.host.vm.assembler import xorshift_guest
    from latticeum_tpu_torch.host.vm.vm import new_vm_1mb
    from latticeum_tpu_torch.host.zkvm.params import default_params
    from latticeum_tpu_torch.zkvm import accel_rounds
    from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    prover = TorchZkVmProver(default_params(), device="cuda")
    if args.combs:
        return comb_times(args, card, prover, torch)
    sumchecks = {"lin": [], "fold": []}
    inner, folds, report = prover.fold, [], {}
    for kind in sumchecks:
        name = f"run_{kind}_rounds_factored"
        run = timed(getattr(accel_rounds, name), sumchecks[kind], torch)
        if args.profile:
            run = profiled_in(run, kind, folds, args.steps - 2, report, torch)
        setattr(accel_rounds, name, run)

    def fold(*a):
        folds.append(None)
        step = len(folds)
        if not args.profile or step < args.steps - 1:
            return inner(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == args.steps - 1:
            prof = cProfile.Profile()
            out = prof.runcall(inner, *a)
            torch.cuda.synchronize()
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(
                "cumulative").print_stats(30)
            report["cprofile_step"] = step
            report["cprofile_fold_s"] = time.perf_counter() - t0
            report["cprofile"] = buf.getvalue()
            return out
        out, busy, kernels = device_busy(lambda: inner(*a), torch)
        report.update(device_step=step,
                      device_fold_wall_s=time.perf_counter() - t0,
                      device_busy_s=busy, device_kernels=kernels)
        return out

    prover.fold = fold
    acc0 = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    prover.prove_vm(new_vm_1mb().load_elf_data(xorshift_guest(64)),
                    max_steps=args.steps,
                    on_step=lambda step, st: acc0.append(hex(st.acc_comm[0])))
    torch.cuda.synchronize()
    profile_text = report.pop("cprofile", None)
    print(json.dumps({
        "label": args.label, "root": args.root, "card": card,
        "acc0": acc0, "seconds": time.time() - t0,
        "sumcheck_s": sumchecks,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "timings": prover.timings, **report}), flush=True)
    if profile_text:
        print(profile_text, flush=True)
    return 0


def timed(run, seconds, torch):
    """`run` with the card synchronized before and after each call, its
    wall time appended to `seconds`."""
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return wrapped


def device_busy(fn, torch):
    """fn() under torch.profiler: (its result, the summed durations in
    seconds of the kernels it launched, their number)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in tp.events() if e.device_type == DeviceType.CUDA]
    return (out, sum(e.time_range.elapsed_us() for e in kernels) / 1e6,
            len(kernels))


def profiled_in(run, kind, folds, step, report, torch):
    """`run`, under torch.profiler while the fold of `step` runs: its
    kernels' device time goes to report["sumcheck_busy"][kind]."""
    def wrapped(*args, **kwargs):
        if len(folds) != step:
            return run(*args, **kwargs)
        out, busy, kernels = device_busy(lambda: run(*args, **kwargs), torch)
        report.setdefault("sumcheck_busy", {})[kind] = {
            "step": step, "busy_s": busy, "kernels": kernels}
        return out
    return wrapped


def comb_times(args, card, prover, torch):
    """The four comb kernels of the checkout at --root, timed by its
    chip_smoke.kernel_checks at the production round shapes."""
    import numpy as np

    import chip_smoke
    from latticeum_tpu_torch import kernels
    from latticeum_tpu_torch.field import goldilocks as gl
    from latticeum_tpu_torch.host.crypto import native
    from latticeum_tpu_torch.zkvm import comb
    built = chip_smoke.device_and_build(torch, kernels, native)
    records = chip_smoke.kernel_checks(
        torch, np, gl, comb, prover.ccs, prover.dn._lin_sets,
        torch.device("cuda"), built[1], built[2])
    print(json.dumps({"label": args.label, "root": args.root, "card": card,
                      "comb_ms": {r["name"]: r["ms"] for r in records}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
