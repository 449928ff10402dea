"""Time IVC steps of the port on the card, so that two versions compare in
one call.

    python3 latticeum_tpu_torch/step_timing.py [--root DIR] [--steps N]
        [--profile] [--label NAME]

Proves ``--steps`` steps (default 3) of ``xorshift_guest(64)`` on
``new_vm_1mb()`` with ``TorchZkVmProver(default_params(), device="cuda")``
imported from the checkout at ``--root`` (default: the one holding this
file), so that a parent commit unpacked beside this checkout is timed by
the same script on the same card.  Prints one JSON line: the label, the
card (``nvidia-smi`` name and power limit), ``acc_comm[0]`` after each step,
every step's time and its parts (``prover.timings``, seconds) and the peak
device memory.  With ``--profile`` the second-to-last step's fold runs
under cProfile (its 30 largest cumulative entries are printed) and the last
step's fold under ``torch.profiler``: the device's busy time is the sum of
the durations of the kernels it traced, beside the fold's wall time.
Those two steps' times include the profilers.
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
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("step_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from latticeum_tpu_torch.host.vm.assembler import xorshift_guest
    from latticeum_tpu_torch.host.vm.vm import new_vm_1mb
    from latticeum_tpu_torch.host.zkvm.params import default_params
    from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    prover = TorchZkVmProver(default_params(), device="cuda")
    inner, folds, report = prover.fold, [], {}

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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            out = inner(*a)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = [e for e in tp.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
        report.update(device_step=step, device_fold_wall_s=wall,
                      device_busy_s=busy, device_kernels=len(kernels))
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
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "timings": prover.timings, **report}), flush=True)
    if profile_text:
        print(profile_text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
