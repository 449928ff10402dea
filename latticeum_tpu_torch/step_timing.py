"""Time IVC steps of the port on the card, so that two versions compare in
one call.

    python3 latticeum_tpu_torch/step_timing.py [--root DIR] [--steps N]
        [--profile] [--label NAME] [--combs | --tails | --peak]

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
``chip_smoke.kernel_checks``, CUDA events) and prints their ms; ``--tails``
times that checkout's ``round_tail`` at the production fold and lin round
shapes and unweighted, ``perm16_chain`` at each one's permutation count
(CUDA graphs of 50) and ``plane_recombine`` at the four production shapes
of the claims (CUDA events over 3 calls, as ``chip_smoke.py`` times it
since it was written, and CUDA graphs of 20), on inputs made from fixed
seeds, and prints their ms; ``--peak`` runs that checkout's
``chip_smoke.py`` main path alone (3 xorshift steps with a checkpoint
after step 2, then 2 fib steps, after one warm-up step) and prints its
peak allocated bytes and its peak requested bytes (the sizes asked for,
before the caching allocator rounds them or hands out a larger cached
block).  With
``--profile`` the lin and fold sum-checks of the third-to-last step's fold
run under ``torch.profiler`` (``sumcheck_busy``: the summed durations of
the kernels each one launched, and their number, beside the unprofiled
``sumcheck_s`` of the other steps), the second-to-last step's fold runs
under cProfile (its 30 largest cumulative entries are printed) and the last
step's fold under ``torch.profiler``: the device's busy time is the sum of
the durations of the kernels it traced, beside the fold's wall time, and
``device_by_kernel`` lists its 25 largest kernels by name (launches and
summed device seconds), ``device_ranges`` the calls, kernels and their
summed device seconds of the eq tables (``Engine.eq_table``, every layout
and caller), the COO matvecs (``Engine.mz_stack``, ``Engine.mt_eq_stack``,
and ``Engine.mz_challenged``, the fold head's COO part), the fold head
(``TorchNifs._build_head``, its three eq tables included), the ring's CRT
and ICRT (``rq.crt``, ``rq.icrt``, every caller), the lin sum-check's
reconstruction rounds (``accel_rounds._lin_reconstruct``) and, per
sum-check (``[lin]``, ``[fold]``), the eq pair sums and the fold round's c
terms (``PER_LABEL``: the kernels ``comb.fold_c_round``, ``pair_sum``,
``fold_c_end``, or an earlier tree's plain torch ``_pair_sum``,
``_contract``, ``comb.fold_t``), the NIFS phases (``lin_prove``,
``dec_prove``, ``fold_prove``) and the sum-check runners, and, per phase,
the ring multiply-accumulate (``rq.ring_mac``, ``rq.ring_mul_each``) and
the owners of the other plain-torch launches (``rq.ntt_mul``,
``_commit_many``, ``_fhat_t``, ``witness_from_f``, the gadget
decompositions, the claims), each traced as a
``torch.profiler.record_function`` range (the kernels that ran inside its
span on the device, nested ranges counting a kernel in each; a name that
the checkout at ``--root`` lacks is not traced), and ``device_htod`` the
fold's
host -> device copies, with those made from pageable memory apart (each
waits for the stream before it).  Those three steps' times include the
profilers.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import cProfile
import functools
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
    modes = ap.add_mutually_exclusive_group()
    modes.add_argument("--combs", action="store_true")
    modes.add_argument("--tails", action="store_true")
    modes.add_argument("--peak", action="store_true")
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
    if args.tails:
        return tail_times(args, card, prover, torch)
    if args.peak:
        return main_path_peak(args, card, prover, torch)
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
        with traced_ranges(torch):
            out, busy, kernels, detail = device_busy(lambda: inner(*a),
                                                     torch, detail=True)
        report.update(device_step=step,
                      device_fold_wall_s=time.perf_counter() - t0,
                      device_busy_s=busy, device_kernels=kernels, **detail)
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
    if "device_by_kernel" in report:
        print(f"fold of step {report['device_step']}: "
              f"{report['device_kernels']} launches, "
              f"{report['device_busy_s']:.4f} s of device time, "
              f"{report['device_htod']}")
        print(f"{'launches':>9} {'device s':>9}  kernel")
        for r in report["device_by_kernel"]:
            print(f"{r['launches']:9d} {r['device_s']:9.4f}  "
                  f"{r['name'][:110]}")
        for name, r in report["device_ranges"].items():
            print(f"range {name}: {r}")
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


RANGE = "step_timing:"
TOP_KERNELS = 25


# Ranges that label the calls inside them: the NIFS phases and the two
# sum-check runners ("lin", "fold").
LABELS = {"lin_prove": "lin_prove", "dec_prove": "dec_prove",
          "fold_prove": "fold_prove", "run_lin_rounds_factored": "lin",
          "run_fold_rounds_factored": "fold"}
# Calls of these names are ranged per label, "name [label]" for the
# innermost label around them: the eq pair sums and the fold round's c
# terms, as kernels (comb.fold_c_round, pair_sum, fold_c_end) or as the
# plain torch of earlier trees (accel_rounds._pair_sum, _contract,
# comb.fold_t), which lin and fold rounds share; and the owners of the
# other plain-torch launches of a fold.
PER_LABEL = ("fold_c_round", "pair_sum", "fold_c_end", "_pair_sum",
             "_contract", "fold_t", "ntt_mul", "ring_mac", "ring_mul_each",
             "_commit_many", "_fhat_t",
             "witness_from_f", "gadget_recompose",
             "decompose_vec_into_k_vecs", "eval_fhat", "eval_claims")


@contextlib.contextmanager
def traced_ranges(torch):
    """Each call of Engine.eq_table, Engine.mz_stack, Engine.mt_eq_stack,
    Engine.mz_challenged (the fold head's COO part), TorchNifs._build_head,
    rq.crt, rq.icrt, accel_rounds._lin_reconstruct, the LABELS and the
    PER_LABEL functions inside a torch.profiler.record_function range
    named RANGE + its name (with its label, PER_LABEL); a name the
    checkout lacks is skipped.  Ranges nest: a kernel counts in each range
    around it."""
    from latticeum_tpu_torch.ring import decompose, rq
    from latticeum_tpu_torch.zkvm import accel_rounds, claims, comb
    from latticeum_tpu_torch.zkvm.accel import Engine
    from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs
    targets = ((Engine, "eq_table"), (Engine, "mz_stack"),
               (Engine, "mt_eq_stack"), (Engine, "mz_challenged"),
               *((TorchNifs, n) for n in (
                   "_build_head", "lin_prove", "dec_prove", "fold_prove",
                   "_commit_many", "_fhat_t", "witness_from_f")),
               (rq, "crt"), (rq, "icrt"), (rq, "ntt_mul"),
               (rq, "ring_mac"), (rq, "ring_mul_each"),
               *((accel_rounds, n) for n in (
                   "_lin_reconstruct", "run_lin_rounds_factored",
                   "run_fold_rounds_factored", "_pair_sum", "_contract")),
               *((comb, n) for n in ("fold_c_round", "pair_sum",
                                     "fold_c_end", "fold_t")),
               (decompose, "gadget_recompose"),
               (decompose, "decompose_vec_into_k_vecs"),
               (claims, "eval_fhat"), (claims, "eval_claims"))
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets
             if hasattr(owner, name)]
    where = []

    def ranged(name, fn):
        label = LABELS.get(name)

        @functools.wraps(fn)      # a kernel wrapper's launch count too
        def wrapped(*args, **kwargs):
            tag = (f"{name} [{where[-1]}]" if where and name in PER_LABEL
                   else name)
            if label:
                where.append(label)
            try:
                with torch.profiler.record_function(RANGE + tag):
                    return fn(*args, **kwargs)
            finally:
                if label:
                    where.pop()
        return wrapped

    for owner, name, fn in saved:
        setattr(owner, name, ranged(name, fn))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def device_busy(fn, torch, detail=False):
    """fn() under torch.profiler: (its result, the summed durations in
    seconds of the kernels it launched, their number); with `detail`, also
    a dict of the TOP_KERNELS largest kernels by name, the launches and
    summed durations of the kernels inside each RANGE range (its span on
    the device's timeline, which the profiler traces as an event of its
    own and which is not a kernel), and the host -> device copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in tp.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if not e.name.startswith(RANGE)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    if not detail:
        return out, busy, len(kernels)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    kernels.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kernels]
    ranges = {}
    for a in events:
        if not a.name.startswith(RANGE):
            continue
        lo, hi = a.time_range.start, a.time_range.end
        inside = [e for e in kernels[bisect.bisect_left(starts, lo):
                                     bisect.bisect_right(starts, hi)]
                  if e.time_range.end <= hi]
        r = ranges.setdefault(a.name[len(RANGE):], {
            "calls": 0, "launches": 0, "device_s": 0.0, "span_s": 0.0})
        r["calls"] += 1
        r["launches"] += len(inside)
        r["device_s"] += sum(e.time_range.elapsed_us() for e in inside) / 1e6
        r["span_s"] += (hi - lo) / 1e6
    htod = [e.name for e in kernels if "HtoD" in e.name]
    return out, busy, len(kernels), {
        "device_by_kernel": [{"name": name[:200], "launches": n,
                              "device_s": us / 1e6}
                             for name, (n, us) in top],
        "device_kernel_names": len(by_name),
        "device_ranges": ranges,
        "device_htod": {"copies": len(htod),
                        "pageable": sum("Pageable" in n for n in htod)}}


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


def tail_times(args, card, prover, torch):
    """round_tail, perm16_chain and plane_recombine of the checkout at
    --root, timed by its chip_smoke.graph_ms and cuda_ms on inputs made
    from fixed seeds (the same whatever the checkout)."""
    import numpy as np

    import chip_smoke
    from latticeum_tpu_torch.crypto import challenger
    from latticeum_tpu_torch.field import goldilocks as gl, mxu
    from latticeum_tpu_torch.host.nifs.structs import TAU
    from latticeum_tpu_torch.zkvm import accel_rounds
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape):
        return torch.from_numpy(gl.to_i64_bits(rng.integers(
            0, gl.P, shape, dtype=np.uint64))).to(dev)

    ccs, p = prover.ccs, prover.params
    deg_l, npts_h = ccs.d + 1, 2 * p.B_SMALL
    lags = {"fold": gl.from_int(accel_rounds.fold_lagrange(
                npts_h, npts_h + 1), dev),
            "lin": gl.from_int([accel_rounds._lagrange_ext_consts(
                deg_l, deg_l + 1)], dev),
            "unweighted": None}
    n_msgs = {"fold": npts_h + 1, "lin": deg_l + 1, "unweighted": deg_l + 1}
    nv, pending = 4, 3                  # every round after the first
    ms = {}
    for kind, lag in lags.items():
        n_msg = n_msgs[kind]
        tables = 0 if lag is None else lag.shape[0]
        rows = n_msg if lag is None else lag.shape[2]
        sums, state, pend, st = rnd(rows, 24), rnd(16), rnd(pending), rnd(16)
        points = rnd(tables, nv, 3) if tables else None
        E = rnd(tables, 3) if tables else None
        msgs = torch.zeros((nv, n_msg, 24), dtype=torch.int64, device=dev)
        chals = torch.zeros((nv, 3), dtype=torch.int64, device=dev)
        perms = challenger.permutations(pending + 24 * n_msg)
        ms[f"round_tail {kind}"] = chip_smoke.graph_ms(
            torch, lambda: challenger.round_tail(
                sums, lag, points, E, state, pend, msgs, chals, 2,
                weighted=lag is not None), 50)
        ms[f"perm16_chain {perms}"] = chip_smoke.graph_ms(
            torch, lambda: challenger.perm16_chain(st, perms), 50)
    t, K = ccs.t, p.K
    for label, ta, tb in (("dec u", t, K), ("fold eta", t, 2 * K),
                          ("dec v", K * TAU, 1), ("lin v", TAU, 1)):
        ra, rb = mxu.plane_shape(ta, 1)[0], mxu.plane_shape(tb, 1)[0]
        O = torch.randint(-(1 << 30), 1 << 30, (8, ra, rb), generator=gen,
                          dtype=torch.int32, device=dev)
        acc = torch.zeros((ta, tb, 24), dtype=torch.int64, device=dev)
        ms[f"plane_recombine {label} {ta}x{tb} events"] = chip_smoke.cuda_ms(
            torch, lambda: mxu.plane_recombine(O, acc), 3)
        ms[f"plane_recombine {label} {ta}x{tb} graph"] = chip_smoke.graph_ms(
            torch, lambda: mxu.plane_recombine(O, acc), 20)
        del O
    print(json.dumps({"label": args.label, "root": args.root, "card": card,
                      "tail_ms": ms}), flush=True)
    return 0


def main_path_peak(args, card, prover, torch):
    """The peak memory of the checkout's chip_smoke.py main path, run
    alone after one warm-up step."""
    import shutil
    import tempfile

    import chip_smoke
    from latticeum_tpu_torch.host.vm.assembler import (fib_const_guest,
                                                       xorshift_guest)
    from latticeum_tpu_torch.host.vm.vm import new_vm_1mb
    chip_smoke.prove(prover, new_vm_1mb().load_elf_data(xorshift_guest(64)),
                     1, "warm-up", torch)
    chip_smoke.record_folds(prover)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ckdir = tempfile.mkdtemp(prefix="step_timing_ckpt_")
    try:
        with chip_smoke.one_fetch_per_sumcheck(torch):
            chip_smoke.prove(prover, new_vm_1mb().load_elf_data(
                xorshift_guest(64)), 3, "xorshift_guest(64)", torch,
                checkpoint_dir=ckdir, checkpoint_every=2)
            chip_smoke.prove(prover, new_vm_1mb().load_elf_data(
                fib_const_guest(chip_smoke.FIB_RESULT)), 2,
                "fib_const_guest", torch)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    stats = torch.cuda.memory_stats()
    print(json.dumps({"label": args.label, "root": args.root, "card": card,
                      "allocated_peak": stats["allocated_bytes.all.peak"],
                      "requested_peak": stats["requested_bytes.all.peak"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
