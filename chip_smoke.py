"""Drive the torch port of the prover on one CUDA card, phase by phase.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device   the card's name and power limit, torch/CUDA versions, native
              Poseidon2 availability;
  2. build    nvcc builds latticeum_tpu_torch/csrc into the kernel library;
  3. kernels  each of the four comb kernels against its plain-torch twin on
              the card, exact integer equality, at a small shape and at the
              production round shape, with kernel and twin times;
  4. small    two chained folds of the port on the card against the host
              NIFS on the test CCS (transcript, proofs, accumulator);
  5. main     TorchZkVmProver(device="cuda") at default_params(): 3 steps of
              xorshift_guest(64) with acc_comm[0] pinned after each step,
              then 2 steps of the bench's fib guest; every fold of both
              passes the host NIFS verifier with the same folded
              accumulator; launch counts of every kernel > 0.
  6. replay   the same 3 xorshift steps with the JAX package's stale
              lin-reconstruction betas replayed (ROADMAP C.h9) must give the
              acc_comm[0] values that package recorded on its TPU.
Then one JSON line of kernel records, the nvidia-smi name/power line, and
the result line {"ok": true, "device": {...}}.  Imports no jax.
"""

import contextlib

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# acc_comm[0] after steps 1-3 of xorshift_guest(64) at default_params() and
# scheme seed 0.  Every fold behind them passes the host NIFS verifier, and
# the step-1 linearization and decomposition proofs equal the host prover's.
XORSHIFT_ACC0 = (0x637b73bfea2fad83, 0x2771509091ba015c, 0xf9a8bfc0aee9ad6a)
# The values the JAX package recorded on its TPU (XORSHIFT_r05.log:60-62).
# Its lin proofs after the first reuse stale betas (ROADMAP C.h9), so only
# the replay phase, which reproduces that reuse, must reach them.
TPU_XORSHIFT_ACC0 = (0x50aa97463269fda, 0x9cb88707da63ca3,
                     0xa7645c9dd3011f93)
FIB_RESULT = 0xC594BFC3


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"== {name}")


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from latticeum_tpu_torch import kernels
    from latticeum_tpu_torch.field import goldilocks as gl
    from latticeum_tpu_torch.zkvm import comb

    dev = torch.device("cuda")

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | "
        f"count={torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from latticeum_tpu.crypto import native
    try:
        native._build()                 # this host's -march=native build
        log("native poseidon2: rebuilt for this host")
    except (OSError, subprocess.CalledProcessError) as exc:
        log(f"native poseidon2: rebuild failed ({exc!r})")
    log(f"native poseidon2 available: {native.available()}")

    phase("build")
    t0 = time.time()
    so = kernels.build()
    kernels.lib()
    log(f"build: {time.time() - t0:.2f} s -> {os.path.relpath(so, ROOT)}")
    out = kernels.build_info.get("output", "")
    for line in out.splitlines():
        if "spill" in line and not line.strip().startswith("0 bytes"):
            log(f"  ptxas: {line.strip()}")

    phase("build prover")
    from latticeum_tpu.vm.assembler import fib_const_guest, xorshift_guest
    from latticeum_tpu.vm.vm import new_vm_1mb
    from latticeum_tpu.zkvm.params import default_params
    from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver
    t0 = time.time()
    prover = TorchZkVmProver(default_params(), device="cuda")
    ccs = prover.ccs
    log(f"prover ready: {time.time() - t0:.2f} s (m=2^{ccs.s}, t={ccs.t}, "
        f"multisets={len(ccs.S)}, lin cap={prover.dn._cap_pow2})")

    phase("kernels")
    if prover.dn._lin_sets is None:
        fail("the CCS lin constants are not all +-1")
    records = kernel_checks(torch, np, gl, comb, ccs, prover.dn._lin_sets,
                            dev)

    phase("small reference")
    small_reference(torch, dev)

    phase("main path")
    folds = record_folds(prover)
    comb.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    xs = prove(prover, new_vm_1mb().load_elf_data(xorshift_guest(64)), 3,
               "xorshift_guest(64)", torch)
    prove(prover, new_vm_1mb().load_elf_data(
        fib_const_guest(FIB_RESULT)), 2, "fib_const_guest", torch)
    launches = {w.__name__: w.launches for w in comb.WRAPPERS}
    del prover.fold                     # drop the recording wrapper
    log(f"launches on the main path: {launches}")
    if not all(v > 0 for v in launches.values()):
        fail("a kernel of the main path was never launched")
    t0 = time.time()
    for i, (acc, cm_i, proof, folded) in enumerate(folds, start=1):
        if prover.verify_fold(acc, cm_i, proof) != folded:
            fail(f"fold {i}: the host verifier disagrees")
    log(f"folds 1-{len(folds)} pass the host NIFS verifier "
        f"({time.time() - t0:.1f} s)")
    check_acc0("xorshift", xs["acc0"], XORSHIFT_ACC0)

    phase("replay of the recorded TPU run")
    with stale_lin_betas():
        replay = prove(prover, new_vm_1mb().load_elf_data(xorshift_guest(64)),
                       3, "xorshift_guest(64), stale lin betas", torch)
    check_acc0("xorshift replay", replay["acc0"], TPU_XORSHIFT_ACC0)
    if "jax" in sys.modules:
        fail("jax was imported")
    for r in records:
        r["launches"] = launches[r["name"]]

    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_checks(torch, np, gl, comb, ccs, sets_prod, dev):
    """Every kernel against its twin: small shape, then production shape
    (timed).  Returns the kernel records (launches filled in later)."""
    rng = np.random.default_rng(7)

    def rnd(*shape):
        u = rng.integers(0, gl.P, shape, dtype=np.uint64)
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    def r3():
        return [int(v) for v in rng.integers(0, gl.P, 3, dtype=np.uint64)]

    def err(a, b):
        """Largest |a - b| over the outputs, read as u64 (0 = bit-exact)."""
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        worst = 0
        for x, y in zip(a, b):
            if torch.equal(x, y):
                continue
            u, v = gl.to_u64(x), gl.to_u64(y)
            worst = max(worst, int(np.where(u > v, u - v, v - u).max()))
        return worst

    sets_small = comb.lin_sets([(0, 3, 5), (1,), (2, 4)], (1, -1, 1), 6, dev)
    deg_q = ccs.d + 1
    rows_f, n_f, b_small = 90, 1 << 17, 2
    rows_l, n_l = ccs.t, 16384
    cases = {
        "fold_round0": (
            lambda: (rnd(6, 24, 1024), rnd(24, 512), rnd(6, 3), 2),
            lambda: (rnd(rows_f, 24, n_f), rnd(24, n_f // 2),
                     rnd(rows_f, 3), b_small)),
        "fold_roundr": (
            lambda: (rnd(6, 24, 2048), rnd(24, 512), rnd(6, 3), r3(), 2),
            lambda: (rnd(rows_f, 24, n_f), rnd(24, n_f // 4),
                     rnd(rows_f, 3), r3(), b_small)),
        "lin_round0": (
            lambda: (rnd(6, 24, 1024), rnd(24, 512), sets_small, 4),
            lambda: (rnd(rows_l, 24, n_l), rnd(24, n_l // 2), sets_prod,
                     deg_q)),
        "lin_roundr": (
            lambda: (rnd(6, 24, 2048), rnd(24, 512), r3(), sets_small, 4),
            lambda: (rnd(rows_l, 24, n_l), rnd(24, n_l // 4), r3(),
                     sets_prod, deg_q)),
    }
    records = []
    replaces = {"fold_round0": 117, "fold_roundr": 176, "lin_round0": 317,
                "lin_roundr": 365}
    for w in comb.WRAPPERS:
        twin = comb.TWINS[w]
        small, prod = cases[w.__name__]
        worst = 0
        for label, make in (("small", small), ("production", prod)):
            args = make()
            got = w(*args)
            want = twin(*args)
            torch.cuda.synchronize()
            e = err(got, want)
            worst = max(worst, e)
            shape = tuple(args[0].shape)
            log(f"{w.__name__} {label} X{shape}: "
                f"{'bit-exact' if e == 0 else f'MISMATCH max_abs_err={e}'}")
            if e:
                raise SystemExit(f"FAIL: {w.__name__} disagrees with its twin")
        ms = cuda_ms(torch, lambda: w(*args), 5)
        plain_ms = cuda_ms(torch, lambda: twin(*args), 1)
        log(f"{w.__name__} production: kernel {ms:.3f} ms, twin "
            f"{plain_ms:.3f} ms")
        records.append({
            "name": w.__name__, "route": "cuda",
            "source": "latticeum_tpu_torch/csrc/comb.cu",
            "replaces": f"latticeum_tpu/zkvm/pallas_comb.py:"
                        f"{replaces[w.__name__]}",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms})
        del args
        torch.cuda.empty_cache()
    return records


def small_reference(torch, dev):
    """Two chained folds of TorchNifs on the card vs the host NIFS."""
    from latticeum_tpu.commit.ajtai import AjtaiScheme
    from latticeum_tpu.crypto.transcript import Transcript
    from latticeum_tpu.field import goldilocks as glr, host as H
    from latticeum_tpu.nifs import linearization as lin, nifs
    from latticeum_tpu.nifs.nifs import DecompositionParams
    from latticeum_tpu.nifs.structs import CCCS, Witness
    from latticeum_tpu.nifs.test_fixtures import (
        TEST_B, TEST_B_SMALL, TEST_K, TEST_L, get_test_ccs, get_test_z,
        z_to_device)
    from latticeum_tpu_torch.zkvm.accel import Engine
    from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs

    params = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                                 K=TEST_K)
    ccs = get_test_ccs()
    cms, wits, scheme = [], [], None
    for x in (3, 5):
        z = get_test_z(x)
        wit = Witness.from_w_ccs(z_to_device(z[2:]), TEST_B, TEST_L)
        if scheme is None:
            scheme = AjtaiScheme.from_seed(kappa=4, n=wit.f[0].shape[0])
        cms.append(CCCS(cm=scheme.commit_host(wit.f), x_ccs=z[:1]))
        wits.append(wit)
    acc_wit = Witness.from_w_ccs(glr.zeros((ccs.n - ccs.l - 1, 24)), TEST_B,
                                 TEST_L)
    acc, _, _ = lin.prove(CCCS(cm=scheme.commit_host(acc_wit.f),
                               x_ccs=[H.ntt_zero()]), acc_wit, Transcript(),
                          ccs)
    e = Engine(ccs, dev)
    dn = TorchNifs(e, ccs, params,
                   [[int(v) for v in r] for r in glr.to_int(scheme.rows_limbs)])
    acc_h, w_h, acc_d = acc, acc_wit, acc
    w_d = dn.build_witness(e.put(acc_wit.w_ccs))
    for i, (cm_i, wit) in enumerate(zip(cms, wits), start=1):
        th, td = Transcript(), Transcript()
        acc_h, w_h, ph = nifs.prove(acc_h, w_h, cm_i, wit, th, ccs, scheme,
                                    params)
        acc_d, w_d, pd = dn.prove(acc_d, w_d, cm_i,
                                  dn.build_witness(e.put(wit.w_ccs)), td)
        if (list(th.ch.state) != list(td.ch.state) or ph != pd
                or acc_h != acc_d):
            raise SystemExit(f"FAIL: small fold {i} differs from the host NIFS")
    log("small reference: 2 chained folds match the host NIFS (transcript, "
        "proofs, accumulator)")


def check_acc0(name, got, want):
    for step, (g, w) in enumerate(zip(got, want), start=1):
        if g != w:
            fail(f"{name} acc_comm[0] after step {step}: {g:#x} != {w:#x}")
        log(f"{name} step {step}: acc_comm[0] {g:#x} matches the pinned value")


@contextlib.contextmanager
def stale_lin_betas():
    """Replay the JAX package's device lin sum-check as its TPU run computed
    it: its truncated-MLE reconstruction rounds use the betas of the first
    lin call in the process, which accel_dev_fs.run_fixed_phase_dev bakes
    into a jit keyed by shape only (ROADMAP C.h9)."""
    from latticeum_tpu_torch.zkvm import accel_rounds
    exact = accel_rounds._lin_reconstruct
    first = []

    def stale(transcript, stack, nv, r, degree, sets, beta_s, chals):
        if not first:
            first.append(list(beta_s))
        return exact(transcript, stack, nv, r, degree, sets, first[0], chals)
    accel_rounds._lin_reconstruct = stale
    try:
        yield
    finally:
        accel_rounds._lin_reconstruct = exact


def record_folds(prover):
    """Wrap prover.fold to keep (acc, cm_i, proof, folded) of every fold."""
    folds = []
    inner = prover.fold

    def fold(acc, w_acc, cm_i, w_i):
        folded, w0, proof = inner(acc, w_acc, cm_i, w_i)
        folds.append((acc, cm_i, proof, folded))
        return folded, w0, proof
    prover.fold = fold
    return folds


def prove(prover, vm, steps, name, torch):
    prover.timings = {}
    marks, acc0 = [time.time()], []

    def on_step(step, state):
        torch.cuda.synchronize()
        marks.append(time.time())
        acc0.append(state.acc_comm[0])
        log(f"{name} step {step}: {marks[-1] - marks[-2]:.2f} s "
            f"acc_comm[0]={state.acc_comm[0]:#x}")
    state = prover.prove_vm(vm, max_steps=steps, on_step=on_step)
    if state.steps != steps:
        raise SystemExit(f"FAIL: {name} folded {state.steps} of {steps} steps")
    if len(state.acc_comm) != 4 or not all(
            0 <= int(v) < (1 << 64) for v in state.acc_comm):
        raise SystemExit(f"FAIL: {name} acc_comm malformed")
    phases = {k: [round(v, 3) for v in vs] for k, vs in prover.timings.items()}
    log(f"{name} phase seconds: {json.dumps(phases)}")
    log(f"{name} max_memory_allocated: {torch.cuda.max_memory_allocated()} "
        f"bytes")
    return {"acc0": acc0}


if __name__ == "__main__":
    sys.exit(main())
