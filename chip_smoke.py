"""Drive the torch port of the prover on one CUDA card, phase by phase.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device   the card's name, power limit and SM clock, torch/CUDA
              versions; the port's native Poseidon2 core (host reference of
              the trees) must build;
  2. build    nvcc builds latticeum_tpu_torch/csrc into the kernel library
              (one nvcc per source, all at once, then one link); ptxas
              registers and spills of every perm8 and sponge8 form (S lanes
              per state, S = 1, 2, 4, 8); the
              SASS of perm8 and of one field operation (probe kernels)
              counted for the bounds; the latency in SM clocks of one
              dependent gl_mul, gl_add, 64-bit shuffle and of the width-16
              permutation's own steps (latency probes, clock64 around
              chains of one warp);
  3. tree     every form of the perm8 kernel against its plain-torch twin
              on the card, exact, at n = 1 to 524288 with the edge values in
              every position, each timed at n = 1 to 524288 by a CUDA graph
              and torch.profiler (the record: the form perm8 picks, at
              n = 512, the largest level of the main path); every form of
              sponge8 against its twin at the test shapes and at 1024 ...
              16384 rows of 256 words (1024: a 1 MB VM's pages, 8192: an
              8 MB VM's), each timed there, beside 64 perm8 launches of the
              old loop over the same rows and the chain of one row alone
              (the record: the form sponge8 picks, at 1024 x 256); then the
              memory roots of new_vm_1mb() and new_vm_8mb() loaded with
              xorshift_guest(64), and the code root, built on the card,
              against the host copy's native tree, with both times and the
              page tree's parts;
  4. kernels  each of the four comb kernels against its plain-torch twin on
              the card, exact integer equality, at a small shape and at the
              production round shape, with kernel and twin times; the lin
              kernels also with random ring constants c_i (not +-1) at the
              production shape, timed;
  5. claims   the digit-plane kernels (digit_split, plane_recombine) against
              their twins at edge shapes (several chunks, every padding) and
              at the four production shapes of the evaluation claims (dec u,
              fold eta, dec v, lin v); ring_contract against the slot-wise
              products at the fold-eta and dec-v shapes; times of the split,
              the torch._int_mm products, the recombination (CUDA events
              over 3 calls, the record, and a CUDA graph of 20), the whole
              contraction and the slot-wise form, each beside its bound;
  6. fiat-shamir  round_tail (crypto/challenger.py, csrc/challenger.cu)
              against its twin, bit for bit, at the production lin and fold
              round shapes and unweighted (the lin reconstruction rounds),
              each at every pending length 0 ... 11, and over a chain of 34
              launches (a step's 17 lin and 17 fold rounds) against the
              twin's chain; perm16_chain against its twin; each shape timed
              (CUDA graph) beside its bound, the chain of its
              permutations alone (the latency floor) and the design's
              critical path from the latency probes;
  7. small    two chained folds of the port on the card against the host
              NIFS on the test CCS (transcript, proofs, accumulator, the
              host verifier), with the row-constant and with a general
              dense Ajtai scheme, and with CCS constants that are not +-1
              (the lin comb kernels with ring constants, ROADMAP C.h4); one
              production-size general commit (kappa 32, N 98815, 14
              witnesses) against the plain chunked matvec, timed;
  8. mesh     the sharded sum-checks of latticeum_tpu_torch/parallel/ at
              the production shapes (the fold at m = 2^17, K = 15; the lin
              with the zkVM's 126 rows at its truncated width 2^14 of
              2^17; the row-constant Ajtai commit at kappa 32) in worlds of
              1 rank over NCCL and 2 and 4 ranks over gloo, all sharing
              this card, each rank a spawned process that joins through
              multihost.init_distributed: every rank bit-equal to its
              unsharded run, the slots CRT exchange at 2 x 2, the comb
              kernels and round_tail launched in every rank, one
              all-reduce per sharded round and one gather a sum-check, and
              at 1 rank one fetch per sum-check; times beside the
              unsharded ones (no multi-GPU scaling: one card);
  9. main     TorchZkVmProver(device="cuda") at default_params(): 3 steps of
              xorshift_guest(64) with acc_comm[0] pinned after each step
              (a checkpoint written after step 2), then 2 steps of the
              bench's fib guest; every fold of both passes the host NIFS
              verifier with the same folded accumulator; launch counts of
              every kernel (perm8 and sponge8 included: the memory and code
              trees of each prove_vm) > 0, and ring_contract called; each
              prove_vm's tree time and its parts; every lin and fold
              sum-check made exactly one device -> host copy (its lin
              reconstruction rounds included) and, under
              torch.cuda.set_sync_debug_mode("error"), no other
              synchronizing call;
  10. resume  a fresh TorchZkVmProver(debug=True) resumes from the step-2
              checkpoint and folds step 3: it must equal the continuous run
              (acc_comm, z_i_comm, ivc_step_comm, the accumulator's h, r, v,
              cm, u, the collector's vars) and reach the pinned acc_comm[0];
              its relation check ran; a step whose z was changed must raise;
  11. cli     python -m latticeum_tpu_torch.zkvm.cli --builtin fib100
              --max-steps 1 --vm-size 1mb --debug prints its JSON line;
  12. replay  the same 3 xorshift steps with the JAX package's stale
              lin-reconstruction betas replayed (ROADMAP C.h9: the first lin
              call's betas handed to every later call's reconstruction
              rounds) must give the acc_comm[0] values that package
              recorded on its TPU.
Then one JSON line of kernel records, the nvidia-smi name/power line, and
the result line {"ok": true, "device": {...}}.  Imports no jax and nothing
of the JAX package.

Each kernel record carries its bound: the largest of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s, its
IMAD instructions over the FMA pipe's 64 per SM per clock, its integer
ALU instructions (IADD3, LOP3, ISETP, SEL, SHF, ...) over the ALU pipe's
64 per SM per clock, and all its instructions over the issue rate of 128
per SM per clock (4 schedulers x 32 lanes), at the SM clock nvidia-smi
reports as its maximum.  The instructions are counted in SASS with
cuobjdump: csrc/poseidon2.cu built once more with its round loops
unrolled (-DP8_STRAIGHT_LINE) gives the one-lane perm8 kernel as
straight-line code, whose SASS is the count per permutation; every form
of perm8 and sponge8 is bounded by that count times its permutations,
whatever loops and shuffles its own SASS has; round_tail likewise by
its permutations times the SASS of one width-16 permutation, from
csrc/challenger.cu built with -DCH_STRAIGHT_LINE into a straight-line
one-thread kernel; the comb kernels loop, so their count is the field
operations of their bodies (from the shapes) times each operation's SASS,
counted in probe kernels that chain that operation of csrc/field.cuh.  The
digit-plane kernels are counted from their functions, never from their own
SASS: digit_split does DIGIT_OPS integer operations per value, and
plane_recombine per output its 243 plane products' sums plus the field
operations of RECOMBINE_OPS at the probes' SASS; the bytes bound both.
torch._int_mm is bounded by 2 M K N operations per slot over the card's
dense int8 tensor-core rate.
"""

import contextlib

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor cores, same sheet
# Per SM per clock on Hopper (sm_90): 64 lanes each for the FMA pipe's
# integer multiply-adds and for the integer ALU, and one warp instruction
# per scheduler, 4 x 32 thread instructions, issued.
PIPE_LANES, ISSUE_LANES = 64, 128
ALU_OPS = {"IADD3", "LOP3", "ISETP", "SEL", "SHF", "LEA", "PRMT", "IMNMX",
           "IABS", "PLOP3", "BMSK", "SGXT", "FLO", "POPC", "BREV"}
CLASSES = ("fma", "alu", "total")
# Probe kernels, one per field operation of csrc/field.cuh: two values
# loaded, CHAIN dependent steps of two operations each, two stored.
# (probe_op - probe_none) / (2 CHAIN) is one operation's SASS.
CHAIN = 64
PROBE_SRC = r"""
#include "field.cuh"
using namespace lt;
#define PROBE(name, step)                                                 \
  extern "C" __global__ void probe_##name(const u64 *a, u64 *o) {         \
    const int i = threadIdx.x;                                            \
    Fq3 x{a[i], a[i + 32], a[i + 64]}, y{a[i + 96], a[i + 128], a[i + 160]}; \
    _Pragma("unroll") for (int k = 0; k < CHAIN; ++k) { step; }           \
    o[i] = x.c0; o[i + 32] = x.c1; o[i + 64] = x.c2;                      \
    o[i + 96] = y.c0; o[i + 128] = y.c1; o[i + 160] = y.c2;               \
  }
PROBE(none, )
PROBE(add, x.c0 = gl_add(x.c0, y.c0); y.c0 = gl_add(y.c0, x.c0))
PROBE(sub, x.c0 = gl_sub(x.c0, y.c0); y.c0 = gl_sub(y.c0, x.c0))
PROBE(mul, x.c0 = gl_mul(x.c0, y.c0); y.c0 = gl_mul(y.c0, x.c0))
PROBE(mul_w, x.c0 = gl_mul_w(y.c0); y.c0 = gl_mul_w(x.c0))
PROBE(fq3_mul, x = fq3_mul(x, y); y = fq3_mul(y, x))
PROBE(fq3_square, x = fq3_square(y); y = fq3_square(x))
"""
PROBE_OPS = ("add", "sub", "mul", "mul_w", "fq3_mul", "fq3_square")
# Latency probes: one warp chains N dependent steps of one operation of
# csrc/challenger.cu (or field.cuh) between two clock64 reads that depend
# on the chain's value; (cycles at N = 96 - cycles at N = 32) / 64 is one
# step's latency in SM clocks, whatever the reads and set-up cost.  The
# chain is a loop unrolled 8 times, so its code stays in the instruction
# cache.
LATENCY_SRC = r"""
#include "challenger.cu"
__device__ __forceinline__ long long clk(u64 dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "l"(dep) : "memory");
  return t;
}
#define CHAIN(step) \
  _Pragma("unroll 8") for (int k = 0; k < N; ++k) { step; }
template <int N>
__global__ void __launch_bounds__(32)
    lat_kernel(int op, const u64 *a, u64 *o, long long *cyc) {
  const int lane = threadIdx.x;
  u64 x = a[lane];
  const u64 y = a[32 + lane];
  const long long t0 = clk(x);
  x ^= (u64)t0 >> 62;
  switch (op) {
    case 0: CHAIN(x = gl_mul(x, y)); break;
    case 1: CHAIN(x = gl_add(x, y)); break;
    case 2: CHAIN(x = __shfl_xor_sync(0xffffffffu, x, 1)); break;
    case 3: {
      Acc s = acc_of(x);
      const Acc b = acc_of(y);
      CHAIN(s = acc_add(s, b));
      x = (((u64)s.w1 << 32) | s.w0) ^ s.w2;
    } break;
    case 4: CHAIN(x = acc_fold(Acc{(u32)x, (u32)(x >> 32), (u32)x & 31u}));
      break;
  }
  const long long t1 = clk(x);
  o[lane] = x;
  cyc[lane] = t1 - t0;
}
extern "C" int lt_latency(int op, int n, const u64 *a, u64 *o,
                          long long *cyc) {
  if (n == 32) lat_kernel<32><<<1, 32>>>(op, a, o, cyc);
  else lat_kernel<96><<<1, 32>>>(op, a, o, cyc);
  return (int)cudaGetLastError();
}
"""
LATENCY_OPS = ("gl_mul", "gl_add", "shfl64", "acc_add", "acc_fold")
MUL3, SQR3 = {"fq3_mul": 1}, {"fq3_square": 1}
ADD3, SUB3 = {"add": 3}, {"sub": 3}
# One permutation of csrc/poseidon2.cu: 8 x 4 x 8 + 22 x (4 + 8) gl_mul;
# 9 x 34 (mds_light8) + 64 + 22 x 16 gl_add.
PERM8_OPS = {"mul": 520, "add": 722}
TPU_KERNELS = {"fold_round0": "latticeum_tpu/zkvm/pallas_comb.py:117",
               "fold_roundr": "latticeum_tpu/zkvm/pallas_comb.py:176",
               "lin_round0": "latticeum_tpu/zkvm/pallas_comb.py:317",
               "lin_roundr": "latticeum_tpu/zkvm/pallas_comb.py:365",
               "perm8": "latticeum_tpu/parallel/pallas_kernels.py:109",
               "perm8_sponge": "latticeum_tpu/parallel/pallas_kernels.py:109",
               # XLA functions of the JAX package, no Pallas kernel
               "digit_split": "latticeum_tpu/field/mxu.py:45",
               "plane_recombine": "latticeum_tpu/field/mxu.py:91",
               "round_tail": "latticeum_tpu/zkvm/accel_dev_fs.py:129"}
P8_SOURCE = "latticeum_tpu_torch/csrc/poseidon2.cu"
MXU_SOURCE = "latticeum_tpu_torch/csrc/mxu.cu"
CH_SOURCE = "latticeum_tpu_torch/csrc/challenger.cu"
MXU_KERNELS = ("digit_split", "plane_recombine")
# The instantiation whose SASS sets the per-permutation work of the bounds.
PERM8_ONE_LANE = "perm8_kernelILi1EE"
PERM16_ONE_THREAD = "perm16_straight_kernel"
# The digit split of one u64 value (field/mxu.py digit_planes): 8 digit
# steps of 4 integer operations (byte taken, carry added, compared, 256
# taken off); no multiply.
DIGIT_OPS = 8 * 4
# One output of the recombination (csrc/mxu.cu plane_recombine_kernel):
# besides its 3 x 81 int64 sums, two Horner chains of 17 steps over the
# digit weights, the nonresidue, the running sum.
RECOMBINE_OPS = {"mul": 34, "add": 36, "mul_w": 1}


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"== {name}")


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"nvidia-smi --query-gpu={query}: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from latticeum_tpu_torch import kernels
    from latticeum_tpu_torch.crypto import challenger, poseidon2
    from latticeum_tpu_torch.field import goldilocks as gl, mxu
    from latticeum_tpu_torch.host.crypto import native
    from latticeum_tpu_torch.zkvm import comb

    dev = torch.device("cuda")
    card, rate, mix, perm8_sass, perm16_sass, lat = device_and_build(
        torch, kernels, native)

    phase("tree")
    records = tree_checks(torch, np, gl, poseidon2, dev, rate, perm8_sass)

    phase("build prover")
    from latticeum_tpu_torch.host.vm.assembler import (fib_const_guest,
                                                       xorshift_guest)
    from latticeum_tpu_torch.host.vm.vm import new_vm_1mb
    from latticeum_tpu_torch.host.zkvm.params import default_params
    from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver
    t0 = time.time()
    prover = TorchZkVmProver(default_params(), device="cuda")
    ccs = prover.ccs
    log(f"prover ready: {time.time() - t0:.2f} s (m=2^{ccs.s}, t={ccs.t}, "
        f"multisets={len(ccs.S)}, lin cap={prover.dn._cap_pow2})")

    phase("kernels")
    if prover.dn._lin_sets.signs is None:
        fail("the CCS lin constants are not all +-1")
    records = kernel_checks(torch, np, gl, comb, ccs, prover.dn._lin_sets,
                            dev, rate, mix) + records

    phase("claims")
    records += claims_checks(torch, np, gl, mxu, prover, dev, rate, mix)

    phase("fiat-shamir")
    records += fiat_shamir_checks(torch, np, gl, prover, dev, rate,
                                  perm16_sass, lat)

    phase("small reference")
    small_reference(torch, dev, general=False)
    small_reference(torch, dev, general=True)
    small_reference(torch, dev, general=False, general_c=True)
    general_commit(torch, np, gl, prover, dev)

    phase("mesh")
    mesh_checks(card)

    phase("main path")
    folds = record_folds(prover)
    comb.reset_launches()
    mxu.reset_launches()
    poseidon2.perm8.launches = 0
    poseidon2.sponge8.launches = 0
    challenger.round_tail.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    with one_fetch_per_sumcheck(torch) as sumchecks:
        xs = prove(prover, new_vm_1mb().load_elf_data(xorshift_guest(64)), 3,
                   "xorshift_guest(64)", torch, checkpoint_dir=ckdir,
                   checkpoint_every=2)
        prove(prover, new_vm_1mb().load_elf_data(
            fib_const_guest(FIB_RESULT)), 2, "fib_const_guest", torch)
    launches = {w.__name__: w.launches for w in comb.WRAPPERS}
    launches["perm8"] = poseidon2.perm8.launches
    launches["perm8_sponge"] = poseidon2.sponge8.launches
    launches.update({w.__name__: w.launches for w in mxu.KERNELS})
    launches["round_tail"] = challenger.round_tail.launches
    contractions = mxu.ring_contract.calls
    log(f"sum-checks on the main path: {sumchecks['lin']} lin, "
        f"{sumchecks['fold']} fold, each with exactly one device -> host "
        "copy and no other synchronizing call")
    if not sumchecks["lin"] or not sumchecks["fold"]:
        fail("the main path ran no chained sum-check")
    del prover.fold                     # drop the recording wrapper
    log(f"launches on the main path: {launches}; ring_contract calls "
        f"{contractions}")
    if not all(v > 0 for v in launches.values()):
        fail("a kernel of the main path was never launched")
    if not contractions:
        fail("the main path made no ring_contract call")
    t0 = time.time()
    for i, (acc, cm_i, proof, folded) in enumerate(folds, start=1):
        if prover.verify_fold(acc, cm_i, proof) != folded:
            fail(f"fold {i}: the host verifier disagrees")
    log(f"folds 1-{len(folds)} pass the host NIFS verifier "
        f"({time.time() - t0:.1f} s)")
    check_acc0("xorshift", xs["acc0"], XORSHIFT_ACC0)

    phase("resume")
    try:
        resume_checks(torch, xs["state"], ckdir, xorshift_guest, new_vm_1mb,
                      default_params, TorchZkVmProver)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    phase("cli")
    cli_check()

    phase("replay of the recorded TPU run")
    with stale_lin_betas():
        replay = prove(prover, new_vm_1mb().load_elf_data(xorshift_guest(64)),
                       3, "xorshift_guest(64), stale lin betas", torch)
    check_acc0("xorshift replay", replay["acc0"], TPU_XORSHIFT_ACC0)
    leaked = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "latticeum_tpu."))
                    or m == "latticeum_tpu")
    if leaked:
        fail(f"imported {leaked[:5]}")
    for r in records:
        r["launches"] = launches[r["name"]]

    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def device_and_build(torch, kernels, native):
    """The device and build phases.  Returns the nvidia-smi name/power
    line, the rates of the bounds, the probes' SASS per field operation
    and the SASS per state of the one-lane perm8 form and of the
    one-thread width-16 permutation."""
    phase("device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if card.returncode != 0:
        fail("nvidia-smi does not read the card")
    card = card.stdout.strip().splitlines()[0]
    sm_mhz = float(smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = {"bytes": HBM_BYTES_PER_S,
            "pipe": sms * PIPE_LANES * sm_mhz * 1e6,
            "issue": sms * ISSUE_LANES * sm_mhz * 1e6}
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | "
        f"count={torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"rates: {sms} SMs x {sm_mhz:.0f} MHz: FMA and ALU pipes "
        f"{rate['pipe']:.4g}/s each ({PIPE_LANES} lanes), issue "
        f"{rate['issue']:.4g}/s ({ISSUE_LANES} lanes); HBM "
        f"{HBM_BYTES_PER_S:.4g} bytes/s")
    if not native.available():
        fail("the host copy's native Poseidon2 core did not build")
    log("native poseidon2 (host reference): built into "
        f"{os.path.relpath(native._lib_path(), ROOT)}")

    phase("build")
    t0 = time.time()
    lat_build = start_latency_build(kernels)
    so = kernels.build()
    kernels.lib()
    log(f"build: {time.time() - t0:.2f} s -> {os.path.relpath(so, ROOT)}")
    out = kernels.build_info.get("output", "")
    for line in out.splitlines():
        if "spill" in line and not line.strip().startswith("0 bytes"):
            log(f"  ptxas: {line.strip()}")
    for name, info in ptxas_by_function(out).items():
        if form_of(name):
            log(f"  ptxas {form_of(name)}: {info}")
    mix = probe_mix(kernels)
    for op in PROBE_OPS:
        log(f"SASS of one {op}: " + ", ".join(
            f"{c} {mix[op][c]:.2f}" for c in CLASSES))
    for name, info in ptxas_by_function(out).items():
        if any(k + "_kernel" in name for k in MXU_KERNELS):
            log(f"  ptxas {name}: {info}")
    for name, counts in sorted(sass_by_pipe(kernels, so).items()):
        if form_of(name):
            log(f"SASS of {form_of(name)} (per lane, static): " + ", ".join(
                f"{c} {counts[c]}" for c in CLASSES))
    perm8_sass = straight_line_sass(kernels, "poseidon2.cu",
                                    "P8_STRAIGHT_LINE", PERM8_ONE_LANE)
    model = pipes(PERM8_OPS, mix)
    log("perm8 straight-line one-lane kernel, SASS per state (the bounds' "
        "work per permutation): " + ", ".join(
            f"{c} {perm8_sass[c]}" for c in CLASSES) + "; its 520 gl_mul "
        "and 722 gl_add at the probes' SASS: " + ", ".join(
            f"{c} {model[c]:.0f}" for c in CLASSES))
    perm16_sass = straight_line_sass(kernels, "challenger.cu",
                                     "CH_STRAIGHT_LINE", PERM16_ONE_THREAD)
    log("perm16 straight-line one-thread kernel, SASS per state (the bound's "
        "work per width-16 permutation): " + ", ".join(
            f"{c} {perm16_sass[c]}" for c in CLASSES))
    for name, info in ptxas_by_function(out).items():
        if "round_tail" in name or "perm16_chain" in name:
            log(f"  ptxas {name}: {info}")
    rate["sm_mhz"] = sm_mhz
    lat = latencies(torch, *lat_build)
    log("latency of one dependent step, SM clocks (one warp, clock64): "
        + ", ".join(f"{k} {v:.1f}" for k, v in lat.items()))
    return card, rate, mix, perm8_sass, perm16_sass, lat


def start_latency_build(kernels):
    """Start nvcc on the latency probes (LATENCY_SRC) into a shared
    library beside the kernels' build.  Returns (process, library,
    source)."""
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    src = kernels.BUILD_DIR / f"latency_probe.{os.getpid()}.cu"
    lib = src.with_suffix(".so")
    src.write_text(LATENCY_SRC)
    proc = subprocess.Popen(
        [kernels.nvcc(), *kernels.ARCH_FLAGS, "-shared", "-Xcompiler",
         "-fPIC", "-I", str(kernels.CSRC), "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib, src


def latencies(torch, proc, lib, src):
    """{op: SM clocks of one dependent step} for LATENCY_OPS, each from
    two chain lengths."""
    import ctypes

    import numpy as np
    out = proc.communicate()[0]
    src.unlink(missing_ok=True)
    if proc.returncode != 0:
        fail(f"the latency probes did not build: {out}")
    try:
        so = ctypes.CDLL(str(lib))
    finally:
        lib.unlink(missing_ok=True)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    so.lt_latency.argtypes = [i32, i32, vp, vp, vp]
    so.lt_latency.restype = i32
    rng = np.random.default_rng(17)
    a = torch.from_numpy(rng.integers(0, 1 << 63, 64, dtype=np.int64)).cuda()
    o = torch.empty(32, dtype=torch.int64, device="cuda")
    cyc = torch.empty(32, dtype=torch.int64, device="cuda")
    res = {}
    for op, name in enumerate(LATENCY_OPS):
        clocks = {}
        for n in (32, 96):
            for _ in range(2):                  # the second run is timed
                err = so.lt_latency(op, n, a.data_ptr(), o.data_ptr(),
                                    cyc.data_ptr())
                if err:
                    fail(f"latency probe {name} did not launch ({err})")
                torch.cuda.synchronize()
            clocks[n] = int(cyc[0])
        res[name] = (clocks[96] - clocks[32]) / 64
    return res


def perm16_path(lat):
    """SM clocks of the critical path of one permutation of
    csrc/challenger.cu's permute16, as dependent steps times the probes'
    latencies: the initial linear layer; 8 external rounds of an s-box
    (3 dependent multiplies) and a linear layer (4 butterfly levels of a
    shuffle and an add, 2 adds, a fold); 22 internal rounds of an s-box,
    the larger of the diagonal multiply and the broadcast shuffle, 2 adds
    and a fold."""
    sbox = 3 * lat["gl_mul"]
    lin = (4 * (lat["shfl64"] + lat["acc_add"]) + 2 * lat["acc_add"]
           + lat["acc_fold"])
    tail = (max(lat["gl_mul"], lat["shfl64"]) + 2 * lat["acc_add"]
            + lat["acc_fold"])
    return lin + 8 * (sbox + lin) + 22 * (sbox + tail)


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


def graph_ms(torch, fn, reps):
    """Device time per call of `fn`: `reps` calls captured in a CUDA graph
    and replayed, so no host work lies between the launches."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, g.replay, 5) / reps


def profiled_ms(torch, fn, reps, kernel):
    """Mean duration of the launches of `kernel` (a substring of its name)
    that torch.profiler traces over `reps` calls of `fn`, or None where the
    trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for row in prof.key_averages():
        if kernel in row.key and row.count:
            total = getattr(row, "device_time_total", None)
            if total is None:
                total = row.cuda_time_total
            return total / row.count / 1e3
    return None


def sass_by_pipe(kernels, binary):
    """{function: {"fma", "alu", "total"}}: the SASS instructions of every
    function in `binary` (cuobjdump of the toolkit that built the kernels),
    up to its last EXIT and without NOPs.  IMAD/IMUL go to the FMA pipe,
    ALU_OPS to the integer ALU; "total" counts every instruction."""
    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(binary)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {binary}: {res.stderr.strip()}")
    funcs, ops = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            ops = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif ops is not None and line.strip().startswith("/*") and ";" in line:
            words = line.split("*/", 1)[1].split()
            if words[0].startswith("@"):
                words = words[1:]
            ops.append(words[0].rstrip(";").split(".")[0])
    out = {}
    for name, ops in funcs.items():
        last = max(i for i, op in enumerate(ops) if op == "EXIT")
        ops = [op for op in ops[:last + 1] if op != "NOP"]
        out[name] = {
            "fma": sum(op in ("IMAD", "IMUL") for op in ops),
            "alu": sum(op in ALU_OPS for op in ops), "total": len(ops)}
    return out


def probe_mix(kernels):
    """{op: {"fma", "alu", "total"}}: the SASS of one field operation of
    csrc/field.cuh, from probe kernels built with the kernels' flags."""
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    src = kernels.BUILD_DIR / f"sass_probe.{os.getpid()}.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(PROBE_SRC)
    try:
        res = subprocess.run(
            [kernels.nvcc(), "-cubin", *kernels.ARCH_FLAGS, f"-DCHAIN={CHAIN}",
             "-I", str(kernels.CSRC), "-o", str(cubin), str(src)],
            capture_output=True, text=True)
        if res.returncode != 0:
            fail(f"the SASS probe did not build: {res.stdout}{res.stderr}")
        sass = sass_by_pipe(kernels, cubin)
    finally:
        src.unlink(missing_ok=True)
        cubin.unlink(missing_ok=True)
    base = sass["probe_none"]
    return {op: {c: (sass[f"probe_{op}"][c] - base[c]) / (2 * CHAIN)
                 for c in CLASSES} for op in PROBE_OPS}


def straight_line_sass(kernels, source, define, function):
    """{"fma", "alu", "total"}: the SASS of one permutation, from the
    kernel source built with `define`, which unrolls its round loops into
    a one-thread kernel `function` (straight-line code, one state a
    thread)."""
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    cubin = kernels.BUILD_DIR / f"{function}.{os.getpid()}.cubin"
    try:
        res = subprocess.run(
            [kernels.nvcc(), "-cubin", *kernels.ARCH_FLAGS, f"-D{define}",
             "-o", str(cubin), str(kernels.CSRC / source)],
            capture_output=True, text=True)
        if res.returncode != 0:
            fail(f"the straight-line build of {source} failed: "
                 f"{res.stdout}{res.stderr}")
        found = [v for k, v in sass_by_pipe(kernels, cubin).items()
                 if function in k]
    finally:
        cubin.unlink(missing_ok=True)
    if len(found) != 1:
        fail(f"{function} not found once in the straight-line build")
    return found[0]


def tally(*terms):
    """Sum of (times, {op: count}) terms -> {op: count}."""
    out = {}
    for times, counts in terms:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + times * v
    return out


def pipes(ops, mix):
    """{"fma", "alu", "total"} instructions of the field operations `ops`."""
    return {c: sum(n * mix[op][c] for op, n in ops.items()) for c in CLASSES}


def fold_ops(rows, q, npts, b_small, fold):
    """Field operations of one fold comb launch (csrc/comb.cu fold_body)."""
    pt0 = 0 if fold else 2
    ev = (npts - pt0) * (b_small - 1)
    per_row = tally((1, SUB3), (2, MUL3), (2 * npts, ADD3),
                    (npts - pt0, SQR3), (npts - pt0, ADD3), (ev, MUL3),
                    (ev, {"sub": 1}))
    if fold:
        per_row = tally((1, per_row), (2, SUB3), (2, MUL3), (2, ADD3))
    return tally((8 * q * rows, per_row), (8 * q * npts, MUL3))


def lin_ops(sets, q, npts, fold):
    """Field operations of one lin comb launch (csrc/comb.cu lin_body),
    with +-1 signs or ring constants (one more Fq3 multiply a point)."""
    terms = [(npts, MUL3)]
    for s in sets.S:
        k = len(s)
        terms += [(k, SUB3), (k * npts, ADD3), ((k - 1) * npts, MUL3),
                  (npts, ADD3)]
        if sets.rings is not None:
            terms += [(npts, MUL3)]
        if fold:
            terms += [(2 * k, SUB3), (2 * k, MUL3), (2 * k, ADD3)]
    return tally((8 * q, tally(*terms)),)


def bound(rate, nbytes, work):
    """(ms, 'bytes' or 'operations', limit): the least time the card could
    take, and which of the four limits sets it."""
    times = {"bytes": nbytes / rate["bytes"],
             "fma": work["fma"] / rate["pipe"],
             "alu": work["alu"] / rate["pipe"],
             "issue": work["total"] / rate["issue"]}
    limit = max(times, key=times.get)
    return (times[limit] * 1e3, "bytes" if limit == "bytes" else "operations",
            limit)


def record(name, source, worst, ms, plain_ms, rate, nbytes, work):
    b_ms, by, limit = bound(rate, nbytes, work)
    log(f"{name}: bound {b_ms:.4f} ms by {limit} ({nbytes} bytes; "
        + ", ".join(f"{c} {work[c]:.4g}" for c in CLASSES)
        + f" instructions); kernel at {100 * b_ms / ms:.1f} % of it")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def u64_err(gl, np, a, b):
    """Largest |a - b| over the outputs, read as u64 (0 = bit-exact)."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    worst = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise SystemExit(f"FAIL: shapes {tuple(x.shape)} != "
                             f"{tuple(y.shape)}")
        u, v = gl.to_u64(x), gl.to_u64(y)
        if u.size:
            worst = max(worst, int(np.where(u > v, u - v, v - u).max()))
    return worst


def form_of(function):
    """'perm8 S=8' for a mangled perm8_kernel<8> (sponge8 alike), None for
    any other function."""
    m = re.search(r"(perm8|sponge8)_kernelILi(\d)EE", function)
    return m and f"{m.group(1)} S={m.group(2)}"


def form_label(lanes):
    return f"S={lanes}"


def ptxas_by_function(output):
    """{function: 'N registers, X bytes spill stores, Y bytes spill loads'}
    from the `-Xptxas -v` output of the build."""
    out, name = {}, None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in line:
            out[name]["spills"] = line.strip().split(", ", 1)[1]
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = re.search(r"Used (\d+) registers",
                                               line).group(1)
    return {k: f"{v.get('registers', '?')} registers, "
               f"{v.get('spills', 'spills not reported')}"
            for k, v in out.items()}


def edge_states(np, gl, n, seed):
    """(n, 8) random states whose first 48 rows hold each edge value in
    every position (the rest of those rows zero)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, gl.P, (n, 8), dtype=np.uint64)
    edges = (0, 1, 0xFFFFFFFF, 1 << 32, gl.P - 1, 2)
    rows = np.zeros((8 * len(edges), 8), np.uint64)
    for i, v in enumerate(edges):
        for lane in range(8):
            rows[8 * i + lane, lane] = v
    m = min(n, rows.shape[0])
    u[:m] = rows[:m]
    return u


def edge_rows(np, gl, n, length, seed):
    """(n, L) u32 words; the first words each edge value four times in a
    row, so in every rate position of an absorb."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 1 << 32, (n, length), dtype=np.uint64)
    edges = np.repeat(np.array([0, 1, 0xFFFFFFFF, 1 << 32, gl.P - 1, 2],
                               np.uint64), 4)[:u.size]
    u.reshape(-1)[:edges.size] = edges
    return u


def timed_once(torch, fn):
    """(fn(), its device ms by events): one call, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def tree_checks(torch, np, gl, poseidon2, dev, rate, perm8_sass):
    """Every form of perm8 and sponge8 against its twin and timed; then the
    memory and code roots built on the card against the host copy's native
    tree.  Returns the records of perm8 and perm8_sponge."""
    from latticeum_tpu_torch.host.vm.assembler import xorshift_guest
    from latticeum_tpu_torch.host.vm.vm import new_vm_1mb, new_vm_8mb
    from latticeum_tpu_torch.host.zkvm import commitments as host_comm
    from latticeum_tpu_torch.zkvm.commitments import (IncrementalMemTree,
                                                      ZkVmCommitter)

    forms = poseidon2.LANES
    one_lane = 1

    def perm_bound(perms, nbytes):
        return bound(rate, nbytes, {c: perm8_sass[c] * perms
                                    for c in CLASSES})[0]

    # perm8: every form bit-exact at every shape, then timed.  512 ... 1 are
    # the levels of the main path; 1024 and 8192 the leaf absorbs of the
    # 1 MB and 8 MB trees as the old loop ran them; 2048 ... 16384 set the
    # rule's bounds; the larger n fill the card.
    worst = 0
    inputs = {}
    for n in (1, 33, 64, 512, 1023, 1024, 2048, 4096, 8192, 16384, 65536,
              524288):
        x = torch.from_numpy(gl.to_i64_bits(edge_states(np, gl, n, n))).to(
            dev)
        want, twin_ms = timed_once(torch, lambda: poseidon2.perm8_twin(x))
        for form in forms:
            e = u64_err(gl, np, poseidon2.perm8_lanes(x, form), want)
            torch.cuda.synchronize()
            worst = max(worst, e)
            if e:
                fail(f"perm8 {form_label(form)} n={n}: max_abs_err={e}")
        log(f"perm8 n={n}: all {len(forms)} forms bit-exact with the twin "
            f"(twin {twin_ms:.3f} ms)")
        inputs[n] = (x, twin_ms)
    times = {}
    for n in (1, 64, 512, 1024, 2048, 4096, 8192, 16384, 65536, 524288):
        x = inputs[n][0]
        b_ms = perm_bound(n, 2 * 64 * n)
        for form in forms:
            fn = lambda: poseidon2.perm8_lanes(x, form)  # noqa: E731
            graph = graph_ms(torch, fn, 50)
            prof = profiled_ms(torch, fn, 50, "perm8_kernel")
            times[n, form] = graph
            log(f"perm8 n={n} {form_label(form)}: {graph:.4f} ms (CUDA graph "
                "of 50), " + (f"{prof:.4f} ms (profiler, kernel mean)"
                              if prof is not None
                              else "profiler: not measured")
                + f"; bound {b_ms:.5f} ms, {100 * b_ms / graph:.1f} % of it")
        best = min(forms, key=lambda f: times[n, f])
        pick = poseidon2.kernel_lanes(n)
        log(f"perm8 n={n}: fastest {form_label(best)} {times[n, best]:.4f} "
            f"ms; perm8 picks {form_label(pick)} {times[n, pick]:.4f} ms; "
            f"one-lane form {times[n, one_lane]:.4f} ms "
            f"({times[n, one_lane] / times[n, pick]:.2f}x the pick)")
    for n in (8192, 512):               # PR 2's record shape, the path's
        pick = poseidon2.kernel_lanes(n)
        log(f"perm8 n={n}: kernel ({form_label(pick)}) {times[n, pick]:.4f} "
            f"ms (CUDA graph of 50), twin {inputs[n][1]:.3f} ms (one call)")
    records = [record("perm8", P8_SOURCE, worst, times[512, pick],
                      inputs[512][1], rate, 2 * 64 * 512,
                      {c: perm8_sass[c] * 512 for c in CLASSES})]

    # sponge8: every form bit-exact at every shape, then timed at the page
    # shapes beside 64 perm8 launches of the old loop over the same rows.
    worst = 0
    page = {}
    for n, length in ((1, 1), (3, 7), (6, 9), (300, 1), (33, 5),
                      (1023, 12), (1024, 256), (2048, 256), (4096, 256),
                      (8192, 256), (16384, 256)):
        x = torch.from_numpy(edge_rows(np, gl, n, length, n + length).astype(
            np.int64)).to(dev)
        want, twin_ms = timed_once(torch, lambda: poseidon2.sponge8_twin(x))
        for form in forms:
            e = u64_err(gl, np, poseidon2.sponge8_lanes(x, form), want)
            torch.cuda.synchronize()
            worst = max(worst, e)
            if e:
                fail(f"sponge8 {form_label(form)} {n} x {length}: "
                     f"max_abs_err={e}")
        log(f"sponge8 {n} x {length}: all {len(forms)} forms bit-exact with "
            f"the twin (twin {twin_ms:.3f} ms)")
        if length == 256 and n >= 1024:
            page[n] = (x, twin_ms)
    one_row = page[1024][0][:1].contiguous()
    for n, (x, twin_ms) in page.items():
        perms = n * 64
        b_ms = perm_bound(perms, 8 * n * 256 + 8 * n * 4)
        stimes = {}
        for form in forms:
            fn = lambda: poseidon2.sponge8_lanes(x, form)  # noqa: E731
            stimes[form] = graph_ms(torch, fn, 10)
            prof = profiled_ms(torch, fn, 10, "sponge8_kernel")
            log(f"sponge8 {n} x 256 {form_label(form)}: {stimes[form]:.4f} ms "
                "(CUDA graph of 10), " + (f"{prof:.4f} ms (profiler, kernel "
                                          "mean)" if prof is not None else
                                          "profiler: not measured")
                + f"; bound {b_ms:.4f} ms, {100 * b_ms / stimes[form]:.1f} % "
                "of it")
        loops = {}
        for form in (one_lane, poseidon2.kernel_lanes(n)):
            perm = lambda s, f=form: poseidon2.perm8_lanes(s, f)  # noqa: E731
            loops[form] = graph_ms(
                torch, lambda: poseidon2.sponge8_twin(x, perm=perm), 10)
            log(f"sponge as 64 perm8 launches ({form_label(form)}) "
                f"{n} x 256: {loops[form]:.4f} ms (CUDA graph of 10)")
        pick = poseidon2.kernel_lanes(n)
        floor = graph_ms(torch, lambda: poseidon2.sponge8_lanes(
            one_row, pick), 10)
        best = min(forms, key=stimes.get)
        log(f"sponge8 {n} x 256: fastest {form_label(best)} "
            f"{stimes[best]:.4f} ms; sponge8 picks {form_label(pick)} "
            f"{stimes[pick]:.4f} ms, {loops[one_lane] / stimes[pick]:.2f}x "
            f"faster than the old loop of the one-lane form; bound "
            f"{b_ms:.4f} ms; the 64-absorb chain of one row alone "
            f"{floor:.4f} ms (the latency floor); twin {twin_ms:.3f} ms")
        if n == 1024:
            records.append(record(
                "perm8_sponge", P8_SOURCE, worst, stimes[pick], twin_ms, rate,
                8 * n * 256 + 8 * n * 4,
                {c: perm8_sass[c] * perms for c in CLASSES}))

    committer, host = ZkVmCommitter(dev), host_comm.ZkVmCommitter()
    for label, make in (("1 MB", new_vm_1mb), ("8 MB", new_vm_8mb)):
        vm = make().load_elf_data(xorshift_guest(64))
        times = []
        for _ in range(2):              # the first call includes the upload
            torch.cuda.synchronize()
            t0 = time.time()
            root = committer.vm_mem_comm(vm)
            times.append(time.time() - t0)
        t0 = time.time()
        want = host.vm_mem_comm(vm)
        t_host = time.time() - t0
        log(f"memory root {label} ({vm.page_count} pages): card "
            f"{times[0]:.4f} s, again {times[1]:.4f} s; host native "
            f"{t_host:.4f} s; {'equal' if root == want else 'DIFFERENT'}")
        if root != want:
            fail(f"the {label} memory root built on the card differs")
        parts = {}
        t0 = time.perf_counter()
        tree = IncrementalMemTree(vm, dev, timings=parts)
        total = time.perf_counter() - t0
        if tree.root != want:
            fail(f"the {label} IncrementalMemTree root differs")
        log(f"page tree {label} (IncrementalMemTree, synchronized parts): "
            f"{total:.4f} s = " + ", ".join(
                f"{k.split('.', 1)[1]} {v[0]:.4f}" for k, v in parts.items()))
        code = vm.elf.raw_code.bytes
        if committer.vm_code_comm(code) != host.vm_code_comm(code):
            fail("the code root built on the card differs")
    log("code root (xorshift_guest(64)): equal")
    return records


def kernel_checks(torch, np, gl, comb, ccs, sets_prod, dev, rate, mix):
    """Every comb kernel against its twin: small shape, then production
    shape (timed); the lin kernels also with ring constants c_i (random
    rings, not +-1) at the production shape, timed too.  Returns the
    kernel records (launches filled in later)."""
    rng = np.random.default_rng(7)

    def rnd(*shape):
        u = rng.integers(0, gl.P, shape, dtype=np.uint64)
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    def r3():                           # the challenge, read on the card
        return rnd(3)

    sets_small = comb.lin_sets([(0, 3, 5), (1,), (2, 4)], (1, -1, 1), 6, dev)
    ring_rng = np.random.default_rng(8)
    sets_ring = comb.lin_sets_general(
        sets_prod.S, [[int(v) for v in ring_rng.integers(0, gl.P, 24,
                                                         dtype=np.uint64)]
                      for _ in sets_prod.S], sets_prod.rows, dev)
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

    def cost(w, X, sets):
        """(bytes, work by pipe) of one production launch of `w`."""
        rows, width = X.shape[0], X.shape[-1]
        fold = w.__name__.endswith("roundr")
        q = width // (4 if fold else 2)
        if w.__name__.startswith("fold"):
            npts = 2 * b_small
            nbytes = 8 * (X.numel() + 24 * q + 3 * rows + npts * 24)
            ops = fold_ops(rows, q, npts, b_small, fold)
        else:
            npts = deg_q
            nbytes = 8 * (X.numel() + 24 * q + npts * 24)
            if sets.rings is not None:
                nbytes += 8 * sets.rings.numel()
            ops = lin_ops(sets, q, npts, fold)
        if fold:
            nbytes += 8 * rows * 24 * 2 * q      # the folded F written
        return nbytes, pipes(ops, mix)

    def with_rings(make):
        def ring_args():
            args = make()
            return args[:-2] + (sets_ring, args[-1])
        return ring_args

    records = []
    for w in comb.WRAPPERS:
        twin = comb.TWINS[w]
        small, prod = cases[w.__name__]
        worst = 0
        steps = [("small", small), ("production", prod)]
        if w.__name__.startswith("lin"):
            steps.insert(1, ("production, ring constants", with_rings(prod)))
        for label, make in steps:
            args = make()
            got = w(*args)
            want = twin(*args)
            torch.cuda.synchronize()
            e = u64_err(gl, np, got, want)
            worst = max(worst, e)
            shape = tuple(args[0].shape)
            log(f"{w.__name__} {label} X{shape}: "
                f"{'bit-exact' if e == 0 else f'MISMATCH max_abs_err={e}'}")
            if e:
                fail(f"{w.__name__} disagrees with its twin")
            if label == "production, ring constants":
                ring_ms = cuda_ms(torch, lambda: w(*args), 5)
                ring_b = bound(rate, *cost(w, args[0], sets_ring))[0]
                log(f"{w.__name__} production, ring constants: kernel "
                    f"{ring_ms:.3f} ms, bound {ring_b:.4f} ms, "
                    f"{100 * ring_b / ring_ms:.1f} % of it")
            del got, want
        ms = cuda_ms(torch, lambda: w(*args), 5)
        plain_ms = cuda_ms(torch, lambda: twin(*args), 1)
        log(f"{w.__name__} production: kernel {ms:.3f} ms, twin "
            f"{plain_ms:.3f} ms")
        records.append(record(w.__name__, "latticeum_tpu_torch/csrc/comb.cu",
                              worst, ms, plain_ms, rate,
                              *cost(w, args[0], sets_prod)))
        del args
        torch.cuda.empty_cache()
    return records


def fiat_shamir_checks(torch, np, gl, prover, dev, rate, perm16_sass, lat):
    """round_tail against its twin (the wrapper on CPU copies of the same
    inputs), bit for bit: at the production lin and fold round shapes and
    unweighted, each at every pending length 0 ... 11, then over a chain of
    34 launches (a step's 14 factored and 3 reconstruction lin rounds, then
    17 fold rounds) against the twin's chain; perm16_chain against its twin.
    Each shape timed by a CUDA graph beside its bound, the chain of its
    permutations alone and the design's critical path (perm16_path, from
    the latency probes `lat`).  Returns round_tail's record (the fold
    round)."""
    from latticeum_tpu_torch.crypto import challenger
    from latticeum_tpu_torch.zkvm import accel_rounds
    rng = np.random.default_rng(13)
    deg_l, npts_h = prover.ccs.d + 1, 2 * prover.params.B_SMALL
    lags = {"lin": gl.from_int([accel_rounds._lagrange_ext_consts(
                deg_l, deg_l + 1)], dev),
            "fold": gl.from_int(accel_rounds.fold_lagrange(
                npts_h, npts_h + 1), dev),
            "unweighted": None}
    n_msgs = {"lin": deg_l + 1, "fold": npts_h + 1, "unweighted": deg_l + 1}

    def rnd(*shape):
        return torch.from_numpy(gl.to_i64_bits(rng.integers(
            0, gl.P, shape, dtype=np.uint64))).to(dev)

    def case(kind, b, nv):
        lag, n_msg = lags[kind], n_msgs[kind]
        tables = 0 if lag is None else lag.shape[0]
        rows = n_msg if lag is None else lag.shape[2]
        z = lambda *s: torch.zeros(s, dtype=gl.DTYPE, device=dev)  # noqa: E731
        return {"sums": rnd(rows, 24), "lag": lag,
                "points": rnd(tables, nv, 3) if tables else None,
                "E": rnd(tables, 3) if tables else None, "state": rnd(16),
                "pend": rnd(b), "msgs": z(nv, n_msg, 24), "chals": z(nv, 3)}

    def tail(x, r):
        challenger.round_tail(x["sums"], x["lag"], x["points"], x["E"],
                              x["state"], x["pend"], x["msgs"], x["chals"],
                              r, weighted=x["lag"] is not None)

    def copy(x, d):
        return {k: None if v is None else v.to(d).clone()
                for k, v in x.items()}

    def err(a, b, keys):
        return max(u64_err(gl, np, a[k].cpu(), b[k])
                   for k in keys if a[k] is not None)

    worst = 0
    out_keys = ("msgs", "chals", "state", "E")
    for kind in lags:
        for b in range(12):
            x = case(kind, b, 4)
            got, want = copy(x, dev), copy(x, "cpu")
            tail(got, 2)
            tail(want, 2)
            torch.cuda.synchronize()
            e = err(got, want, out_keys)
            worst = max(worst, e)
            if e:
                fail(f"round_tail {kind}, {b} pending: max_abs_err={e}")
        log(f"round_tail {kind} (n_msg {n_msgs[kind]}): bit-exact with the "
            "twin at every pending length 0 ... 11")

    # a step's chain: 14 + 3 lin rounds, then 17 fold rounds
    lin_x, rec_x, fold_x = case("lin", 5, 17), case("unweighted", 0, 17), \
        case("fold", 0, 17)
    sums = {k: rnd(17, *x["sums"].shape) for k, x in
            (("lin", lin_x), ("unweighted", rec_x), ("fold", fold_x))}

    def chain(d):
        lx, fx = copy(lin_x, d), copy(fold_x, d)
        st = lx["state"]
        for r in range(17):
            kind = "lin" if r < 14 else "unweighted"
            x = dict(lx, sums=sums[kind][r].to(d),
                     pend=lx["pend"] if r == 0 else lx["chals"][r - 1])
            if kind == "unweighted":
                x.update(lag=None, points=None, E=None)
            tail(x, r)
        for r in range(17):
            tail(dict(fx, state=st, sums=sums["fold"][r].to(d),
                      pend=lx["chals"][16] if r == 0 else fx["chals"][r - 1]),
                 r)
        return lx, fx
    got, want = chain(dev), chain("cpu")
    torch.cuda.synchronize()
    e = max(err(got[0], want[0], out_keys), err(got[1], want[1], out_keys))
    worst = max(worst, e)
    if e:
        fail(f"round_tail chain of 34 launches: max_abs_err={e}")
    log("round_tail: a chain of 34 launches (14 lin, 3 unweighted, 17 fold "
        "rounds) bit-exact with the twin's chain")
    u = rnd(16)
    for n in (1, 13):
        if not torch.equal(challenger.perm16_chain(u, n).cpu(),
                           challenger.perm16_chain_twin(u.cpu(), n)):
            fail(f"perm16_chain n={n} differs from its twin")
    log("perm16_chain n=1, 13: bit-exact with the twin")

    path = perm16_path(lat)
    mhz = rate["sm_mhz"]
    log(f"perm16 critical path of the design: {path:.0f} SM clocks a "
        f"permutation from its dependent steps ({path / mhz:.3f} us at "
        f"{mhz:.0f} MHz)")
    rec = None
    for kind in ("fold", "lin", "unweighted"):
        b = 3                                   # rounds after the first
        x = case(kind, b, 4)
        n_msg = n_msgs[kind]
        perms = challenger.permutations(b + 24 * n_msg)
        ms = graph_ms(torch, lambda: tail(x, 2), 50)
        st = rnd(16)
        floor = graph_ms(torch, lambda: challenger.perm16_chain(st, perms),
                         50)
        y = copy(x, dev)
        _, plain_ms = timed_once(torch, lambda: challenger.round_tail_twin(
            y["sums"], y["lag"], None if y["points"] is None
            else y["points"][:, 2], y["E"], y["state"], y["pend"],
            y["lag"] is not None))
        tables = 0 if x["lag"] is None else x["lag"].shape[0]
        nbytes = 8 * (x["sums"].numel() + (0 if x["lag"] is None else
                                           x["lag"].numel())
                      + 3 * tables * 3 + 2 * 16 + b + 24 * n_msg + 3 + 166)
        work = {c: perm16_sass[c] * perms for c in CLASSES}
        b_ms = bound(rate, nbytes, work)[0]
        per_perm = 1e3 * floor / perms
        log(f"round_tail {kind} (L = {b + 24 * n_msg}, {perms} "
            f"permutations): {ms:.4f} ms (CUDA graph of 50); the chain of "
            f"its {perms} permutations alone {floor:.4f} ms (the latency "
            f"floor of the design), {per_perm:.3f} us = "
            f"{per_perm * mhz:.0f} SM clocks a permutation against the "
            f"critical path's {path:.0f}; bound {b_ms:.6f} ms, "
            f"{100 * b_ms / ms:.3f} % of it; twin {plain_ms:.3f} ms (one "
            "call)")
        if kind == "fold":
            rec = record("round_tail", CH_SOURCE, worst, ms, plain_ms, rate,
                         nbytes, work)
    return [rec]


MESH_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
MESH_FOLD = (1 << 17, 15)          # m, K: the production fold sum-check
MESH_LIN = (17, 1 << 14)           # nv, n0: the zkVM's truncated lin stack
MESH_CRT_BATCH = 256


def mesh_checks(card):
    """The sharded sum-checks (latticeum_tpu_torch/parallel/) at the
    production shapes, in worlds of 1 rank over NCCL and of 2 and 4 ranks
    over gloo, all on this one card (NCCL takes one rank per device; gloo
    stages each collective through host memory): every rank's proof,
    challenges, finals and transcript equal its unsharded run on the same
    inputs, the sharded Ajtai commitment the single one, the slots CRT
    exchange the replicated CRT (4 ranks as 2 x 2); every rank launched
    the comb kernels and round_tail; the communicator counted one
    all-reduce per sharded round and one gather a sum-check; the world of
    one keeps one fetch per sum-check with no other synchronizing call.
    Ranks that share one card measure no multi-GPU scaling."""
    from latticeum_tpu_torch.parallel import lin_mesh, multihost
    S_c = lin_mesh._zkvm_S_c()
    log(f"mesh: {card} (every rank on cuda:0)")
    for world, backend in MESH_WORLDS:
        t0 = time.time()
        try:
            ranks = multihost.spawn_ranks(world, backend, mesh_rank, S_c,
                                          "cuda", MESH_FOLD, MESH_LIN,
                                          timeout_s=60, wait_s=300)
        except (RuntimeError, TimeoutError) as e:
            fail(f"mesh world {world} over {backend}: {e}")
        log(f"mesh world {world} over {backend}: {time.time() - t0:.1f} s "
            "with the ranks' start")
        for rank, res in enumerate(ranks):
            for kind in ("fold", "lin"):
                mesh_check_run(kind, f"world {world} rank {rank}", res[kind])
            if world == 4 and not (res["crt"]["equal"]
                                   and res["crt"]["exchanged"]):
                fail(f"rank {rank}: the slots CRT exchange differs")
            if "fetches" in res:
                log(f"mesh rank {rank}: sharded sum-checks "
                    f"{res['fetches']} with one fetch each and no other "
                    "synchronizing call")
        if world == 4:
            log(f"mesh slots CRT exchange ({MESH_CRT_BATCH} x 24 on a 2 x 2 "
                f"mesh) equals the replicated CRT on every rank: "
                f"{ranks[0]['crt']['collectives']}")


def mesh_check_run(kind, where, res):
    """One rank's sharded-vs-single dict of a `kind` ("fold" or "lin")
    sum-check: equal, counted, launched."""
    name = f"{kind} {where}"
    for key in ("proof_equal", "chals_equal", "final_equal",
                "transcript_equal", "ajtai_equal"):
        if not res.get(key, True):
            fail(f"mesh {name}: {key} is false")
    calls = res["collectives"]["calls"]
    if (calls.get("all_gather") != 1 or res["rounds_sharded"] < 1
            or res["rounds_sharded"] >= res["rounds_total"]):
        fail(f"mesh {name}: collectives {calls} over "
             f"{res['rounds_total']} rounds")
    if not all(v > 0 for k, v in res["launches"].items()
               if k.startswith(kind) or k == "round_tail"):
        fail(f"mesh {name}: a kernel was not launched: {res['launches']}")
    ar_s = res["collectives"]["seconds"].get("all_reduce", 0.0)
    log(f"mesh {name} ({res['backend']}): sharded {res['sharded_s']:.4f} s "
        f"vs unsharded {res['single_s']:.4f} s on this card; "
        f"{res['rounds_sharded']} of {res['rounds_total']} rounds sharded, "
        f"all-reduces {calls['all_reduce']} "
        f"({res['collectives']['bytes']['all_reduce']} bytes, "
        f"{ar_s:.4f} s = {ar_s / res['sharded_s']:.3f} of the sharded "
        f"time), gather 1 ({res['collectives']['bytes']['all_gather']} "
        f"bytes); launches {res['launches']}")


def mesh_rank(comm, S_c, device, fold, lin):
    """One rank of a mesh world (spawned by mesh_checks): after one warm
    unsharded run of each, the fold (m, K) and lin (nv, n0) sum-checks
    sharded vs unsharded on `device`, the slots CRT exchange at 4 ranks
    and, over NCCL, both sharded sum-checks once more under
    one_fetch_per_sumcheck."""
    import torch
    from latticeum_tpu_torch.parallel import fold_mesh, lin_mesh, mesh as M
    if device == "cuda":
        torch.cuda.set_device(0)
    fold_in = fold_mesh.fold_inputs(fold[0].bit_length() - 1, fold[1],
                                    device=device)
    lin_in = lin_mesh.lin_inputs(*lin, S_c, device=device)
    # Out of the timings: NCCL makes its communicator at the first
    # collective, and a first sum-check loads the kernels and fills the
    # allocator's cache.
    comm.all_reduce_field(torch.zeros(1, dtype=torch.int64, device=device))
    fold_mesh.run_fold_sumcheck(fold_in)
    lin_mesh.run_lin_sumcheck(lin_in)
    out = {"fold": fold_mesh.sharded_vs_single(comm, *fold, device=device),
           "lin": lin_mesh.sharded_lin_vs_single(comm, *lin, device,
                                                 S_c=S_c)}
    if comm.world == 4:
        crt = lin_mesh.slots_crt_exchange(
            M.make_mesh(4, device),
            lin_mesh.crt_batch(MESH_CRT_BATCH, device=device))
        out["crt"] = {k: crt[k] for k in ("equal", "exchanged",
                                          "collectives")}
    if comm.backend == "nccl":
        with one_fetch_per_sumcheck(torch) as seen:
            fold_mesh.run_fold_sumcheck(fold_in, comm)
            lin_mesh.run_lin_sumcheck(lin_in, comm)
        out["fetches"] = seen
    return out


def small_reference(torch, dev, general, general_c=False):
    """Two chained folds of TorchNifs on the card vs the host NIFS, with
    the row-constant or a general dense Ajtai scheme; with general_c, on
    the test CCS with c = [rho, -rho] for a full random ring rho (not +-1:
    the lin comb kernels take the rings, ROADMAP C.h4).  Each fold also
    passes the host verifier and launches the lin comb kernels."""
    import dataclasses

    import numpy as np
    from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme
    from latticeum_tpu_torch.host.crypto.transcript import Transcript
    from latticeum_tpu_torch.host.field import goldilocks as glr, host as H
    from latticeum_tpu_torch.host.nifs import linearization as lin, nifs
    from latticeum_tpu_torch.host.nifs.nifs import DecompositionParams
    from latticeum_tpu_torch.host.nifs.structs import CCCS, Witness
    from latticeum_tpu_torch.host.nifs.test_fixtures import (
        TEST_B, TEST_B_SMALL, TEST_K, TEST_L, get_test_ccs, get_test_z,
        z_to_device)
    from latticeum_tpu_torch.zkvm import comb
    from latticeum_tpu_torch.zkvm.accel import Engine
    from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs

    params = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                                 K=TEST_K)
    ccs = get_test_ccs()
    if general_c:
        rho = [int(v) for v in np.random.default_rng(61).integers(
            0, glr.P, 24, dtype=np.uint64)]
        ccs = dataclasses.replace(ccs, c=[rho, H.ntt_neg(rho)])
    cms, wits, scheme = [], [], None
    for x in (3, 5):
        z = get_test_z(x)
        wit = Witness.from_w_ccs(z_to_device(z[2:]), TEST_B, TEST_L)
        if scheme is None:
            n = int(wit.f[0].shape[0])
            scheme = (AjtaiScheme.from_seed_general(4, n, seed=2) if general
                      else AjtaiScheme.from_seed(kappa=4, n=n))
        cms.append(CCCS(cm=scheme.commit_host(wit.f), x_ccs=z[:1]))
        wits.append(wit)
    acc_wit = Witness.from_w_ccs(glr.zeros((ccs.n - ccs.l - 1, 24)), TEST_B,
                                 TEST_L)
    acc, _, _ = lin.prove(CCCS(cm=scheme.commit_host(acc_wit.f),
                               x_ccs=[H.ntt_zero()]), acc_wit, Transcript(),
                          ccs)
    e = Engine(ccs, dev)
    dn = TorchNifs(e, ccs, params, scheme)
    if dn.general_ajtai != general:
        fail("TorchNifs took the wrong Ajtai route")
    if (dn._lin_sets.signs is None) != general_c:
        fail("TorchNifs took the wrong lin route")
    lin_kernels = comb.lin_round0.launches + comb.lin_roundr.launches
    acc_h, w_h, acc_d = acc, acc_wit, acc
    w_d = dn.build_witness(e.put(acc_wit.w_ccs))
    for i, (cm_i, wit) in enumerate(zip(cms, wits), start=1):
        th, td = Transcript(), Transcript()
        acc_prev = acc_h
        acc_h, w_h, ph = nifs.prove(acc_h, w_h, cm_i, wit, th, ccs, scheme,
                                    params)
        acc_d, w_d, pd = dn.prove(acc_d, w_d, cm_i,
                                  dn.build_witness(e.put(wit.w_ccs)), td)
        if (list(th.ch.state) != list(td.ch.state) or ph != pd
                or acc_h != acc_d):
            fail(f"small fold {i} differs from the host NIFS")
        if nifs.verify(acc_prev, cm_i, pd, Transcript(), ccs,
                       params) != acc_d:
            fail(f"small fold {i}: the host verifier disagrees")
    if comb.lin_round0.launches + comb.lin_roundr.launches == lin_kernels:
        fail("the small folds launched no lin comb kernel")
    log("small reference: 2 chained folds match the host NIFS (transcript, "
        "proofs, accumulator) and pass its verifier, "
        + ("general dense Ajtai scheme" if general else
           "row-constant Ajtai scheme")
        + (", CCS constants c = [rho, -rho] for a random ring rho (the "
           "lin comb kernels with ring constants)" if general_c else ""))


def int8_err(a, b):
    """Largest |a - b| over two int8 tensors of one shape."""
    if a.shape != b.shape:
        fail(f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def claims_checks(torch, np, gl, mxu, prover, dev, rate, mix):
    """digit_split and plane_recombine against their twins at edge shapes
    and at the four production shapes of the claims; ring_contract against
    the slot-wise products at edge shapes and at the fold-eta and dec-v
    shapes; every part timed beside its bound.  Returns the two kernels'
    records, at the fold-eta shape (the largest contraction of a step)."""
    from latticeum_tpu_torch.host.nifs.structs import TAU
    from latticeum_tpu_torch.zkvm import claims
    ccs, K = prover.ccs, prover.params.K
    rng = np.random.default_rng(11)
    edges = gl.from_int([0, 1, gl.P - 1, gl.P - 2, 0xFFFFFFFF, 1 << 32,
                         1 << 63, 0x7F7F7F7F7F7F7F7F, 0x8080808080808080],
                        dev)
    worst = {k: 0 for k in MXU_KERNELS}

    def rnd(*shape):
        x = torch.from_numpy(gl.to_i64_bits(rng.integers(
            0, gl.P, shape, dtype=np.uint64))).to(dev)
        m = min(x.numel(), edges.numel())
        x.view(-1)[:m] = edges[:m]
        return x

    def shape_of(rows, n, t_layout):
        return (rows, 24, n) if t_layout else (rows, n, 24)

    def split(x, t_layout, label):
        got = mxu.digit_split(x, t_layout)
        e = int8_err(got.data, mxu.digit_split_twin(x, t_layout).data)
        worst["digit_split"] = max(worst["digit_split"], e)
        if e:
            fail(f"digit_split {label}: max_abs_err={e} against its twin")
        return got

    def recombine(O, t, kb, label):
        start = rnd(t, kb, 24)
        e = u64_err(gl, np, mxu.plane_recombine(O, start.clone()),
                    mxu.plane_recombine_twin(O, start.clone()))
        worst["plane_recombine"] = max(worst["plane_recombine"], e)
        if e:
            fail(f"plane_recombine {label}: max_abs_err={e} against its twin")

    def contract(A, B, t_layout, label):
        """ring_contract against the claims' slot-wise forms (t-layout:
        f_hat rows against one eq table, as on the main path)."""
        got = mxu.ring_contract(A, B, t_layout)
        if t_layout:
            want, ms = timed_once(torch, lambda: claims.eval_fhat_slotwise(
                A, B[0])[:, None])
        else:
            want, ms = timed_once(torch, lambda: claims.eval_claims_slotwise(
                A, B).transpose(0, 1))
        if not torch.equal(got, want):
            fail(f"ring_contract {label} differs from the slot-wise products")
        return ms

    # edge shapes: one column, ragged columns, several chunks (CHUNK_N cut
    # down), padding rows and columns in every chunk
    chunk0 = mxu.CHUNK_N
    try:
        for rows, kb, n, t_layout, chunk in (
                (1, 1, 1, False, chunk0), (3, 1, 100, True, chunk0),
                (2, 3, 37, False, 16), (4, 1, 1000, True, 256),
                (1, 1, 33, True, 16), (5, 4, 4100, False, 1024)):
            mxu.CHUNK_N = chunk
            label = f"{rows}x{kb}, n={n}, chunk {chunk}" + (
                ", t-layout" if t_layout else "")
            A = rnd(*shape_of(rows, n, t_layout))
            B = rnd(*shape_of(kb, n, t_layout))
            split(A, t_layout, label)
            split(B, t_layout, label)
            contract(A, B, t_layout, label)
    finally:
        mxu.CHUNK_N = chunk0
    for t, kb in ((1, 1), (3, 2), (2, 1), (7, 5)):
        ra, rb = -(-27 * t // 8) * 8, -(-27 * kb // 8) * 8
        O = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, ra, rb),
                                          dtype=np.int64).astype(np.int32))
        O.view(-1)[:4] = torch.tensor([-(1 << 31), (1 << 31) - 1, -1, 0],
                                      dtype=torch.int32)
        recombine(O.to(dev), t, kb, f"{t}x{kb}")
    log("digit_split, plane_recombine and ring_contract bit-exact at the "
        "edge shapes (several chunks, padding, int32 extremes)")

    t, n, m = ccs.t, ccs.n, ccs.m
    cases = (("dec u", False, (t, n, 24), (K, n, 24)),
             ("fold eta", False, (t, n, 24), (2 * K, n, 24)),
             ("dec v", True, (K * TAU, 24, m), (1, 24, m)),
             ("lin v", True, (TAU, 24, m), (1, 24, m)))
    records = []
    for label, t_layout, sa, sb in cases:
        A, B = rnd(*sa), rnd(*sb)
        pa = split(A, t_layout, f"{label} A{sa}")
        pb = split(B, t_layout, f"{label} B{sb}")
        ta, tb = sa[0], sb[0]
        chunks = list(zip(pa.chunks(), pb.chunks()))
        O = torch.empty((8, pa.rows_pad, pb.rows_pad), dtype=torch.int32,
                        device=dev)

        def gemms():
            for la, lb in chunks:
                for s in range(8):
                    torch._int_mm(la[s], lb[s].t(), out=O[s])
        gemms()
        recombine(O, ta, tb, label)
        acc = torch.zeros((ta, tb, 24), dtype=gl.DTYPE, device=dev)
        ms = {"split A": cuda_ms(torch, lambda: mxu.digit_split(A, t_layout),
                                 3),
              "split B": cuda_ms(torch, lambda: mxu.digit_split(B, t_layout),
                                 3),
              "int_mm": cuda_ms(torch, gemms, 3),
              "recombine": cuda_ms(torch, lambda: mxu.plane_recombine(
                  O, acc), 3),
              "recombine graph": graph_ms(torch, lambda: mxu.plane_recombine(
                  O, acc), 20),
              "ring_contract": cuda_ms(torch, lambda: mxu.ring_contract(
                  A, B, t_layout), 3)}
        twin = {"split A": timed_once(torch, lambda: mxu.digit_split_twin(
                    A, t_layout))[1],
                "recombine": timed_once(torch, lambda: mxu.plane_recombine_twin(
                    O, acc.clone()))[1]}
        if label in ("fold eta", "dec v"):
            twin["slot-wise"] = contract(A, B, t_layout, label)
        nchunks = len(chunks)
        split_bytes = 8 * A.numel() + pa.data.numel()
        split_work = {"fma": 0, "alu": DIGIT_OPS * A.numel(),
                      "total": DIGIT_OPS * A.numel()}
        split_b = bound(rate, split_bytes, split_work)
        mm_ops = 2 * (27 * ta) * pa.n * (27 * tb) * 8
        mm_bytes = (pa.data.numel() + pb.data.numel()
                    + 4 * O.numel() * nchunks)
        mm_bound = max(mm_ops / INT8_OPS_PER_S, mm_bytes / HBM_BYTES_PER_S)
        rec_bytes = 4 * 8 * (27 * ta) * (27 * tb) + 16 * ta * tb * 24
        rec_one = pipes(RECOMBINE_OPS, mix)
        rec_work = {c: ta * tb * 24 * (rec_one[c] + (c != "fma") * 243)
                    for c in CLASSES}
        rec_b = bound(rate, rec_bytes, rec_work)
        log(f"claims {label}: A{sa} x B{sb}{' t-layout' if t_layout else ''}"
            f", {nchunks} chunk(s) of {pa.chunk}, GEMM per slot and chunk "
            f"{pa.rows_pad} x {pa.chunk} x {pb.rows_pad}: bit-exact; ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + "; plain (one call): " + ", ".join(
                f"{k} {v:.3f}" for k, v in twin.items()))
        log(f"claims {label} bounds: split A {split_b[0]:.4f} ms by "
            f"{split_b[2]} ({split_bytes} bytes), {100 * split_b[0] / ms['split A']:.1f}"
            f" %; int_mm {1e3 * mm_bound:.4f} ms ({mm_ops:.4g} int8 "
            f"operations at {INT8_OPS_PER_S:.4g}/s, {mm_bytes} bytes), "
            f"{100e3 * mm_bound / ms['int_mm']:.1f} %; recombine "
            f"{rec_b[0]:.5f} ms by {rec_b[2]} ({rec_bytes} bytes), "
            f"{100 * rec_b[0] / ms['recombine']:.1f} % (per chunk; "
            f"{100 * rec_b[0] / ms['recombine graph']:.1f} % of the graph "
            "time)")
        if label == "fold eta":
            records.append(record(
                "digit_split", MXU_SOURCE, worst["digit_split"],
                ms["split A"], twin["split A"], rate, split_bytes,
                split_work))
            records.append(record(
                "plane_recombine", MXU_SOURCE, worst["plane_recombine"],
                ms["recombine"], twin["recombine"], rate, rec_bytes,
                rec_work))
        del A, B, pa, pb, chunks, O, acc
        torch.cuda.empty_cache()
    for r in records:
        r["max_abs_err"] = worst[r["name"]]
    return records


def general_commit(torch, np, gl, prover, dev):
    """One production-size general Ajtai commit (the K - 1 commits of a
    decomposition) against the plain chunked matvec, timed."""
    from latticeum_tpu_torch.host.commit.ajtai import AjtaiScheme
    from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs, matvec_general
    p = prover.params
    n = prover.layout.w_size * p.L
    t0 = time.time()
    scheme = AjtaiScheme.from_seed_general(p.KAPPA, n, seed=0)
    t_scheme = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    dn = TorchNifs(prover.dn.e, prover.ccs, p, scheme)
    torch.cuda.synchronize()
    t_up = time.time() - t0
    rng = np.random.default_rng(5)
    f = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, gl.P, (p.K - 1, n, 24), dtype=np.uint64))).to(dev)
    got = dn._commit_many(f)
    mat = gl.from_limbs(scheme.matrix, dev)    # the reference's own copy
    want, twin_ms = timed_once(torch, lambda: matvec_general(mat, f))
    if not torch.equal(got, want):
        fail("the general Ajtai commit differs from the plain matvec")
    ms = cuda_ms(torch, lambda: dn._commit_many(f), 3)
    ops = 2 * (27 * p.KAPPA) * n * (27 * (p.K - 1)) * 8
    log(f"general Ajtai commit, kappa={p.KAPPA}, N={n}, {p.K - 1} witnesses: "
        f"bit-exact with the chunked matvec; {ms:.3f} ms (split of the "
        f"witnesses, int8 products, recombination; {ops:.4g} int8 operations"
        f", bound {1e3 * ops / INT8_OPS_PER_S:.4f} ms), plain matvec "
        f"{twin_ms:.1f} ms; the matrix ({p.KAPPA * n * 24 * 8} bytes) "
        f"uploaded and split once in {t_up:.2f} s, sampled on the host in "
        f"{t_scheme:.2f} s")
    del dn, mat, f, got, want
    torch.cuda.empty_cache()


def resume_checks(torch, cont, ckdir, xorshift_guest, new_vm_1mb,
                  default_params, TorchZkVmProver):
    """A fresh debug prover resumes the xorshift run from its step-2
    checkpoint and must equal the continuous run after step 3; then a step
    whose z was changed must fail the relation check."""
    from latticeum_tpu_torch.zkvm import prover as prover_mod
    t0 = time.time()
    fresh = TorchZkVmProver(default_params(), device="cuda", debug=True)
    log(f"fresh prover (debug): {time.time() - t0:.2f} s")
    res = prove(fresh, new_vm_1mb().load_elf_data(xorshift_guest(64)), 3,
                "xorshift_guest(64) resumed after step 2", torch,
                checkpoint_dir=ckdir, resume=True)
    if res["acc0"] != [XORSHIFT_ACC0[2]]:
        fail(f"resumed run: acc_comm[0] {res['acc0']} after step 3")
    st = res["state"]
    for k in ("acc_comm", "z_i_comm", "ivc_step_comm", "folding_proof_vars"):
        if getattr(st, k) != getattr(cont, k):
            fail(f"resumed run: {k} differs from the continuous run")
    for k in ("h", "r", "v", "cm", "u"):
        if getattr(st.acc, k) != getattr(cont.acc, k):
            fail(f"resumed run: acc.{k} differs from the continuous run")
    checks = fresh.timings.get("relation_check", [])
    if len(checks) != 1:
        fail(f"resumed run: {len(checks)} relation checks for 1 step")
    log(f"resumed run equals the continuous one after step 3 (acc_comm, "
        f"z_i_comm, ivc_step_comm, acc h/r/v/cm/u, collector vars); "
        f"relation check {checks[0]:.3f} s, host verifier "
        f"{fresh.timings['native_verify'][0]:.3f} s")
    real = prover_mod.arithmetize

    def changed(inp, lay):
        # the value the step's instruction writes to rd (the guest's first
        # instruction is a LUI, whose gate constrains it)
        z = real(inp, lay)
        i = lay.val_rd_out_idx
        z[i] = [(v + 1) % (2 ** 64 - 2 ** 32 + 1) for v in z[i]]
        return z
    prover_mod.arithmetize = changed
    try:
        fresh.prove_vm(new_vm_1mb().load_elf_data(xorshift_guest(64)),
                       max_steps=1)
    except AssertionError as e:
        log(f"changed z: the debug prover raised: {e}")
    else:
        fail("a step with a changed z passed the relation check")
    finally:
        prover_mod.arithmetize = real
    del fresh
    torch.cuda.empty_cache()


def cli_check():
    """The port's CLI on the card: one debug step of the fib guest."""
    cmd = [sys.executable, "-m", "latticeum_tpu_torch.zkvm.cli", "--builtin",
           "fib100", "--max-steps", "1", "--vm-size", "1mb", "--debug"]
    t0 = time.time()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        fail(f"{' '.join(cmd[1:])} exited {res.returncode}: "
             f"{res.stdout[-1500:]}{res.stderr[-3000:]}")
    last = res.stdout.strip().splitlines()[-1]
    out = json.loads(last)
    if out.get("steps_folded") != 1 or len(out.get("acc_comm", [])) != 4:
        fail(f"the CLI's result line: {last}")
    log(f"cli ({time.time() - t0:.1f} s): {last}")


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
    into a jit keyed by shape only (ROADMAP C.h9).  The port's chained
    runner takes the reconstruction rounds' betas as an argument: the
    first call's are handed to every later call."""
    from latticeum_tpu_torch.zkvm import accel_rounds
    exact = accel_rounds.run_lin_rounds_factored
    first = []

    def stale(transcript, g_t, nv, degree, sets, beta_s, log=None):
        if not first:
            first.append(list(beta_s))
        return exact(transcript, g_t, nv, degree, sets, beta_s,
                     recon_betas=first[0], log=log)
    accel_rounds.run_lin_rounds_factored = stale
    try:
        yield
    finally:
        accel_rounds.run_lin_rounds_factored = exact


@contextlib.contextmanager
def one_fetch_per_sumcheck(torch):
    """Watch every chained sum-check (both runners of zkvm/accel_rounds.py):
    it must copy from the device to the host exactly once (accel_rounds.
    fetches), and with torch.cuda.set_sync_debug_mode("error") around it
    no other synchronizing CUDA call may happen.  Yields {"lin": calls,
    "fold": calls}; fails at the first fault."""
    from latticeum_tpu_torch.zkvm import accel_rounds
    seen = {"lin": 0, "fold": 0}
    real = {k: getattr(accel_rounds, k) for k in (
        "run_lin_rounds_factored", "run_fold_rounds_factored", "_fetch")}

    def fetch(*tensors):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real["_fetch"](*tensors)
        finally:
            torch.cuda.set_sync_debug_mode(2)

    def watch(kind, run):
        def watched(*args, **kwargs):
            seen[kind] += 1
            before = accel_rounds.fetches
            torch.cuda.set_sync_debug_mode(2)
            try:
                out = run(*args, **kwargs)
            except RuntimeError as e:
                if "synchronizing" not in str(e):
                    raise
                fail(f"{kind} sum-check {seen[kind]} synchronized: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            n = accel_rounds.fetches - before
            if n != 1:
                fail(f"{kind} sum-check {seen[kind]}: {n} fetches")
            return out
        return watched
    accel_rounds.run_lin_rounds_factored = watch(
        "lin", real["run_lin_rounds_factored"])
    accel_rounds.run_fold_rounds_factored = watch(
        "fold", real["run_fold_rounds_factored"])
    accel_rounds._fetch = fetch
    try:
        yield seen
    finally:
        for k, v in real.items():
            setattr(accel_rounds, k, v)


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


def prove(prover, vm, steps, name, torch, **options):
    """prove_vm up to `steps` (options: checkpoint_dir, checkpoint_every,
    resume), with each folded step's time and acc_comm[0] logged.  Returns
    {"acc0": acc_comm[0] after each step folded, "state": the last state}."""
    from latticeum_tpu_torch.zkvm.commitments import IncrementalMemTree
    prover.timings = {}
    marks, acc0 = [time.time()], []

    def on_step(step, state):
        torch.cuda.synchronize()
        marks.append(time.time())
        acc0.append(state.acc_comm[0])
        log(f"{name} step {step}: {marks[-1] - marks[-2]:.2f} s "
            f"acc_comm[0]={state.acc_comm[0]:#x}")
    state = prover.prove_vm(vm, max_steps=steps, on_step=on_step, **options)
    if state.steps != steps:
        fail(f"{name} folded {state.steps} of {steps} steps")
    if len(state.acc_comm) != 4 or not all(
            0 <= int(v) < (1 << 64) for v in state.acc_comm):
        fail(f"{name} acc_comm malformed")
    phases = {k: [round(v, 3) for v in vs] for k, vs in prover.timings.items()}
    log(f"{name} phase seconds: {json.dumps(phases)}")
    log(f"{name} trees: {prover.timings['trees'][0]:.4f} s = code "
        f"{prover.timings['trees.code'][0]:.4f} + page tree " + ", ".join(
            f"{part} {prover.timings['trees.' + part][0]:.4f}"
            for part in IncrementalMemTree.PARTS))
    log(f"{name} max_memory_allocated: {torch.cuda.max_memory_allocated()} "
        f"bytes")
    return {"acc0": acc0, "state": state}


if __name__ == "__main__":
    sys.exit(main())
