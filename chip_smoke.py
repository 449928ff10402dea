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
              production shape, timed; lin_recon_tail (csrc/recon.cu)
              against its twin at the main path's reconstruction tail
              (125 Mz rows folded into a table of 8 columns, 3 rounds at
              9 points, their challenger, the final rows; signs, ring
              constants and the stale-beta replay's betas and scale),
              timed by a CUDA graph beside its bound, its chain floor
              (perm16_chain at its 63 permutations) and the launch floor;
              fold_c_round (csrc/comb.cu) against its twin at every fold
              round width 2^17 ... 2 (round 0 on the head's row-strided
              rows), the
              clusters of its kernel the card holds at once, two launches
              in flight on two streams (8 times, each against its twin:
              ROADMAP C.h10), its pair sums alone at the lin widths and its
              end mode, timed by CUDA graphs beside their bounds; then
              (phase coo)
              coo_matvec (csrc/coo.cu) against its twin in the prover's
              two plain segment maps (M z, M^T eq with its 704-entry
              segments) with the CCS's scalar values and with ring
              values, each timed by a CUDA graph beside its bound;
              coo_head (csrc/coo.cu) against its twin once a c row: the
              fold head's challenged z over 2K witnesses added into both
              c rows of a head in one launch, at production size with
              scalar and ring values and p - 1 among values, inputs and
              rows, on ragged CSRs (a 705-entry segment, fewer segments
              than blocks, one and three witnesses a row) and two launches
              in flight on two streams (8 times, each against its twin),
              timed by a CUDA graph beside its bound; then (phase
              sum-check launches) one fold and one lin sum-check at the
              main path's shapes traced by torch.profiler in a fresh
              process: the fold's device launches fewer than
              FOLD_SUMCHECK_LAUNCHES;
  5. ring     crt and icrt (ring/rq.py, csrc/ring.cu) against their dense
              twins at 15 x 98815 rings (dec's crt(ks)), 19,763 and
              98,815, with rows of p - 1 and edge values, each timed by a
              CUDA graph beside its bound; the ring multiply-accumulate
              ring_mac (ring/rq.py, csrc/ringmac.cu) against its twins at
              the fold's f0 (2K = 30 terms of 98,815 rings, two batches
              read where they lie) and dec's row-constant commits (kappa
              32 rings by K - 1 = 14 totals) and y0, each timed by a CUDA
              graph beside its bound;
     decompose  the witness pipelines' digit kernels (csrc/decompose.cu)
              against their twins, bit for bit, with edge values in the
              first words (0, 1, p - 1, (p -/+ 1) / 2, low digits of b/2
              and b/2 + 1 on both signs, values beyond b^count / 2):
              balanced_digits as commit_z's gadget digits (19,763 rings,
              b = 2^15, L = 5) and dec's k vectors (98,815 rings, b = 2,
              K = 15), digit_recompose as dec's gadget recomposition (15 x
              98,815 rings) and the fold's witness_from_f, row_sums as
              dec's commit sums (14 x 98,815) and commit's (98,815); each
              timed by a CUDA graph beside its bound;
  6. claims   the digit-plane kernels (digit_split, plane_recombine) against
              their twins at edge shapes (several chunks, every padding) and
              at the four production shapes of the evaluation claims (dec u,
              fold eta, dec v, lin v); ring_contract against the slot-wise
              products at the fold-eta and dec-v shapes; times of the split,
              the torch._int_mm products, the recombination (CUDA events
              over 3 calls, the record, and a CUDA graph of 20), the whole
              contraction and the slot-wise form, each beside its bound;
  7. fiat-shamir  round_tail (crypto/challenger.py, csrc/challenger.cu)
              against its twin, bit for bit, at the production lin and fold
              round shapes and unweighted (the lin reconstruction rounds),
              each at every pending length 0 ... 11, and over a chain of 34
              launches (a step's 17 lin and 17 fold rounds) against the
              twin's chain; perm16_chain against its twin; each shape timed
              (CUDA graph) beside its bound, the chain of its
              permutations alone (the latency floor) and the design's
              critical path from the latency probes;
  8. tables   eq_table and head_alpha (zkvm/tables.py, csrc/tables.cu)
              against their twins, bit for bit: eq_table in both layouts
              at 1 ... 2^17 rows, truncated (skipped top variables) and
              not, with random points and with every coordinate p - 1;
              head_alpha at the production tail 90 x 24 x 2^17 with rows
              of p - 1; each timed (CUDA graph) beside its bound and twin;
  9. small    two chained folds of the port on the card against the host
              NIFS on the test CCS (transcript, proofs, accumulator, the
              host verifier), with the row-constant and with a general
              dense Ajtai scheme, and with CCS constants that are not +-1
              (the lin comb kernels with ring constants, ROADMAP C.h4); one
              production-size general commit (kappa 32, N 98815, 14
              witnesses) against the plain chunked matvec, timed;
  10. mesh     the sharded sum-checks of latticeum_tpu_torch/parallel/ at
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
  11. main    TorchZkVmProver(device="cuda") at default_params(): 3 steps of
              xorshift_guest(64) with acc_comm[0] pinned after each step
              (a checkpoint written after step 2), then 2 steps of the
              bench's fib guest; every fold of both passes the host NIFS
              verifier with the same folded accumulator; launch counts of
              every kernel (perm8 and sponge8 included: the memory and code
              trees of each prove_vm) > 0, eq_table at least 10 a fold and
              head_alpha one a fold, crt and icrt at least 5 a step,
              lin_recon_tail once a lin sum-check, round_tail once a
              factored lin round and a fold round, coo_matvec once a lin
              and three times a fold step (mz_stack; mt_eq_stack twice in
              dec and once in the fold), coo_head once a fold step (both
              c rows of the head), fold_c_round
              once a fold round, once a fold sum-check's end and once a
              factored lin round, ring_mac's sum mode three times a fold
              step (f0, and dec's y0 twice) and its product mode,
              ring_mul_each, twice a fold step (dec's commits) and once a
              lin sum-check (the commit of its witness), balanced_digits
              once a build_witness and a dec_prove, digit_recompose once a
              dec_prove and a witness_from_f(_coeff), row_sums once a
              commit and a dec_prove (the calls counted), their twins
              never, and ring_contract called; each prove_vm's tree time
              and its parts; every lin and fold sum-check made exactly one device -> host copy (its lin
              reconstruction rounds included) and, under
              torch.cuda.set_sync_debug_mode("error"), no other
              synchronizing call;
  12. resume a fresh TorchZkVmProver(debug=True) resumes from the step-2
              checkpoint and folds step 3: it must equal the continuous run
              (acc_comm, z_i_comm, ivc_step_comm, the accumulator's h, r, v,
              cm, u, the collector's vars) and reach the pinned acc_comm[0];
              its relation check ran; a step whose z was changed must raise;
  13. cli    python -m latticeum_tpu_torch.zkvm.cli --builtin fib100
              --max-steps 1 --vm-size 1mb --debug prints its JSON line;
  14. replay the same 3 xorshift steps with the JAX package's stale
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
dense int8 tensor-core rate.  eq_table and head_alpha are counted from
their functions at the probes' SASS: the doubling's 2 (rows - 1) Fq3
multiplies for eq_table; for head_alpha the least of two ways to form
the linear sums unreduced (head_alpha_ops: 64x64 -> 128-bit
multiply-adds into 192-bit sums, one reduction an output); the bytes
bound both.  crt and icrt are counted from the butterfly networks
(CRT_OPS: 48 and 72 multiplies, 85 adds or subtracts a ring, never the
dense twin's 576 products) at the probes' SASS, beside their 384 bytes a
ring; lin_recon_tail from its rounds' field operations (recon_tail_ops:
the lin comb's with the eq row as its weight, the folds, the eq row) and
its permutations at the straight-line SASS of one, beside its chain
floor, perm16_chain at its permutations; coo_matvec from the
multiply-adds that its unreduced sums need (9 an Fq3 product, 3 a scalar
one, a reduction an output) and its bytes, the rows gathered counted
once; coo_head from the least of two ways to form the challenged z
unreduced once for each distinct (matrix, column) pair of the entries,
on which alone it depends (coo_head_ops: the schoolbook's 9
multiply-adds a witness, w zeta formed once a witness and matrix, or
Karatsuba's 6 and its recombination), a reduction a pair, the value's
product an entry and a reduction an output, beside its bytes (only the
non-empty rows read back); and beside the entry-wise formula (the
challenged z formed for every entry and slot, w zeta with it);
fold_c_round from its pair sums, its four unreduced Fq3 products a column
and its folds, beside its bytes; ring_mac from its 9 multiply-adds a
term and slot (unreduced), a reduction an output and the constants' w c1
and w c2, beside its bytes (each term read once, the batches not copied);
balanced_digits from BALANCED_DIGIT_OPS integer operations a digit,
digit_recompose from L - 1 gl_mul and gl_add an output at the probes'
SASS, row_sums from ROW_SUM_OPS a word, each beside its bytes.
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
STARTED = time.time()
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
// mac192 into a sum held in x's words, its product on the chain;
// reduce192 of a sum whose high words are on the chain.
__device__ __forceinline__ void mac_x(Fq3 &x, u64 b) {
  U192 s{x.c0, x.c1, (unsigned)x.c2};
  mac192(s, s.hi, b);
  x = Fq3{s.lo, s.hi, s.top};
}
__device__ __forceinline__ u64 red_x(u64 lo, u64 hi, u64 top) {
  return reduce192(U192{lo, hi, (unsigned)top});
}
PROBE(mac192, mac_x(x, y.c0); mac_x(x, y.c1))
PROBE(reduce192,
      x.c0 = red_x(y.c1, x.c0, x.c2); x.c2 = red_x(y.c2, x.c2, x.c0))
"""
PROBE_OPS = ("add", "sub", "mul", "mul_w", "fq3_mul", "fq3_square", "mac192",
             "reduce192")
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
               "round_tail": "latticeum_tpu/zkvm/accel_dev_fs.py:129",
               "eq_table": "latticeum_tpu/zkvm/accel.py:141",
               "head_alpha": "latticeum_tpu/zkvm/accel_nifs.py:997",
               "crt": "latticeum_tpu/ring/rq.py:61",
               "lin_recon_tail": "latticeum_tpu/zkvm/accel_dev_fs.py:212",
               "coo_matvec": "latticeum_tpu/zkvm/accel.py:117",
               "coo_head": "latticeum_tpu/zkvm/accel_nifs.py:997",
               "fold_c_round": "latticeum_tpu/zkvm/accel_rounds.py:403",
               "ring_mac": "latticeum_tpu/zkvm/accel_nifs.py:796",
               "balanced_digits": "latticeum_tpu/ring/decompose.py:49",
               "digit_recompose": "latticeum_tpu/ring/decompose.py:77",
               "row_sums": "latticeum_tpu/zkvm/accel_nifs.py:510"}
P8_SOURCE = "latticeum_tpu_torch/csrc/poseidon2.cu"
MXU_SOURCE = "latticeum_tpu_torch/csrc/mxu.cu"
CH_SOURCE = "latticeum_tpu_torch/csrc/challenger.cu"
TABLES_SOURCE = "latticeum_tpu_torch/csrc/tables.cu"
RING_SOURCE = "latticeum_tpu_torch/csrc/ring.cu"
COMB_SOURCE = "latticeum_tpu_torch/csrc/comb.cu"
COO_SOURCE = "latticeum_tpu_torch/csrc/coo.cu"
RINGMAC_SOURCE = "latticeum_tpu_torch/csrc/ringmac.cu"
RECON_SOURCE = "latticeum_tpu_torch/csrc/recon.cu"
DECOMPOSE_SOURCE = "latticeum_tpu_torch/csrc/decompose.cu"
# A fold sum-check on the main path makes fewer device launches than this
# (kernels and copies, counted by torch.profiler): a round's fold_c_round,
# tail comb (two launches) and round_tail, the end, the uploads and fetch.
FOLD_SUMCHECK_LAUNCHES = 120
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
# One ring element of the butterfly networks (csrc/ring.cu, ref_impl):
# crt's stages 36 multiplies, 48 adds, 36 subtracts, its homogenisation 12
# multiplies and a negation; icrt's dehomogenisation 12 and a negation,
# two inverse stages 24 multiplies, 24 adds, 24 subtracts, the stage-1
# inverse 36 multiplies, 12 adds, 24 subtracts.
CRT_OPS = {"crt": {"mul": 48, "add": 48, "sub": 37},
           "icrt": {"mul": 72, "add": 36, "sub": 49}}
# One balanced digit (ring/decompose.py decompose_balanced): the low bits
# taken, compared with b/2, b - r selected, the shift and carry added, the
# sign's xor, its negation and selection: 8 integer operations, no
# multiply.  One word of a row sum: a 64-bit add carried into 192 bits,
# 3 integer operations.
BALANCED_DIGIT_OPS = 8
ROW_SUM_OPS = 3


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"== {name} (at {time.time() - STARTED:.0f} s)")


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
    from latticeum_tpu_torch.ring import decompose, rq
    from latticeum_tpu_torch.zkvm import (accel, accel_nifs, accel_rounds,
                                          comb, tables)

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
    records += recon_checks(torch, np, gl, comb, accel_rounds, prover, dev,
                            rate, mix, perm16_sass)
    records += fold_c_checks(torch, np, gl, comb, prover, dev, rate, mix)

    phase("coo")
    records += coo_checks(torch, np, gl, prover, dev, rate, mix)
    records += coo_head_checks(torch, np, gl, prover, dev, rate, mix)

    phase("ring")
    records += ring_checks(torch, np, gl, rq, dev, rate, mix)
    records += ringmac_checks(torch, np, gl, rq, prover, dev, rate, mix)

    phase("decompose")
    records += decompose_checks(torch, np, gl, prover, dev, rate, mix)

    phase("claims")
    records += claims_checks(torch, np, gl, mxu, prover, dev, rate, mix)

    phase("fiat-shamir")
    records += fiat_shamir_checks(torch, np, gl, prover, dev, rate,
                                  perm16_sass, lat)

    phase("tables")
    records += tables_checks(torch, np, gl, prover, dev, rate, mix)

    phase("small reference")
    small_reference(torch, dev, general=False)
    small_reference(torch, dev, general=True)
    small_reference(torch, dev, general=False, general_c=True)
    general_commit(torch, np, gl, prover, dev)

    phase("mesh")
    mesh_checks(card)

    phase("sum-check launches")
    sumcheck_launches(prover)

    phase("main path")
    folds = record_folds(prover)
    comb.reset_launches()
    mxu.reset_launches()
    poseidon2.perm8.launches = 0
    poseidon2.sponge8.launches = 0
    challenger.round_tail.launches = 0
    tables.reset_launches()
    rq.reset_launches()
    accel.coo_matvec.launches = accel.coo_head.launches = 0
    decompose.reset_launches()
    accel_nifs.row_sums.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    with one_fetch_per_sumcheck(torch) as sumchecks, \
            counted_calls(prover.dn, WITNESS_CALLS) as calls, \
            counted_calls(decompose, DIGIT_TWINS) as twins:
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
    launches.update({k.__name__: k.launches for k in tables.KERNELS})
    launches["crt"] = rq.crt.launches + rq.icrt.launches
    launches["lin_recon_tail"] = comb.lin_recon_tail.launches
    launches["coo_matvec"] = accel.coo_matvec.launches
    launches["coo_head"] = accel.coo_head.launches
    launches["fold_c_round"] = comb.fold_c_round.launches
    launches["ring_mac"] = rq.ring_mac.launches + rq.ring_mul_each.launches
    launches["balanced_digits"] = decompose.decompose_balanced.launches
    launches["digit_recompose"] = decompose.recompose.launches
    launches["row_sums"] = accel_nifs.row_sums.launches
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
    if launches["eq_table"] < 10 * len(folds) or \
            launches["head_alpha"] != len(folds):
        fail(f"{len(folds)} folds launched eq_table {launches['eq_table']} "
             f"times (at least 10 a fold) and head_alpha "
             f"{launches['head_alpha']} (one a fold)")
    if not rq.crt.launches or not rq.icrt.launches or \
            launches["crt"] < 5 * len(folds):
        fail(f"{len(folds)} steps launched crt {rq.crt.launches} and icrt "
             f"{rq.icrt.launches} times (at least 5 a step in all)")
    n_fact = accel_rounds._factored_rounds(prover.dn._cap_pow2, ccs.s)
    if launches["lin_recon_tail"] != sumchecks["lin"]:
        fail(f"{sumchecks['lin']} lin sum-checks launched lin_recon_tail "
             f"{launches['lin_recon_tail']} times, not once each")
    # the reconstruction rounds' tails run inside lin_recon_tail
    want_rt = sumchecks["fold"] * ccs.s + sumchecks["lin"] * n_fact
    if launches["round_tail"] != want_rt:
        fail(f"round_tail launched {launches['round_tail']} times, not "
             f"{want_rt} ({ccs.s} rounds a fold sum-check, {n_fact} "
             "factored rounds a lin sum-check)")
    # one mz_stack a lin; three mt_eq_stack (dec twice, fold once) a fold
    # step; one coo_head (both c rows) a fold step: lin + 4 fold in all
    want_coo = sumchecks["lin"] + 3 * sumchecks["fold"]
    if launches["coo_matvec"] != want_coo or \
            launches["coo_head"] != sumchecks["fold"]:
        fail(f"coo_matvec launched {launches['coo_matvec']} times, not "
             f"{want_coo} (one a lin, three a fold step), and coo_head "
             f"{launches['coo_head']}, not {sumchecks['fold']} (one a fold "
             "step)")
    # the sum mode: f0 and dec's y0 twice, a fold step; the product mode:
    # dec's commits twice a fold step and the commit of each lin sum-check's
    # witness (commit_z, the initial accumulator's)
    want_mac = 3 * sumchecks["fold"]
    want_each = 2 * sumchecks["fold"] + sumchecks["lin"]
    if rq.ring_mac.launches != want_mac or \
            rq.ring_mul_each.launches != want_each:
        fail(f"ring_mac launched {rq.ring_mac.launches} times, not "
             f"{want_mac} (f0 and dec's y0 twice, a fold step), and "
             f"ring_mul_each {rq.ring_mul_each.launches}, not {want_each} "
             "(dec's commits twice a fold step, a commit a lin sum-check)")
    want_fc = sumchecks["fold"] * (ccs.s + 1) + sumchecks["lin"] * n_fact
    if launches["fold_c_round"] != want_fc:
        fail(f"fold_c_round launched {launches['fold_c_round']} times, not "
             f"{want_fc} (a round and the end a fold sum-check, a pair sum "
             "a factored lin round)")
    check_digit_launches(launches, calls, twins)
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
        if any(k in name for k in ("round_tail", "perm16_chain",
                                   "lin_recon_tail")):
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


def recon_ops(sets, q, npts, fold):
    """Field operations of one reconstruction round (csrc/comb.cu lin_body
    with EQ): the lin comb's, with the eq row's e_t times the scale as the
    weight (its step, two multiplies by the scale, one add a point; its
    own fold) where the comb reads Tc."""
    eq = [(1, SUB3), (2, MUL3), (npts, ADD3)]
    if fold:
        eq += [(2, SUB3), (2, MUL3), (2, ADD3)]
    return tally((1, lin_ops(sets, q, npts, fold)), (8 * q, tally(*eq)))


def recon_tail_ops(sets, rows, width, npts):
    """Field operations of one reconstruction tail over a (rows, 24,
    width) table (csrc/recon.cu): the Mz rows' fold into column 0, the eq
    row of log2(width) betas, each round's sums (recon_ops, unfolded), the
    fold of the table at each challenge and the final fold, its eq row
    scaled."""
    nr = width.bit_length() - 1
    fold = tally((1, SUB3), (1, MUL3), (1, ADD3))
    terms = [(8 * (rows - 1), fold), (width * (nr - 1), MUL3), (nr, SUB3),
             (8, MUL3)]
    w = width
    while w >= 2:
        terms += [(1, recon_ops(sets, w // 2, npts, False)),
                  (8 * rows * (w // 2), fold)]
        w //= 2
    return tally(*terms)


def head_alpha_ops(m, half):
    """Field operations that the alpha-sums need, unreduced as they are
    linear: per term (slot, column, alpha) the schoolbook's 9 products
    into 3 sums (w a1, w a2 formed once an alpha), or Karatsuba's 6 with
    3 adds of tail values; per output (slot, column, half) the sums'
    reductions, and Karatsuba's recombination."""
    terms, outs = 8 * m * 2 * half, 8 * m * 2
    school = tally((terms, {"mac192": 9}), (outs, {"reduce192": 3}))
    karatsuba = tally((terms, {"mac192": 6, "add": 3}),
                      (outs, {"reduce192": 6, "mul_w": 2, "sub": 6,
                              "add": 3}))
    return school, karatsuba


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


def tables_checks(torch, np, gl, prover, dev, rate, mix):
    """eq_table and head_alpha (zkvm/tables.py, csrc/tables.cu) against
    their twins on the card, bit for bit: eq_table in both layouts at
    small and truncated sizes and at the production 2^s rows, each with
    random points and with every coordinate p - 1; head_alpha at the
    production tail (2 K TAU, 24, m) with rows of p - 1.  Each kernel
    timed by a CUDA graph of its launches beside its bound, the twins by
    CUDA events.  Returns the two records (eq_table's in the t-layout,
    which 7 of a fold's 10 tables take)."""
    from latticeum_tpu_torch.host.nifs.structs import TAU
    from latticeum_tpu_torch.zkvm import tables
    ccs, K = prover.ccs, prover.params.K
    rng = np.random.default_rng(17)
    worst = {"eq_table": 0, "head_alpha": 0}

    def point(nv, edge):
        return [(gl.P - 1,) * 3 if edge else tuple(
            int(v) for v in rng.integers(0, gl.P, 3, dtype=np.uint64))
            for _ in range(nv)]

    cases = ((0, None), (1, None), (5, 5), (9, None), (12, 3000),
             (ccs.s, 1 << 14), (ccs.s, None))
    for nv, max_rows in cases:
        for edge in (False, True):
            pt = point(nv, edge)
            for t_layout in (False, True):
                e = u64_err(gl, np, tables.eq_table(pt, max_rows, dev,
                                                    t_layout),
                            tables.eq_table_twin(pt, max_rows, dev,
                                                 t_layout))
                worst["eq_table"] = max(worst["eq_table"], e)
                if e:
                    fail(f"eq_table nv={nv} max_rows={max_rows} "
                         f"edge={edge} t_layout={t_layout}: "
                         f"max_abs_err={e} against its twin")
    log(f"eq_table: {2 * 2 * len(cases)} tables (nv, max_rows in {cases}; "
        "random and all p - 1; both layouts) bit-exact with the twin")

    records = []
    pt = point(ccs.s, False)
    for t_layout in (False, True):
        f_host, n_dbl = tables.eq_factors(pt, None, t_layout)
        f = f_host.to(dev)
        out = torch.empty(tables.eq_out_shape(n_dbl, t_layout),
                          dtype=gl.DTYPE, device=dev)
        rows = 1 << n_dbl
        ms = graph_ms(torch, lambda: tables.eq_table_launch(
            f, n_dbl, t_layout, out), 50)
        wrapper = cuda_ms(torch, lambda: tables.eq_table(
            pt, None, dev, t_layout, out), 5)
        plain = cuda_ms(torch, lambda: tables.eq_table_twin(
            pt, None, dev, t_layout), 2)
        fill = graph_ms(torch, lambda: out.fill_(1), 50)
        nbytes = 8 * (out.numel() + f.numel())
        work = pipes({"fq3_mul": 2 * (rows - 1)}, mix)
        layout = "t-layout" if t_layout else "standard"
        log(f"eq_table {layout} {tuple(out.shape)}: {ms:.5f} ms (CUDA graph "
            f"of 50); the wrapper with its factor upload {wrapper:.4f} ms "
            f"(CUDA events over 5); twin {plain:.3f} ms; the same bytes "
            f"written by out.fill_ {fill:.5f} ms (CUDA graph of 50)")
        rec = record("eq_table", TABLES_SOURCE, worst["eq_table"], ms,
                     plain, rate, nbytes, work)
        del f, out
    records.append(rec)

    m, half = ccs.m, K * TAU
    gen = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape):                    # canonical, from two 32-bit halves
        lo, hi = (torch.randint(0, 1 << 32, shape, generator=gen,
                                dtype=gl.DTYPE, device=dev) for _ in "lh")
        return gl._canon(lo | (hi << 32))

    tail, alpha = rnd(2 * half, 24, m), rnd(2 * half, 3)
    tail[0] = gl.P_I64 - 1
    tail[-1, :, :64] = gl.P_I64 - 1
    alpha[0] = gl.P_I64 - 1
    alpha[-1] = gl.P_I64 - 1
    got = [torch.empty((24, m), dtype=gl.DTYPE, device=dev)
           for _ in range(2)]
    want = [torch.empty_like(got[0]) for _ in range(2)]
    tables.head_alpha(tail, alpha, *got)
    tables.head_alpha_twin(tail, alpha, *want)
    e = u64_err(gl, np, tuple(got), tuple(want))
    worst["head_alpha"] = e
    if e:
        fail(f"head_alpha {tuple(tail.shape)}: max_abs_err={e} against its "
             "twin")
    ms = graph_ms(torch, lambda: tables.head_alpha(tail, alpha, *got), 10)
    plain = cuda_ms(torch, lambda: tables.head_alpha_twin(tail, alpha,
                                                          *want), 1)
    nbytes = 8 * (tail.numel() + alpha.numel() + 2 * 24 * m)
    work = min((pipes(w, mix) for w in head_alpha_ops(m, half)),
               key=lambda w: bound(rate, nbytes, w)[0])
    log(f"head_alpha {tuple(tail.shape)} (rows of p - 1) bit-exact with the "
        f"twin; {ms:.4f} ms (CUDA graph of 10); twin {plain:.3f} ms")
    records.append(record("head_alpha", TABLES_SOURCE, worst["head_alpha"],
                          ms, plain, rate, nbytes, work))
    del tail, alpha, got, want
    torch.cuda.empty_cache()
    return records


def ring_checks(torch, np, gl, rq, dev, rate, mix):
    """crt and icrt (ring/rq.py, csrc/ring.cu) against their dense twins on
    the card, bit for bit, at the main path's shapes: dec's crt(ks) over
    (15, 98815) rings and build_witness's 19,763 and 98,815, each with a
    row of p - 1 and the edge values in every position.  Each timed by a
    CUDA graph of 20 beside its bound, each twin by CUDA events over one
    call.  Returns crt's record at (15, 98815)."""
    rng = np.random.default_rng(19)
    edges = np.array([0, 1, 0xFFFFFFFF, 1 << 32, gl.P - 1, 2], np.uint64)

    def rings(shape):
        u = rng.integers(0, gl.P, shape + (24,), dtype=np.uint64)
        flat = u.reshape(-1, 24)
        flat[0] = gl.P - 1
        flat[1:1 + len(edges)] = edges[:, None]
        flat[1 + len(edges)] = np.resize(edges, 24)
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    worst, rec = 0, None
    for shape in ((15, 98815), (19763,), (98815,)):
        x = rings(shape)
        n = x.numel() // 24
        for fn, twin in ((rq.crt, rq.crt_twin), (rq.icrt, rq.icrt_twin)):
            name = fn.__name__
            e = u64_err(gl, np, fn(x), twin(x))
            worst = max(worst, e)
            if e:
                fail(f"{name} {shape}: max_abs_err={e} against its twin")
            ms = graph_ms(torch, lambda: fn(x), 20)
            plain = cuda_ms(torch, lambda: twin(x), 1)
            nbytes = 8 * (2 * 24 * n + 27)
            work = pipes(CRT_OPS[name], mix)
            work = {c: n * v for c, v in work.items()}
            b_ms, _, limit = bound(rate, nbytes, work)
            log(f"{name} {shape + (24,)}: bit-exact with the twin; "
                f"{ms:.4f} ms (CUDA graph of 20), bound {b_ms:.4f} ms by "
                f"{limit}, {100 * b_ms / ms:.1f} % of it; twin "
                f"{plain:.3f} ms")
            if name == "crt" and shape == (15, 98815):
                rec = record("crt", RING_SOURCE, 0, ms, plain, rate, nbytes,
                             work)
        del x
    rec["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return [rec]


def ringmac_checks(torch, np, gl, rq, prover, dev, rate, mix):
    """The ring multiply-accumulate (ring/rq.py ring_mac, ring_mul_each;
    csrc/ringmac.cu) against its twins on the card, bit for bit, at the
    main path's shapes: the fold's f0 over 2K witnesses of nf rings, read
    from the two dec batches where they lie; dec's row-constant commits
    (kappa rows by K - 1 totals) and its y0 (K - 1 terms with cm as the
    base).  Rings of p - 1 and edge values.  Each timed by a CUDA graph of
    20 beside its bound, each twin by CUDA events over one call.  Returns
    the record at f0's shape."""
    p = prover.params
    K, kappa = p.K, p.KAPPA
    nf = prover.layout.w_size * p.L              # a witness's f rings
    rng = np.random.default_rng(23)
    edges = np.array([0, 1, 0xFFFFFFFF, 1 << 32, gl.P - 1, 2], np.uint64)

    def rings(*shape):
        u = rng.integers(0, gl.P, shape + (24,), dtype=np.uint64)
        flat = u.reshape(-1, 24)
        flat[0] = gl.P - 1
        flat[1:1 + len(edges)] = edges[:, None]
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    def cost(n, rows, reads, writes):
        work = pipes(tally((8 * rows * n, {"mac192": 9}),
                           (8 * rows, {"reduce192": 3}),
                           (8 * n, {"mul_w": 2})), mix)
        return 8 * 24 * (reads + writes), work

    worst, rec = 0, None
    parts = (rings(K, nf), rings(K, nf))
    rho = rings(2 * K)
    rows_u, tot, cm, bp = rings(kappa), rings(K - 1), rings(kappa), \
        rings(K - 1)
    cases = (
        ("f0", 2 * K, nf, lambda: rq.ring_mac(parts, rho),
         lambda: rq.ring_mac_twin(parts, rho),
         (2 * K * nf + 2 * K, nf)),
        ("dec commits", K - 1, kappa, lambda: rq.ring_mul_each(rows_u, tot),
         lambda: rq.ring_mul_each_twin(rows_u, tot),
         (kappa + K - 1, (K - 1) * kappa)))
    for label, n, rows, fn, twin, (reads, writes) in cases:
        e = u64_err(gl, np, fn(), twin())
        worst = max(worst, e)
        if e:
            fail(f"ring_mac {label}: max_abs_err={e} against its twin")
        ms = graph_ms(torch, fn, 20)
        plain = cuda_ms(torch, twin, 1)
        nbytes, work = cost(n, rows, reads, writes)
        b_ms, _, limit = bound(rate, nbytes, work)
        log(f"ring_mac {label} ({n} terms x {rows} rings): bit-exact with "
            f"the twin; {ms:.4f} ms (CUDA graph of 20), bound {b_ms:.4f} ms "
            f"by {limit}, {100 * b_ms / ms:.1f} % of it; twin {plain:.3f} ms")
        if label == "f0":
            rec = record("ring_mac", RINGMAC_SOURCE, 0, ms, plain, rate,
                         nbytes, work)
    cms = rq.ring_mul_each(rows_u, tot)
    e = u64_err(gl, np, rq.ring_mac((cms,), bp, base=cm),
                rq.ring_mac_twin((cms,), bp, base=cm))
    worst = max(worst, e)
    if e:
        fail(f"ring_mac y0: max_abs_err={e} against its twin")
    ms = graph_ms(torch, lambda: rq.ring_mac((cms,), bp, base=cm), 20)
    log(f"ring_mac y0 ({K - 1} terms x {kappa} rings, a base): bit-exact "
        f"with the twin; {ms:.4f} ms (CUDA graph of 20)")
    rec["max_abs_err"] = worst
    del parts
    torch.cuda.empty_cache()
    return [rec]


def recon_checks(torch, np, gl, comb, accel_rounds, prover, dev, rate, mix,
                 perm16_sass):
    """lin_recon_tail (zkvm/comb.py, csrc/recon.cu) against its twin on the
    card, bit for bit (messages, challenges, challenger state, final
    rows), at the main path's reconstruction tail: the zkVM's t Mz rows
    (t, 24, 2) folded at the last factored round's challenge into a
    2^(s - r) wide table, r the factored rounds, at degree + 1 points,
    with the CCS's +-1 signs, with random ring constants, and with the
    stale-beta replay's inputs (ROADMAP C.h9: another proof's betas, the
    scale _eqf_product of them over the factored rounds' challenges);
    rows of p - 1.  Each timed by a CUDA graph of 50 beside its
    throughput bound (recon_tail_ops at the probes' SASS, its
    permutations at the straight-line SASS of one) and its chain floor:
    perm16_chain at its permutations (a CUDA graph of 50, its own launch
    included) and perm16_chain(0), the launch floor.  Returns the record
    of the signs case."""
    from latticeum_tpu_torch.crypto import challenger
    ccs, sets = prover.ccs, prover.dn._lin_sets
    rng = np.random.default_rng(23)

    def rnd(*shape):
        return torch.from_numpy(gl.to_i64_bits(rng.integers(
            0, gl.P, shape, dtype=np.uint64))).to(dev)

    sets_ring = comb.lin_sets_general(
        sets.S, [[int(v) for v in rng.integers(0, gl.P, 24, dtype=np.uint64)]
                 for _ in sets.S], sets.rows, dev)
    nv = ccs.s
    r = accel_rounds._factored_rounds(prover.dn._cap_pow2, nv)
    width, npts, t_rows = 1 << (nv - r), ccs.d + 2, ccs.t
    perms = sum(challenger.permutations((3 if k else 5) + 24 * npts)
                for k in range(r, nv))
    log(f"lin reconstruction tail: {nv - r} rounds after {r} factored, "
        f"{t_rows} Mz rows into a table of {width} columns, {npts} points, "
        f"{perms} permutations")

    def inputs(stale):
        mz = rnd(t_rows, 24, 2)
        mz[0] = gl.P_I64 - 1
        betas = rnd(nv - r, 3)
        betas[-1] = gl.P_I64 - 1
        chals = rnd(nv, 3)
        scale = (torch.stack(accel_rounds._eqf_product(rnd(r, 3),
                                                       chals[:r]))
                 if stale else rnd(3))
        return [mz, betas, scale, rnd(16), rnd(5),
                torch.zeros((nv, npts, 24), dtype=gl.DTYPE, device=dev),
                chals]

    worst, rec = 0, None
    st = rnd(16)
    floor = graph_ms(torch, lambda: challenger.perm16_chain(st, perms), 50)
    launch_floor = graph_ms(torch, lambda: challenger.perm16_chain(st, 0),
                            50)
    for label, ls, stale in (("signs", sets, False),
                             ("ring constants", sets_ring, False),
                             ("signs, stale betas (C.h9)", sets, True)):
        x = inputs(stale)
        got = [t.clone() for t in x]
        want = [t.clone() for t in x]
        final = comb.lin_recon_tail(*got, ls, r)
        final_twin = comb.lin_recon_tail_twin(*want, ls, r)
        e = max(u64_err(gl, np, a, b) for a, b in
                zip([final] + got[3:], [final_twin] + want[3:]))
        worst = max(worst, e)
        if e:
            fail(f"lin_recon_tail {label}: max_abs_err={e}")
        ms = graph_ms(torch, lambda: comb.lin_recon_tail(*got, ls, r), 50)
        plain = cuda_ms(torch, lambda: comb.lin_recon_tail_twin(*want, ls,
                                                                r), 1)
        nbytes = 8 * (x[0].numel() + x[1].numel() + 3 + 2 * 16 + 5
                      + (nv - r) * (npts * 24 + 3) + 3
                      + (t_rows + 1) * 24 + 166
                      + (0 if ls.rings is None else ls.rings.numel())) \
            + 4 * (ls.off.numel() + ls.idx.numel() + len(ls.S))
        ops = pipes(recon_tail_ops(ls, t_rows + 1, width, npts), mix)
        work = {c: ops[c] + perms * perm16_sass[c] for c in CLASSES}
        b_ms, by, limit = bound(rate, nbytes, work)
        log(f"lin_recon_tail {label}: bit-exact; {ms:.4f} ms (CUDA graph "
            f"of 50); its chain floor, perm16_chain at {perms} "
            f"permutations, {floor:.4f} ms: {100 * floor / ms:.1f} % of it; "
            f"launch floor {launch_floor:.4f} ms; bound {b_ms:.6f} ms by "
            f"{limit} (the rounds {ops['total']:.4g} instructions, the "
            f"permutations {perms * perm16_sass['total']:.4g}), "
            f"{100 * b_ms / ms:.3f} % of it; twin {plain:.3f} ms")
        if rec is None:
            rec = record("lin_recon_tail", RECON_SOURCE, 0, ms, plain, rate,
                         nbytes, work)
    rec["max_abs_err"] = worst
    return [rec]


def coo_checks(torch, np, gl, prover, dev, rate, mix):
    """coo_matvec (zkvm/accel.py, csrc/coo.cu) against its twin on the
    card, bit for bit, in the prover's two plain segment maps at
    production size: M z into the lin stack's t-layout rows (36,536
    non-empty of t x 2^14 segments), M^T eq by column (t x n segments, up
    to 704 entries each); with the CCS's scalar values and with random
    ring values on the same entries; values p - 1 among the entries and
    rows of p - 1 among the inputs.  Each timed by a CUDA graph of 20
    beside its bound (bytes: the output written, the rows and CSR arrays
    read once; operations: the multiply-adds an unreduced sum needs), the
    twin by CUDA events over one call.  Returns the record of M^T eq
    (scalar), the map whose output is largest."""
    from latticeum_tpu_torch.zkvm import accel, tables
    e, ccs = prover.dn.e, prover.ccs
    rng = np.random.default_rng(29)

    def rnd(*shape):
        u = rng.integers(0, gl.P, shape, dtype=np.uint64)
        flat = u.reshape(-1)
        flat[:min(flat.size, 48)] = gl.P - 1
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    rows, cols, mats, vals, _ = accel._coo_host(ccs)
    ring_vals = rng.integers(0, gl.P, (vals.shape[0], 24), dtype=np.uint64)
    ring_vals[:24] = gl.P - 1
    vals = vals.copy()
    vals[:24] = gl.P - 1
    cap, n, t = e.cap_pow2, ccs.n, ccs.t
    brev_cap = tables.brev_host(cap).numpy()
    maps = {"mz_stack": (mats * cap + brev_cap[rows], cols, t * cap, cap,
                         True),
            "mt_eq_stack": (mats * n + cols, rows, t * n, n, False)}
    worst, rec = 0, None
    for name, (seg, gather, nseg, per, t_layout) in maps.items():
        x = rnd(cap if name == "mt_eq_stack" else n, 24)
        for kind, v in (("scalar", vals), ("ring", ring_vals)):
            csr = accel.build_csr(seg, gather, mats, v, nseg, per, dev)
            shape = accel.coo_out_shape(csr, t_layout)

            def fresh():
                return torch.empty(shape, dtype=gl.DTYPE, device=dev)
            got, want = fresh(), fresh()
            accel.coo_matvec(csr, x, got, t_layout)
            accel.coo_matvec_twin(csr, x, want, t_layout)
            err = u64_err(gl, np, got, want)
            worst = max(worst, err)
            sizes = csr.sizes
            log(f"coo_matvec {name} {kind}: {sizes.size} non-empty of "
                f"{nseg} segments, at most {int(sizes.max())} entries, "
                f"{csr.n_heavy()} heavy; "
                + ("bit-exact with the twin" if err == 0 else
                   f"max_abs_err={err}"))
            if err:
                fail(f"coo_matvec {name} {kind} disagrees with its twin")
            out = fresh()
            ms = graph_ms(torch, lambda: accel.coo_matvec(
                csr, x, out, t_layout), 20)
            plain = cuda_ms(torch, lambda: accel.coo_matvec_twin(
                csr, x, fresh(), t_layout), 1)
            nnz = gather.shape[0]
            in_rows = np.unique(gather).size
            ring = kind == "ring"
            nbytes = (8 * (out.numel() + 24 * in_rows + v.size)
                      + 4 * (nseg + 1 + nnz))
            per_entry = ({"mac192": 9, "mul_w": 2} if ring
                         else {"mac192": 3})
            ops = tally((8 * nnz, per_entry),
                        (8 * sizes.size, {"reduce192": 3}))
            b_ms, by, limit = bound(rate, nbytes, pipes(ops, mix))
            log(f"coo_matvec {name} {kind} {tuple(shape)}: {ms:.4f} ms "
                f"(CUDA graph of 20), bound {b_ms:.4f} ms by {limit}, "
                f"{100 * b_ms / ms:.1f} % of it; twin {plain:.3f} ms")
            if name == "mt_eq_stack" and kind == "scalar":
                rec = record("coo_matvec", COO_SOURCE, 0, ms, plain, rate,
                             nbytes, pipes(ops, mix))
            del csr, got, want, out
            torch.cuda.empty_cache()
    rec["max_abs_err"] = worst
    return [rec]


def coo_head_ops(nnz, pairs, n_nz, nwit, rows, t, ring):
    """Field operations that the fold head's challenged-z sums need over
    `rows` c rows of nwit witnesses.  y = sum_i zeta_i z_i of an entry
    depends on it only through its (matrix, column) pair: once for each of
    the `pairs` distinct pairs, row and slot, unreduced and reduced.  Per
    entry and slot, y's product with the value into the segment's sum (3
    mac192 a scalar; 9 and w v1, w v2 a ring); per output (non-empty
    segment and slot) its reduction and the add into the row.  y the
    least of two ways, as head_alpha_ops: the schoolbook's 9 products a
    witness (w zeta1, w zeta2 formed once a witness and matrix), or
    Karatsuba's 6 with 3 adds of z pairs (the zeta pairs once a witness
    and matrix), 6 reductions and the recombination.  Also the entry-wise
    formula: the schoolbook's y for every entry and slot, with w zeta1, w
    zeta2 formed for each.  Returns (formula, schoolbook, karatsuba)."""
    items, ys = 8 * nnz * rows, 8 * pairs * rows
    value = (items, {"mac192": 9, "mul_w": 2} if ring else {"mac192": 3})
    outs = (8 * n_nz * rows, {"reduce192": 3, "add": 3})
    tabled = rows * nwit * t
    formula = tally((items, {"mac192": 9 * nwit, "mul_w": 2 * nwit,
                             "reduce192": 3}), value, outs)
    school = tally((ys, {"mac192": 9 * nwit, "reduce192": 3}), value,
                   outs, (tabled, {"mul_w": 2}))
    karatsuba = tally((ys, {"mac192": 6 * nwit, "add": 3 * nwit + 3,
                            "reduce192": 6, "mul_w": 2, "sub": 6}),
                      value, outs, (tabled, {"add": 3}))
    return formula, school, karatsuba


def coo_head_checks(torch, np, gl, prover, dev, rate, mix):
    """coo_head (zkvm/accel.py, csrc/coo.cu coo_head_kernel) against its
    twin (coo_matvec_twin's head mode once a c row) on the card, bit for
    bit: the fold head's challenged z over 2K witnesses added into both c
    rows, rows 1 and 3 of a (5, 24, m) head whose other rows stay as they
    are, in the prover's head map at production size (10,361 non-empty of
    2^17 segments), with the CCS's scalar values and with random ring
    values, p - 1 among values, witnesses, zeta and output rows; ragged
    CSRs (coo_head_ragged); two launches in flight on two streams.  Each
    production kind timed by a CUDA graph of 20 beside its bound (the
    least of coo_head_ops' two ways, each the larger of its operations and
    the bytes) and beside the entry-wise formula, the twin by CUDA events
    over one call.  Returns the record (scalar values)."""
    from latticeum_tpu_torch.zkvm import accel, tables
    ccs, K = prover.ccs, prover.params.K
    rng = np.random.default_rng(31)

    def rnd(*shape):
        u = rng.integers(0, gl.P, shape, dtype=np.uint64)
        flat = u.reshape(-1)
        flat[:min(flat.size, 48)] = gl.P - 1
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    rows, cols, mats, vals, _ = accel._coo_host(ccs)
    ring_vals = rng.integers(0, gl.P, (vals.shape[0], 24), dtype=np.uint64)
    ring_vals[:24] = gl.P - 1
    vals = vals.copy()
    vals[:24] = gl.P - 1
    n, m, t = ccs.n, ccs.m, ccs.t
    seg = tables.brev_host(m).numpy()[rows]
    zs, zeta, base = rnd(2 * K, n, 24), rnd(2 * K, t, 3), rnd(5, 24, m)
    base[1, 7] = base[3, 11] = gl.P_I64 - 1
    worst, rec, prod = 0, None, []
    for kind, v in (("scalar", vals), ("ring", ring_vals)):
        csr = accel.build_csr(seg, cols, mats, v, m, m, dev, head=True)
        got, want = base.clone(), base.clone()
        accel.coo_head(csr, zs, zeta, (got[1], got[3]))
        accel.coo_head_twin(csr, zs, zeta, (want[1], want[3]))
        err = u64_err(gl, np, got, want)
        worst = max(worst, err)
        log(f"coo_head {kind}: 2 rows x {K} witnesses, {csr.sizes.size} "
            f"non-empty of {m} segments, at most {int(csr.sizes.max())} "
            "entries; " + ("bit-exact with the twin, rows 0, 2, 4 unchanged"
                           if err == 0 else f"max_abs_err={err}"))
        if err:
            fail(f"coo_head {kind} disagrees with its twin")
        out = base.clone()
        ms = graph_ms(torch, lambda: accel.coo_head(
            csr, zs, zeta, (out[1], out[3])), 20)
        plain = cuda_ms(torch, lambda: accel.coo_head_twin(
            csr, zs, zeta, (out[1], out[3])), 1)
        nnz, n_nz = cols.shape[0], csr.sizes.size
        # the bytes for both rows: the non-empty rows read and
        # written, the gathered rows of 2K witnesses, values, zeta and the
        # CSR once
        nbytes = (8 * (2 * 2 * 24 * n_nz + 24 * np.unique(cols).size * 2 * K
                       + v.size + 2 * K * t * 3)
                  + 4 * (m + 1 + 2 * nnz))
        pairs = np.unique(mats.astype(np.int64) * n + cols).size
        formula, school, karatsuba = coo_head_ops(nnz, pairs, n_nz, K, 2, t,
                                                  kind == "ring")
        f_ms, _, f_limit = bound(rate, nbytes, pipes(formula, mix))
        ways = [(bound(rate, nbytes, pipes(w, mix)), w, name)
                for w, name in ((school, "schoolbook"),
                                (karatsuba, "Karatsuba"))]
        (b_ms, _, limit), work, way = min(ways, key=lambda w: w[0][0])
        log(f"coo_head {kind} (2, 24, {m}): {ms:.4f} ms (CUDA graph of "
            f"20), {ms / 2:.4f} ms a row's work; bound {b_ms:.4f} ms by "
            f"{limit} ({way}, y once for each of {pairs} (matrix, column) "
            f"pairs of {nnz} entries; the other way "
            f"{max(w[0][0] for w in ways):.4f} ms), {100 * b_ms / ms:.1f} % "
            f"of it; the entry-wise formula {f_ms:.4f} ms by {f_limit}, "
            f"{100 * f_ms / ms:.1f} % of it; twin {plain:.3f} ms")
        if kind == "scalar":
            rec = record("coo_head", COO_SOURCE, 0, ms, plain, rate, nbytes,
                         pipes(work, mix))
        prod.append((csr, zs, zeta, base))
        del got, want, out
        torch.cuda.empty_cache()
    worst = max(worst, coo_head_ragged(torch, np, gl, accel, dev, rng))
    worst = max(worst, coo_head_two_streams(torch, np, gl, accel, prod))
    rec["max_abs_err"] = worst
    return [rec]


def coo_head_ragged(torch, np, gl, accel, dev, rng):
    """coo_head against its twin on ragged CSRs of one block of segments:
    a 705-entry segment over many runs and blocks, a run of segments of 1
    ... 20 entries, most segments empty, with 15, 3 and 1 witnesses a row;
    three non-empty segments (fewer than the blocks); every value,
    witness and zeta p - 1.  Returns the largest error (0)."""
    p1 = gl.P_I64 - 1
    cases = [("705-entry segment, 15 witnesses", 1024, 705, 15, False),
             ("705-entry segment, rings, 1 witness", 1024, 705, 1, True),
             ("3 witnesses", 4096, 90, 3, False),
             ("three segments", 64, 0, 15, True),
             ("all p - 1", 512, 200, 15, False)]
    worst = 0
    for name, nseg, heavy, k, ring in cases:
        t, rows_in = 7, 300
        if heavy:
            seg = np.concatenate([rng.integers(0, nseg, nseg // 4),
                                  np.full(heavy, nseg // 2),
                                  np.repeat(np.arange(5, 25),
                                            np.arange(1, 21))])
        else:
            seg = np.array([0, nseg // 3, nseg // 3, nseg - 1])
        nnz = seg.shape[0]
        gather = rng.integers(0, rows_in, nnz)
        mats = rng.integers(0, t, nnz)
        shape = (nnz, 24) if ring else (nnz,)
        v = rng.integers(0, gl.P, shape, dtype=np.uint64)
        zs = torch.from_numpy(gl.to_i64_bits(rng.integers(
            0, gl.P, (2 * k, rows_in, 24), dtype=np.uint64))).to(dev)
        zeta = torch.from_numpy(gl.to_i64_bits(rng.integers(
            0, gl.P, (2 * k, t, 3), dtype=np.uint64))).to(dev)
        if name == "all p - 1":
            v[:] = gl.P - 1
            zs.fill_(p1)
            zeta.fill_(p1)
        csr = accel.build_csr(seg, gather, mats, v, nseg, nseg, dev,
                              head=True)
        base = torch.from_numpy(gl.to_i64_bits(rng.integers(
            0, gl.P, (2, 24, nseg), dtype=np.uint64))).to(dev)
        got, want = base.clone(), base.clone()
        accel.coo_head(csr, zs, zeta, list(got))
        accel.coo_head_twin(csr, zs, zeta, list(want))
        err = u64_err(gl, np, got, want)
        worst = max(worst, err)
        if err:
            fail(f"coo_head, {name}: max_abs_err={err}")
    log(f"coo_head: {len(cases)} ragged and edge CSRs bit-exact with the "
        "twin")
    return worst


def coo_head_two_streams(torch, np, gl, accel, prod):
    """Two coo_head launches in flight at once on two streams (the
    production map with scalar and with ring values), eight times over,
    each bit-equal to its twin: no state is shared between launches.
    Both wait for a gate on a third stream; the second spins some 30 us
    more and has the higher priority, so its blocks are handed out while
    the first launch runs.  The roles swap every time.  Returns the
    largest error (0)."""
    cases = []
    for csr, zs, zeta, base in prod:
        want = base.clone()
        accel.coo_head_twin(csr, zs, zeta, (want[1], want[3]))
        cases.append(((csr, zs, zeta, base), want))
    streams = (torch.cuda.Stream(priority=0),
               torch.cuda.Stream(priority=-1))
    gate = torch.cuda.Stream()
    torch.cuda.synchronize()
    for rep in range(8):
        order = cases if rep % 2 == 0 else cases[::-1]
        outs = [args[3].clone() for args, _ in order]
        torch.cuda.synchronize()
        with torch.cuda.stream(gate):
            torch.cuda._sleep(2_000_000)
        opened = torch.cuda.Event()
        opened.record(gate)
        for k, (stream, ((csr, zs, zeta, _), _), out) in enumerate(
                zip(streams, order, outs)):
            with torch.cuda.stream(stream):
                stream.wait_event(opened)
                if k:
                    torch.cuda._sleep(60_000)
                accel.coo_head(csr, zs, zeta, (out[1], out[3]))
        torch.cuda.synchronize()
        for (_, want), got in zip(order, outs):
            err = u64_err(gl, np, got, want)
            if err:
                fail(f"coo_head on two streams, repeat {rep}: "
                     f"max_abs_err={err}")
    log("coo_head: two launches in flight on two streams of low and high "
        "priority, 8 times, each bit-exact with its twin")
    return 0


def fold_c_checks(torch, np, gl, comb, prover, dev, rate, mix):
    """fold_c_round (zkvm/comb.py, csrc/comb.cu) against its twin on the
    card, bit for bit: round 0 at m = 2^s on a fold head's interleaved,
    row-strided rows; a folded round at each width down to 2; the pair
    sums alone at the lin stack's widths (2^14 down to 2) and over the
    three eq rows; the end (the c and 2 K TAU tail rows folded, the eq
    rows weighted).  Rows of p - 1.  Each timed by a CUDA graph of 20
    beside its bound.  Returns round 0's record."""
    from latticeum_tpu_torch.host.nifs.structs import TAU
    ccs, K = prover.ccs, prover.params.K
    m = ccs.m
    rng = np.random.default_rng(31)

    def rnd(*shape):
        u = rng.integers(0, gl.P, shape, dtype=np.uint64)
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    worst, rec = 0, None
    sums = torch.empty((4, 24), dtype=gl.DTYPE, device=dev)
    w = m
    while w >= 2:
        fold = w < m
        head = rnd(5, 24, w)
        head[1] = gl.P_I64 - 1
        head[0, :, :w // 2] = gl.P_I64 - 1
        c2r = rnd(2, 24, 2 * w) if fold else head[1:4:2]
        r3 = rnd(3) if fold else None
        eqs = head[0::2]
        got = comb.fold_c_round(c2r, eqs, r3, sums) + (sums.clone(),)
        want = comb.fold_c_round_twin(c2r, eqs, r3)
        err = u64_err(gl, np, got, want)
        worst = max(worst, err)
        if err:
            fail(f"fold_c_round width {w} fold={fold}: max_abs_err={err}")
        if w in (m, m // 2, 1 << 10, 2):
            ms = graph_ms(torch, lambda: comb.fold_c_round(c2r, eqs, r3,
                                                           sums), 20)
            plain = cuda_ms(torch, lambda: comb.fold_c_round_twin(
                c2r, eqs, r3), 1)
            h = w // 2
            nbytes = 8 * (3 * 24 * w + 2 * 24 * (2 * w if fold else w)
                          + 3 * 24 * h + 4 * 24 + (2 * 24 * w + 3
                                                   if fold else 0))
            per_col = tally((3, ADD3), (4, {"mac192": 9, "mul_w": 2}))
            if fold:
                per_col = tally((1, per_col), (4, SUB3), (4, MUL3),
                                (4, ADD3))
            ops = tally((8 * h, per_col), (96, {"reduce192": 1}))
            b_ms, by, limit = bound(rate, nbytes, pipes(ops, mix))
            log(f"fold_c_round width {w}{' folded' if fold else ''}: "
                f"bit-exact; {ms:.4f} ms (CUDA graph of 20), bound "
                f"{b_ms:.4f} ms by {limit}, {100 * b_ms / ms:.1f} % of it; "
                f"twin {plain:.3f} ms")
            if w == m:
                rec = record("fold_c_round", COMB_SOURCE, 0, ms, plain, rate,
                             nbytes, pipes(ops, mix))
        w //= 2
    log(f"fold_c_round: every round width {m} ... 2 bit-exact with the twin")
    worst = max(worst, fold_c_two_streams(torch, np, gl, comb, m, rnd))
    for shape in ((24, 1 << 14), (24, 2), (3, 24, 1 << 17)):
        x = rnd(*shape)
        x[..., 0] = gl.P_I64 - 1
        err = u64_err(gl, np, comb.pair_sum(x), comb.pair_sum_twin(x))
        worst = max(worst, err)
        if err:
            fail(f"pair_sum {shape}: max_abs_err={err}")
        ms = graph_ms(torch, lambda: comb.pair_sum(x), 20)
        b_ms = bound(rate, 8 * x.numel() * 3 // 2, pipes(
            {"add": x.numel() // 2}, mix))[0]
        log(f"pair_sum {shape}: bit-exact; {ms:.4f} ms (CUDA graph of 20), "
            f"bound {b_ms:.5f} ms")
    n_t = 2 * K * TAU
    c2r, eqs = rnd(2, 24, 2), rnd(5, 24, 1)[0::2]
    t_s, r3, E = rnd(n_t, 24, 2), rnd(3), rnd(3, 3)
    t_s[0] = gl.P_I64 - 1
    err = u64_err(gl, np, comb.fold_c_end(c2r, eqs, t_s, r3, E),
                  comb.fold_c_end_twin(c2r, eqs, t_s, r3, E))
    worst = max(worst, err)
    if err:
        fail(f"fold_c_end: max_abs_err={err}")
    ms = graph_ms(torch, lambda: comb.fold_c_end(c2r, eqs, t_s, r3, E), 20)
    log(f"fold_c_end ({5 + n_t}, 24, 1): bit-exact; {ms:.4f} ms (CUDA "
        "graph of 20)")
    rec["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return [rec]


def fold_c_two_streams(torch, np, gl, comb, m, rnd):
    """Two fold_c_round launches in flight at once on two streams (round 0
    at m on the head's strided rows, a folded round at m / 2), eight times
    over, each bit-equal to its twin: no state is shared between launches
    (ROADMAP C.h10).  Both streams wait for a gate (a 1 ms spin on a
    third stream, so that the host has queued both launches when it
    opens); the second stream spins some 30 us more and has the higher
    priority, so its blocks are handed out while the first launch runs,
    before the rest of the first launch's.  The roles swap every time.
    Returns the largest error (0)."""
    cases = []
    for w, fold in ((m, False), (m // 2, True)):
        head = rnd(5, 24, w)
        c2r = rnd(2, 24, 2 * w) if fold else head[1:4:2]
        args = (c2r, head[0::2], rnd(3) if fold else None)
        cases.append((args, comb.fold_c_round_twin(*args)))
    streams = (torch.cuda.Stream(priority=0),
               torch.cuda.Stream(priority=-1))
    gate = torch.cuda.Stream()
    torch.cuda.synchronize()
    for rep in range(8):
        order = cases if rep % 2 == 0 else cases[::-1]
        with torch.cuda.stream(gate):
            torch.cuda._sleep(2_000_000)
        opened = torch.cuda.Event()
        opened.record(gate)
        outs = []
        for k, (stream, (args, _)) in enumerate(zip(streams, order)):
            with torch.cuda.stream(stream):
                stream.wait_event(opened)
                if k:
                    torch.cuda._sleep(60_000)
                sums = torch.empty((4, 24), dtype=gl.DTYPE, device="cuda")
                outs.append(comb.fold_c_round(*args, sums) + (sums,))
        torch.cuda.synchronize()
        for (args, want), got in zip(order, outs):
            err = u64_err(gl, np, got, want)
            if err:
                fail(f"fold_c_round on two streams, width "
                     f"{args[1].shape[-1]}, repeat {rep}: max_abs_err={err}")
    log("fold_c_round: two launches in flight on two streams of low and "
        "high priority, 8 times, each bit-exact with its twin")
    return 0


def decompose_checks(torch, np, gl, prover, dev, rate, mix):
    """The witness pipelines' digit kernels (csrc/decompose.cu) against
    their twins on the card, bit for bit, at the main path's shapes:
    balanced_digits as commit_z's gadget digits (nw rings, b = B, L) and
    as dec's k vectors (nf rings, b = B_SMALL, K); digit_recompose as
    dec's gadget recomposition (K x nf rings) and the fold's
    witness_from_f (nf); row_sums as dec's commit sums (K - 1 witnesses of
    nf rings) and commit's (one).  The first words of every input are
    edge values: 0, 1, p - 1, (p -/+ 1) / 2, low digits of b/2 and b/2 + 1
    on both signs, and values beyond b^count / 2 (their rest dropped).
    Each timed by a CUDA graph of 20 beside its bound, each twin by CUDA
    events over one call.  Returns the records at dec's shapes."""
    from latticeum_tpu_torch.ring import decompose as dc
    from latticeum_tpu_torch.zkvm import accel_nifs
    p = prover.params
    nw = prover.layout.w_size
    nf = nw * p.L
    rng = np.random.default_rng(29)

    def rings(b, count, *shape):
        u = rng.integers(0, gl.P, shape + (24,), dtype=np.uint64)
        half, top = b // 2, b ** count // 2
        edges = [0, 1, gl.P - 1, (gl.P - 1) // 2, (gl.P + 1) // 2, half,
                 half + 1, b + half, b + half + 1, gl.P - half,
                 gl.P - half - 1, gl.P - b - half - 1]
        edges += [v for x in (top - 1, top, top + 1) if x < gl.P
                  for v in (x, gl.P - x)]
        flat = u.reshape(-1)
        flat[:len(edges)] = np.array(edges, np.uint64)
        u.reshape(-1, 24)[1] = gl.P - 1
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    def digit_work(n, count):
        ops = n * count * BALANCED_DIGIT_OPS
        return {"fma": 0, "alu": ops, "total": ops}

    w = rings(p.B, p.L, nw)
    fc = rings(p.B_SMALL, p.K, nf)
    fb = rings(p.B, p.L, p.K, nf)
    sum_ops = (p.K - 1) * nf * 24 * ROW_SUM_OPS
    horner = pipes({"mul": p.L - 1, "add": p.L - 1}, mix)
    cases = (
        ("balanced_digits", "commit_z's gadget digits", (nw, 24),
         lambda: dc.gadget_decompose(w, p.B, p.L),
         lambda: torch.movedim(dc.decompose_balanced_twin(w, p.B, p.L), -1,
                               -2).reshape(nf, 24),
         8 * 24 * nw * (1 + p.L), digit_work(24 * nw, p.L)),
        ("balanced_digits", "dec's k vectors", (nf, 24),
         lambda: dc.decompose_vec_into_k_vecs(fc, p.B_SMALL, p.K),
         lambda: torch.movedim(dc.decompose_balanced_twin(
             fc, p.B_SMALL, p.K), -1, 0),
         8 * 24 * nf * (1 + p.K), digit_work(24 * nf, p.K)),
        ("digit_recompose", "dec's gadget recomposition", (p.K, nf, 24),
         lambda: dc.gadget_recompose(fb, p.B, p.L),
         lambda: dc.recompose_twin(fb.reshape(p.K, nw, p.L, 24), p.B, -2),
         8 * 24 * p.K * (nf + nw),
         {c: p.K * nw * 24 * v for c, v in horner.items()}),
        ("digit_recompose", "the fold's witness_from_f", (nf, 24),
         lambda: dc.gadget_recompose(fb[0], p.B, p.L),
         lambda: dc.recompose_twin(fb[0].reshape(nw, p.L, 24), p.B, -2),
         8 * 24 * (nf + nw), {c: nw * 24 * v for c, v in horner.items()}),
        ("row_sums", "dec's commit sums", (p.K - 1, nf, 24),
         lambda: accel_nifs.row_sums(fb[1:]),
         lambda: gl.sum_axis(fb[1:], -2),
         8 * 24 * ((p.K - 1) * nf + p.K - 1),
         {"fma": 0, "alu": sum_ops, "total": sum_ops}),
        ("row_sums", "commit's sums", (1, nf, 24),
         lambda: accel_nifs.row_sums(fb[:1]),
         lambda: gl.sum_axis(fb[:1], -2),
         8 * 24 * (nf + 1),
         {"fma": 0, "alu": nf * 24 * ROW_SUM_OPS,
          "total": nf * 24 * ROW_SUM_OPS}))
    worst, recs = {}, {}
    for name, label, shape, fn, twin, nbytes, work in cases:
        e = u64_err(gl, np, fn(), twin())
        worst[name] = max(worst.get(name, 0), e)
        if e:
            fail(f"{name} {label} {shape}: max_abs_err={e} against its twin")
        ms = graph_ms(torch, fn, 20)
        plain = cuda_ms(torch, twin, 1)
        b_ms, _, limit = bound(rate, nbytes, work)
        log(f"{name} {label} {shape}: bit-exact with the twin; {ms:.4f} ms "
            f"(CUDA graph of 20), bound {b_ms:.4f} ms by {limit} ({nbytes} "
            f"bytes), {100 * b_ms / ms:.1f} % of it; twin {plain:.3f} ms")
        if name not in recs and label.startswith("dec"):
            recs[name] = record(name, DECOMPOSE_SOURCE, 0, ms, plain, rate,
                                nbytes, work)
        torch.cuda.empty_cache()
    for name, rec in recs.items():
        rec["max_abs_err"] = worst[name]
    del w, fc, fb
    torch.cuda.empty_cache()
    return list(recs.values())


# The witness pipeline's calls of TorchNifs counted on the main path, and
# the digit twins that must not run there.
WITNESS_CALLS = ("build_witness", "dec_prove", "witness_from_f",
                 "witness_from_f_coeff", "commit")
DIGIT_TWINS = ("decompose_balanced_twin", "recompose_twin")


@contextlib.contextmanager
def counted_calls(owner, names):
    """Count the calls of owner.<name> for each name while inside."""
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(owner, n) for n in names}
    own = {n for n in names if n in vars(owner)}   # else a class's method

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    for n, fn in saved.items():
        setattr(owner, n, counting(n, fn))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            if n in own:
                setattr(owner, n, fn)
            else:
                delattr(owner, n)


def check_digit_launches(launches, calls, twins):
    """The digit kernels once a pipeline call on the main path, and their
    twins never."""
    want = {"balanced_digits": calls["build_witness"] + calls["dec_prove"],
            "digit_recompose": calls["dec_prove"] + calls["witness_from_f"]
            + calls["witness_from_f_coeff"],
            "row_sums": calls["commit"] + calls["dec_prove"]}
    log(f"witness pipeline calls on the main path: {calls}")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times, not {n} "
                 f"(witness pipeline calls {calls})")
    if any(twins.values()):
        fail(f"a digit twin ran on the main path: {twins}")


def sumcheck_launches(prover):
    """The device launches (kernels and copies, as torch.profiler traces
    them) of one fold sum-check at the main path's shape (m = 2^s, 2 K TAU
    tail rows) and one lin sum-check (the zkVM's multisets at the lin
    stack's truncated width), traced in a fresh process (``python3
    chip_smoke.py --trace-sumchecks s K width``, ``trace_sumchecks``): in
    this one, after the earlier phases, the traces held 11 to 23 fewer
    device events than the kernel wrappers counted launches, every time.
    Fails unless the trace holds at least those kernels and the fold
    sum-check makes fewer than FOLD_SUMCHECK_LAUNCHES.  Returns {"fold":
    n, "lin": n}."""
    cmd = [sys.executable, os.path.abspath(__file__), "--trace-sumchecks",
           str(prover.ccs.s), str(prover.params.K), str(prover.dn._cap_pow2)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    if res.returncode != 0:
        fail(f"the sum-check trace failed ({res.returncode}): "
             f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    traced = json.loads(res.stdout.strip().splitlines()[-1])
    out = {}
    for kind, t in traced.items():
        out[kind] = sum(t["names"].values())
        log(f"a {kind} sum-check: {out[kind]} device launches (kernels and "
            f"copies; {t['kernels']} kernels by the wrappers' counts): "
            f"{t['names']}")
        if out[kind] < t["kernels"]:
            fail(f"the {kind} sum-check's trace holds {out[kind]} device "
                 f"events for {t['kernels']} kernel launches")
    if not out["fold"] < FOLD_SUMCHECK_LAUNCHES:
        fail(f"a fold sum-check made {out['fold']} launches, not fewer than "
             f"{FOLD_SUMCHECK_LAUNCHES}")
    return out


def trace_sumchecks(nv, K, width):
    """One fold sum-check (m = 2^nv, K) and one lin sum-check (the zkVM's
    multisets, `width` columns) on the card under torch.profiler, each
    run by the main path's runner on inputs made from seeds after a
    warm-up run.  Prints {kind: {"names": device events by name,
    "kernels": the kernel launches the wrappers counted}}."""
    import torch
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from latticeum_tpu_torch.crypto import challenger
    from latticeum_tpu_torch.parallel import fold_mesh, lin_mesh
    from latticeum_tpu_torch.zkvm import comb, tables
    dev = torch.device("cuda")
    fold_in = fold_mesh.fold_inputs(nv, K, device=dev)
    lin_in = lin_mesh.lin_inputs(nv, width, device=dev)
    runs = {"fold": lambda: fold_mesh.run_fold_sumcheck(fold_in),
            "lin": lambda: lin_mesh.run_lin_sumcheck(lin_in)}

    def kernels():          # device kernels the wrappers launched so far
        return (2 * sum(w.launches for w in comb.WRAPPERS)
                + comb.lin_recon_tail.launches + comb.fold_c_round.launches
                + challenger.round_tail.launches + tables.eq_table.launches)
    out = {}
    for kind, run in runs.items():
        run()
        torch.cuda.synchronize()
        for _attempt in range(3):     # a trace short of events is retaken
            before = kernels()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            names = Counter(e.name.split("(")[0] for e in prof.events()
                            if e.device_type == DeviceType.CUDA)
            out[kind] = {"names": dict(names.most_common()),
                         "kernels": kernels() - before}
            if sum(names.values()) >= out[kind]["kernels"]:
                break
    print(json.dumps(out), flush=True)
    return 0


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
    if sys.argv[1:2] == ["--trace-sumchecks"]:
        sys.exit(trace_sumchecks(*map(int, sys.argv[2:5])))
    sys.exit(main())
