"""The comparison that decides `correct`: what the timed path produced,
against the frozen plain reference under `zkbench/ref/` (numpy and Python
ints; it imports nothing of the program).

The IVC steps form one chain, and the reference's prover takes more than
half an hour a step on a host, so the reference follows the program's
chain: for each checked step i it takes the program's state after step
i - 1 and judges everything step i produced from it.

- *state commitments*: the initial state's, and after steps i - 1 and i
  the state's (the reference VM's own run of the guest, its own page
  tree and memory-op chain), the accumulator's and the IVC step's;
- *commit*: the reference arithmetizes step i from its own trace, and the
  program's committed witness, public input and Ajtai commitment must
  equal its own;
- *fold*: the reference NIFS verifier, with its own Poseidon2 transcript,
  runs over the program's proof, and the accumulator it derives must equal
  the program's folded one;
- *witness*: the program's folded witness must open the folded
  accumulator: the commitment, the f_hat evaluations v, the evaluation
  claims u = <M_j^T eq(r), z> of every CCS matrix, and the norm bound B;
  so must the chain's start, the initial accumulator, its zero witness;
- *collector*: the verifier vars must equal the reference collector's,
  replayed from the reference verifier's own challenges;
- *checkpoint*: the file the program last wrote in the window, read back,
  must hold the reference's state of its step.

The reference's Ajtai matrix is the configuration's scheme kind (SCHEMES)
drawn from the run's seed as the program draws it; under the dense kind
its commitments take an exact float64 product in place of the slot-wise
matvec (`ref/commit/ajtai.py`, `commit_dense`), which stays the definition.

Every reading is a count of mismatches, an exact comparison: its limit
is 0.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .ref.commit.ajtai import AjtaiScheme
from .ref.crypto.transcript import ReplayTranscript, Transcript
from .ref.field import goldilocks as gl
from .ref.field import host as H
from .ref.nifs import nifs as ref_nifs
from .ref.nifs.linearization import evaluate_mles_host
from .ref.nifs.structs import CCCS, LCCCS, Witness, _segment_sum_mod_p
from .ref.poly import mle
from .ref.ring import rq
from .ref.vm.vm import VM
from .ref.zkvm import commitments as rc
from .ref.zkvm.builder import create_riscv_ccs
from .ref.zkvm.collect import generate_verification_witness_vars
from .ref.zkvm.layout import CCSLayout
from .ref.zkvm.witness import IVCStepInput, arithmetize

P = H.P
NAMES = ("statecomm", "commit", "fold", "witness", "collector",
         "checkpoint")


def u64_limbs(a):
    """(..., 24) u64 array -> the reference's (lo, hi) uint32 limbs."""
    a = np.asarray(a, dtype=np.uint64)
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


def limbs_u64(x):
    return x[0].astype(np.uint64) | (x[1].astype(np.uint64) << np.uint64(32))


def rings_u64(rings):
    return np.array([[int(v) for v in r] for r in rings], dtype=np.uint64)


def lcccs(acc):
    return LCCCS(r=[list(x) for x in acc.r], v=[list(x) for x in acc.v],
                 cm=[list(x) for x in acc.cm], u=[list(x) for x in acc.u],
                 x_w=[list(x) for x in acc.x_w], h=list(acc.h))


def same_acc(a, b):
    return all([list(map(list, getattr(a, f))) == list(map(list,
                                                          getattr(b, f)))
                for f in ("r", "v", "cm", "u", "x_w")]) and \
        list(a.h) == list(b.h)


def plain(x):
    """Nested lists of ints, tuples as lists (a JSON round trip's form)."""
    return json.loads(json.dumps(x, default=int))


class PageTree:
    """The reference's page Merkle tree of a VM: leaf i the narrow sponge
    of page i's words, zero-digest padded, 2-to-1 compression levels.
    Equal pages and equal subtrees are hashed once (an exact memo)."""

    def __init__(self, vm):
        self.vm = vm
        self._leaf, self._pair = {}, {}
        self.levels = [[self.leaf(i) for i in range(vm.page_count)]]
        while len(self.levels[-1]) > 1:
            lv = self.levels[-1]
            self.levels.append([self.pair(lv[2 * i], lv[2 * i + 1])
                                for i in range(len(lv) // 2)])

    def leaf(self, i):
        key = bytes(self.vm.memory[i])
        if key not in self._leaf:
            self._leaf[key] = rc.hash_narrow(self.vm.page_words(i))
        return self._leaf[key]

    def pair(self, a, b):
        key = tuple(a) + tuple(b)
        if key not in self._pair:
            self._pair[key] = rc.p2.compress8(a, b)
        return self._pair[key]

    def update(self, i):
        self.levels[0][i] = self.leaf(i)
        for lvl in range(len(self.levels) - 1):
            j = i ^ 1
            lo, hi = min(i, j), max(i, j)
            i >>= 1
            self.levels[lvl + 1][i] = self.pair(self.levels[lvl][lo],
                                                self.levels[lvl][hi])

    @property
    def root(self):
        return list(self.levels[-1][0])


class Stop(Exception):
    pass


def replay(inputs, wanted, ckpt_step=None):
    """Run the guest on the reference VM to the largest step wanted.
    Returns ({step: (trace, state commitment after it, mem_ops)}, initial
    state commitment, the VM's state after `ckpt_step` or None)."""
    vm = VM(inputs["words_per_page"], inputs["page_count"])
    vm.load_elf_data(inputs["elf"])
    for addr, word in inputs["heap"]:
        vm.write_mem(addr, word)
    committer = rc.ZkVmCommitter()
    code = committer.vm_code_comm(vm.elf.raw_code.bytes)
    tree = PageTree(vm)
    ops = list(rc.ZERO_COMM)

    def state(pc, regs):
        return rc.hash_wide(list(code) + [pc] + tree.root
                            + list(rc.hash_wide(list(regs))) + list(ops))

    z0 = state(vm.pc, vm.regs)
    got, snap = {}, None
    last = max(wanted)

    def intercept(trace, vm_ref):
        nonlocal ops, snap
        step = trace.cycle + 1
        op = trace.side_effects.memory_op
        if op is not None:
            page, _ = vm_ref.physical_addr(op.address & ~0b11)
            tree.update(page)
            ops = committer.vm_mem_ops_vec_comm(ops, op)
        if step in wanted:
            got[step] = (trace, state(trace.output.pc, trace.output.regs),
                         list(ops))
        if step == ckpt_step:
            snap = {"pc": vm_ref.pc, "regs": list(vm_ref.regs),
                    "heap": [vm_ref.heap.start, vm_ref.heap.end,
                             vm_ref.heap.next],
                    "reserved": vm_ref.reserved_word_addr,
                    "memory": b"".join(bytes(p) for p in vm_ref.memory)}
        if step >= last:
            raise Stop

    try:
        vm.run(intercept)
    except Stop:
        pass
    return got, z0, snap


# a configuration's Ajtai scheme kind -> the reference's matrix from the seed
SCHEMES = {"row_constant": AjtaiScheme.from_seed,
           "general": AjtaiScheme.from_seed_general}


class Reference:
    """The frozen reference at one parameter set, Ajtai scheme kind (a key
    of SCHEMES) and Ajtai seed."""

    def __init__(self, params, scheme_seed, scheme):
        self.params = params
        self.layout = CCSLayout(params)
        self.ccs = create_riscv_ccs(self.layout)
        self.dp = ref_nifs.DecompositionParams(
            B=params.B, L=params.L, B_SMALL=params.B_SMALL, K=params.K)
        t = time.perf_counter()
        self.scheme = SCHEMES[scheme](
            params.KAPPA, self.layout.w_size * params.L, seed=scheme_seed)
        # seconds spent on the Ajtai matrix and the commitments under it
        self.ajtai_s = time.perf_counter() - t
        self.committer = rc.ZkVmCommitter()
        # the CCS's entries, all matrices, for the evaluation claims
        rows, cols, mats, lo, hi = [], [], [], [], []
        for j, M in enumerate(self.ccs.M):
            rows.append(np.asarray(M.rows))
            cols.append(np.asarray(M.cols))
            mats.append(np.full(M.rows.shape[0], j, np.int64))
            lo.append(np.asarray(M.vals[0]))
            hi.append(np.asarray(M.vals[1]))
        self.e_rows = np.concatenate(rows).astype(np.int64)
        self.e_cols = np.concatenate(cols).astype(np.int64)
        self.e_mats = np.concatenate(mats)
        self.e_vals = (np.concatenate(lo), np.concatenate(hi))

    # -- pieces ----------------------------------------------------------
    def acc_comm(self, acc):
        return self.committer.acc_comm(acc)

    def step_comm(self, i, z0, zi, acc_comm):
        digest, states = self.committer.ivc_step_comm(i, z0, zi, acc_comm)
        return plain([digest, states])

    def commit(self, w_ccs_limbs):
        wit = Witness.from_w_ccs(w_ccs_limbs, self.params.B, self.params.L)
        return self.ajtai_commit(wit)

    def ajtai_commit(self, wit):
        """The Ajtai commitment of a reference Witness, host ints."""
        t = time.perf_counter()
        cm = self.scheme.commit_coeff(wit.f_coeff, wit.f)
        self.ajtai_s += time.perf_counter() - t
        return cm

    def claims_u(self, point, z):
        """u_j = <M_j^T eq(point), z> for every CCS matrix j, summed over
        the distinct (matrix, column) pairs the matrices touch."""
        cap = int(self.e_rows.max()) + 1
        eq = mle.build_eq_table(point, max_rows=cap)          # (cap, 24)
        eqg = (eq[0][self.e_rows], eq[1][self.e_rows])
        sv = (self.e_vals[0][:, None], self.e_vals[1][:, None])
        prod = gl.mul(sv, eqg)                                 # (nnz, 24)
        n = self.ccs.n
        keys, inv = np.unique(self.e_mats * n + self.e_cols,
                              return_inverse=True)
        w = _segment_sum_mod_p(prod, inv.astype(np.int32), keys.shape[0])
        cols = keys % n
        zc = (z[0][cols], z[1][cols])
        terms = rq.ntt_mul(w, zc)                              # (pairs, 24)
        u = _segment_sum_mod_p(terms, (keys // n).astype(np.int32),
                               self.ccs.t)
        return [[int(v) for v in row] for row in gl.to_int(u)]

    def opens(self, acc, f_coeff):
        """Mismatches of the folded witness against the accumulator:
        norm, commitment, v, u (0 where it opens it)."""
        bad = 0
        cen = f_coeff.astype(np.uint64)
        neg = cen > np.uint64(P // 2)
        mag = np.where(neg, np.uint64(P) - cen, cen)
        bad += int(np.any(mag >= np.uint64(self.params.B)))
        wit = Witness.from_f_coeff(u64_limbs(f_coeff), self.params.B,
                                   self.params.L)
        bad += self.ajtai_commit(wit) != [list(c) for c in acc.cm]
        point = [H.ntt_slots(r)[0] for r in acc.r]
        bad += evaluate_mles_host(wit.f_hat, point) != [list(v)
                                                        for v in acc.v]
        head = u64_limbs(rings_u64(list(acc.x_w) + [acc.h]))
        z = (np.concatenate([head[0], wit.w_ccs[0]]),
             np.concatenate([head[1], wit.w_ccs[1]]))
        bad += self.claims_u(point, z) != [list(u) for u in acc.u]
        return bad


def judge(ref, inputs, records, checked, ckpt=None, start=None):
    """Count the mismatches of each kind over the checked steps; also
    returns the seconds each kind took and the steps that failed.

    records: {step: the program's state after it (see harness.snapshot)};
    checked: steps whose records hold what the step produced (cm_i,
    proof, w_ccs, f_coeff); ckpt: (step, path) of the last checkpoint
    written in the window, its step among `checked`; start: the chain's
    initial accumulator and its witness's f_coeff, which must open it."""
    bad = dict.fromkeys(NAMES, 0)
    seconds, failed = {}, set()
    if start is not None:
        t = time.perf_counter()
        bad["witness"] += ref.opens(*start)
        seconds["start"] = time.perf_counter() - t
        if bad["witness"]:
            failed.add(0)
    if not checked:
        seconds["ajtai"] = ref.ajtai_s
        return bad, seconds, failed
    t = time.perf_counter()
    wanted = set(checked) | {i - 1 for i in checked if i > 1}
    got, z0, snap = replay(inputs, wanted, ckpt[0] if ckpt else None)
    seconds["replay"] = time.perf_counter() - t
    for i in sorted(checked):
        before = sum(bad.values())
        prev, cur = records[i - 1], records[i]
        trace, zi_ref, _ = got[i]
        t = time.perf_counter()
        # state commitments after step i - 1 and step i
        sc = 0
        sc += prev["z_0_comm"] != z0
        if i - 1 >= 1:
            sc += prev["z_i_comm"] != got[i - 1][1]
        for st, zi in ((prev, prev["z_i_comm"]), (cur, zi_ref)):
            ac = ref.acc_comm(st["acc"])
            sc += st["acc_comm"] != ac
            sc += st["ivc_step_comm"] != ref.step_comm(st["step"], z0, zi,
                                                       ac)
        sc += cur["z_i_comm"] != zi_ref
        bad["statecomm"] += sc
        seconds["statecomm"] = seconds.get("statecomm", 0) + \
            time.perf_counter() - t
        # commit: the reference's own witness of step i
        t = time.perf_counter()
        z = arithmetize(IVCStepInput(
            ivc_step_comm=tuple(prev["ivc_step_comm"]), ivc_step=i - 1,
            state_0_comm=prev["z_0_comm"], state_comm=prev["z_i_comm"],
            acc_comm=prev["acc_comm"], acc=prev["acc"],
            folding_proof_vars=prev["fvars"], w_acc=None, trace=trace),
            ref.layout)
        l = ref.ccs.l
        w_ref = rings_u64(z[l + 1:])
        cm_i = cur["cm_i"]
        cb = int(not np.array_equal(w_ref, cur["w_ccs"]))
        cb += [list(x) for x in cm_i.x_ccs] != [list(x) for x in z[:l]]
        cb += ref.commit(u64_limbs(w_ref)) != [list(c) for c in cm_i.cm]
        bad["commit"] += cb
        seconds["commit"] = seconds.get("commit", 0) + \
            time.perf_counter() - t
        # fold: the reference verifier over the program's proof
        t = time.perf_counter()
        tr = Transcript(record_samples=True)
        try:
            folded = ref_nifs.verify(prev["acc"], cm_i, cur["proof"], tr,
                                     ref.ccs, ref.dp)
            bad["fold"] += not same_acc(folded, cur["acc"])
        except Exception as e:          # a proof that does not verify
            print(f"step {i}: the reference verifier refused the fold: "
                  f"{e!r}", file=sys.stderr)
            bad["fold"] += 1
        seconds["fold"] = seconds.get("fold", 0) + time.perf_counter() - t
        # collector, replayed from the reference verifier's challenges
        t = time.perf_counter()
        try:
            fv = generate_verification_witness_vars(
                prev["acc"], cm_i, cur["proof"], ref.ccs, ref.dp,
                lambda: ReplayTranscript(tr.samples))
            bad["collector"] += plain(fv) != plain(cur["fvars"])
        except Exception as e:          # vars the proof cannot give
            print(f"step {i}: the reference collector failed: {e!r}",
                  file=sys.stderr)
            bad["collector"] += 1
        seconds["collector"] = seconds.get("collector", 0) + \
            time.perf_counter() - t
        # the folded witness opens the folded accumulator
        t = time.perf_counter()
        bad["witness"] += ref.opens(cur["acc"], cur["f_coeff"])
        seconds["witness"] = seconds.get("witness", 0) + \
            time.perf_counter() - t
        if sum(bad.values()) > before:
            failed.add(i)
    if ckpt:
        t = time.perf_counter()
        bad["checkpoint"] += read_back(ref, ckpt, records[ckpt[0]],
                                       got[ckpt[0]], z0, snap)
        seconds["checkpoint"] = time.perf_counter() - t
        if bad["checkpoint"]:
            failed.add(ckpt[0])
    seconds["ajtai"] = ref.ajtai_s
    return bad, seconds, failed


def read_back(ref, ckpt, rec, got, z0, snap):
    """Mismatches between the checkpoint file of step `ckpt[0]` and the
    reference's state of that step (the program's accumulator and
    witness there are judged by the other checks)."""
    step, path = ckpt
    _, zi_ref, ops = got
    try:
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        acc = LCCCS(r=data["acc_r"].tolist(), v=data["acc_v"].tolist(),
                    cm=data["acc_cm"].tolist(), u=data["acc_u"].tolist(),
                    x_w=data["acc_xw"].tolist(),
                    h=data["acc_h"].tolist()[0])
        ac = ref.acc_comm(acc)
        want = {"step": step, "z_0_comm": z0, "z_i_comm": zi_ref,
                "acc_comm": ac, "mem_ops_comm": ops, "pc": snap["pc"],
                "regs": snap["regs"], "heap": snap["heap"],
                "reserved": snap["reserved"]}
        bad = sum(meta.get(k) != v for k, v in want.items())
        bad += not same_acc(acc, rec["acc"])
        bad += plain(json.loads(str(data["fvars"]))) != plain(rec["fvars"])
        f = limbs_u64((data["w_f_coeff_lo"], data["w_f_coeff_hi"]))
        bad += not np.array_equal(f, rec["f_coeff"])
        bad += data["memory"].tobytes() != snap["memory"]
        step_comm = [[int(v) for v in data["step_comm_digest"]],
                     json.loads(str(data["step_comm_states"]))]
        bad += plain(step_comm) != ref.step_comm(step, z0, zi_ref, ac)
        return bad
    except (OSError, KeyError, ValueError) as e:
        print(f"checkpoint {path}: {e!r}", file=sys.stderr)
        return 1
