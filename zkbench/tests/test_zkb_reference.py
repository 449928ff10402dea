"""The frozen reference's pieces on small inputs: its Poseidon2 and
transcript against the program's native core, its page tree and state
commitments against the program's host copy, its evaluation claims
against the dense M^T eq product, and its opening check on a witness it
built, once sound and once broken, under each Ajtai scheme kind."""

import random

import numpy as np
import pytest

from zkbench import check
from zkbench.ref.crypto import poseidon2_ref as ref_p2
from zkbench.ref.crypto.transcript import Transcript as RefTranscript
from zkbench.ref.field import host as H
from zkbench.ref.nifs import decomposition as ref_dec
from zkbench.ref.nifs.linearization import evaluate_mles_host
from zkbench.ref.nifs.structs import LCCCS, Witness
from zkbench.ref.vm import assembler
from zkbench.ref.zkvm.params import resolve

P = H.P
SMALL = dict(B=1 << 16, L=4, B_SMALL=4, K=8, KAPPA=8)


@pytest.fixture(scope="module")
def refs():
    return {k: check.Reference(resolve(**SMALL), scheme_seed=2**31 + 99,
                               scheme=k) for k in check.SCHEMES}


@pytest.fixture(scope="module")
def ref(refs):
    return refs["row_constant"]


def test_poseidon2_and_transcript_equal_the_programs_native_core():
    from latticeum_tpu_torch.host.crypto import native
    from latticeum_tpu_torch.host.crypto.transcript import Transcript
    rng = random.Random(5)
    for _ in range(20):
        st = [rng.randrange(P) for _ in range(16)]
        assert ref_p2.perm16(st) == native.perm16(st)
        assert ref_p2.perm8(st[:8]) == native.perm8(st[:8])
    a, b = RefTranscript(), Transcript()
    for k in range(30):
        rings = [[rng.randrange(P) for _ in range(24)]
                 for _ in range(k % 4 + 1)]
        a.absorb_slice(rings)
        b.absorb_slice(rings)
        assert a.get_challenge() == b.get_challenge()
    assert a.get_short_challenge() == b.get_short_challenge()


def small_inputs(seed):
    elf = assembler.mem_churn_guest(pages=2, passes=1, stride=512)
    rng = np.random.default_rng(seed)
    heap = [(0x40000 + 4 * i, int(v)) for i, v in
            enumerate(rng.integers(0, 1 << 32, 2048, dtype=np.uint64))]
    return {"elf": elf, "heap": heap, "words_per_page": 256,
            "page_count": 1024}


def test_replay_state_commitments_equal_the_programs_host_copy():
    from latticeum_tpu_torch.host.vm.vm import VM
    from latticeum_tpu_torch.host.zkvm import commitments as pc
    data = small_inputs(3)
    wanted = {1, 9, 12, 20}
    got, z0, snap = check.replay(data, wanted, ckpt_step=12)
    vm = VM(256, 1024).load_elf_data(data["elf"])
    for addr, word in data["heap"]:
        vm.write_mem(addr, word)
    com = pc.ZkVmCommitter()
    code = com.vm_code_comm(vm.elf.raw_code.bytes)
    ops = list(pc.ZERO_COMM)
    seen = {}

    def state(pc_, regs):
        return pc.hash_wide(list(code) + [pc_] + com.vm_mem_comm(vm)
                            + list(pc.hash_wide(list(regs))) + list(ops))
    assert z0 == state(vm.pc, vm.regs)

    class Done(Exception):
        pass

    def intercept(trace, vm_):
        nonlocal ops
        if trace.side_effects.memory_op is not None:
            ops = com.vm_mem_ops_vec_comm(ops, trace.side_effects.memory_op)
        step = trace.cycle + 1
        if step in wanted:
            seen[step] = state(trace.output.pc, trace.output.regs)
        if step == 12:
            assert snap["regs"] == list(vm_.regs) and snap["pc"] == vm_.pc
        if step == max(wanted):
            raise Done
    with pytest.raises(Done):
        vm.run(intercept)
    assert {s: got[s][1] for s in wanted} == seen
    assert any(got[s][2] != [0, 0, 0, 0] for s in wanted)


def random_point(rng, s):
    return [tuple(int(rng.integers(0, P, dtype=np.uint64)) for _ in range(3))
            for _ in range(s)]


def test_claims_over_pairs_equal_the_dense_product(ref):
    rng = np.random.default_rng(4)
    n = ref.ccs.n
    z = rng.integers(0, P, (n, 24), dtype=np.uint64)
    point = random_point(rng, ref.ccs.s)
    zl = check.u64_limbs(z)
    dense = ref_dec.eval_claims_via_eqT(
        ref_dec.eq_transposed_rows(ref.ccs, point), zl)
    assert ref.claims_u(point, zl) == dense


def opened(ref, rng):
    """A witness of balanced digits and the accumulator it opens."""
    p = ref.params
    nf = ref.layout.w_size * p.L
    digits = rng.integers(-(p.B // 2) + 1, p.B // 2, (nf, 24))
    f_coeff = np.where(digits < 0,
                       np.uint64(P) - np.abs(digits).astype(np.uint64),
                       digits.astype(np.uint64))
    wit = Witness.from_f_coeff(check.u64_limbs(f_coeff), p.B, p.L)
    point = random_point(rng, ref.ccs.s)
    x_w = [[int(v) for v in rng.integers(0, P, 24, dtype=np.uint64)] for _ in range(4)]
    h = [int(v) for v in rng.integers(0, P, 24, dtype=np.uint64)]
    head = check.u64_limbs(check.rings_u64(x_w + [h]))
    z = (np.concatenate([head[0], wit.w_ccs[0]]),
         np.concatenate([head[1], wit.w_ccs[1]]))
    u = ref_dec.eval_claims_via_eqT(
        ref_dec.eq_transposed_rows(ref.ccs, point), z)
    acc = LCCCS(r=[H.ntt_from_fq3(c) for c in point],
                v=evaluate_mles_host(wit.f_hat, point),
                cm=ref.scheme.commit_host(wit.f), u=u, x_w=x_w, h=h)
    return acc, f_coeff


@pytest.mark.parametrize("kind", sorted(check.SCHEMES))
def test_a_witness_opens_its_accumulator_and_a_changed_one_does_not(refs,
                                                                    kind):
    ref = refs[kind]
    rng = np.random.default_rng(6)
    acc, f_coeff = opened(ref, rng)
    assert ref.opens(acc, f_coeff) == 0
    changed = f_coeff.copy()
    changed[7, 3] = (int(changed[7, 3]) + 1) % P
    assert ref.opens(acc, changed) >= 3        # cm, v and u all move
    wide = f_coeff.copy()
    wide[0, 0] = ref.params.B                  # past the norm bound
    assert ref.opens(acc, wide) >= 1
    other = LCCCS(r=acc.r, v=acc.v, cm=acc.cm, u=acc.u[::-1], x_w=acc.x_w,
                  h=acc.h)
    assert ref.opens(other, f_coeff) == 1
