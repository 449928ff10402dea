"""zkVM Poseidon2 commitments: memory Merkle tree, code commitment, register
hash, memory-op chain, state/accumulator/step commitments.

Mirrors latticeum/crates/zkvm/src/commitments.rs:43-341 on top of the
Plonky3 constructions it uses:
  * width-8 sponge (rate 4) for Merkle leaves, width-8 truncated permutation
    for 2-to-1 compression;
  * MerkleTree over row-major matrices: leaf digest i = sponge over row i,
    non-power-of-two heights padded with the zero digest, then binary
    compression levels;
  * the wide (width-16 rate-12) sponge for state/acc/step commitments.

Parity note — INTENTIONAL DIVERGENCE: the reference's `vm_mem_comm`
(commitments.rs:192-217) passes 1024 single-row matrices, which in Plonky3
collapses to ONE flat digest hashing all of memory, while its
`vm_mem_comm_with_opening` (:222-262) commits a 1024x256 matrix as a real
10-level page-Merkle tree — two DIFFERENT schemes for the same memory, so
a reference run's state commitments silently change scheme at the first
memory op.  This repo uses the page-Merkle tree for BOTH (the flat
variant made checkpoint/resume chains diverge on z_i_comm).  Consequence: z_0_comm and every state_i/ivc_step/acc digest
downstream differ from an unpatched reference run; rust-side digest parity
(scripts/rust_parity/compare.py --acc) requires the one-line reference
patch documented in scripts/rust_parity/README.md (make vm_mem_comm use
the with_opening tree).  See PARITY.md §memory-commitment divergence.
"""

from __future__ import annotations

from ..crypto import poseidon2_ref as p2
from ..field import host as H

P = H.P
ZERO_COMM = [0, 0, 0, 0]


def _leaf_digest(row_words):
    return p2.hash_narrow(row_words)


def hash_narrow(vals):
    return p2.hash_narrow(vals)


def hash_wide(vals):
    return p2.hash_wide(vals)


def merkle_levels(leaf_digests):
    """Build compression levels from (power-of-two padded) leaf digests."""
    n = len(leaf_digests)
    npad = 1 << (n - 1).bit_length() if n > 1 else 1
    layer = list(leaf_digests) + [ZERO_COMM] * (npad - n)
    layers = [layer]
    while len(layer) > 1:
        layer = [p2.compress8(layer[2 * i], layer[2 * i + 1])
                 for i in range(len(layer) // 2)]
        layers.append(layer)
    return layers


def merkle_root_of_rows(rows):
    """Root of a row-major matrix: leaf = sponge(row), then compress."""
    return merkle_levels([_leaf_digest(r) for r in rows])[-1][0]


def merkle_open(layers, index):
    """Sibling path for leaf `index` (bottom-up)."""
    proof = []
    idx = index
    for layer in layers[:-1]:
        proof.append(layer[idx ^ 1])
        idx >>= 1
    return proof


def merkle_verify(root, leaf_digest, index, proof):
    cur = list(leaf_digest)
    idx = index
    for sib in proof:
        cur = (p2.compress8(cur, sib) if idx % 2 == 0
               else p2.compress8(sib, cur))
        idx >>= 1
    return cur == list(root)


class ZkVmCommitter:
    """Host-side committer (device-batched leaf hashing plugs in later)."""

    # -- memory ----------------------------------------------------------
    def vm_mem_comm(self, vm) -> list:
        """Merkle root over per-page leaf digests (commitments.rs:192-217).

        Must be the SAME tree as vm_mem_comm_with_opening and the prover's
        IncrementalMemTree — an earlier flat-sponge variant here silently
        disagreed with the tree paths, so a run's state commitments changed
        scheme at its first memory op and checkpoint/resume chains diverged
        on z_i_comm."""
        return merkle_root_of_rows(
            [vm.page_words(i) for i in range(vm.page_count)])

    def vm_mem_comm_with_opening(self, vm, mem_op):
        """Single (page_count x words_per_page) matrix tree + page opening."""
        page_index, _ = vm.physical_addr(mem_op.address & ~0b11)
        rows = [vm.page_words(i) for i in range(vm.page_count)]
        layers = merkle_levels([_leaf_digest(r) for r in rows])
        return {
            "comm": layers[-1][0],
            "page": rows[page_index],
            "proof": merkle_open(layers, page_index),
            "page_index": page_index,
        }

    def verify_memory_opening(self, opening) -> bool:
        return merkle_verify(opening["comm"], _leaf_digest(opening["page"]),
                             opening["page_index"], opening["proof"])

    # -- code / registers / mem-ops --------------------------------------
    def vm_code_comm(self, code_bytes: bytes) -> list:
        """Merkle over 16-bit halfwords, one per leaf (commitments.rs:314-340)."""
        halfwords = []
        for i in range(0, len(code_bytes), 2):
            chunk = code_bytes[i:i + 2]
            halfwords.append(int.from_bytes(chunk.ljust(2, b"\x00"), "little"))
        assert halfwords
        return merkle_root_of_rows([[hw] for hw in halfwords])

    def vm_regs_comm(self, regs) -> list:
        return hash_wide(list(regs))

    def vm_mem_ops_vec_comm(self, previous_comm, mem_op) -> list:
        """Hash chain H(prev, (cycle, addr, value, 0)) (commitments.rs:291-307)."""
        return p2.compress8(previous_comm,
                            [mem_op.cycle, mem_op.address, mem_op.value, 0])

    # -- state / acc / step ----------------------------------------------
    def state_i_comm(self, regs, code_bytes, pc, memory_comm,
                     mem_ops_vec_comm) -> list:
        code = self.vm_code_comm(code_bytes)
        regs_c = self.vm_regs_comm(regs)
        return hash_wide(
            list(code) + [pc] + list(memory_comm) + list(regs_c)
            + list(mem_ops_vec_comm))

    def acc_comm(self, acc) -> list:
        """Hash of ICRT-flattened LCCCS fields (commitments.rs:144-176)."""
        vals = []
        for group in (acc.r, acc.v, acc.cm, acc.u, acc.x_w, [acc.h]):
            for ring in group:
                vals.extend(H.icrt(ring))
        return hash_wide(vals)

    def ivc_step_comm(self, i, state_0_comm, state_i_comm, acc_comm):
        """13-element preimage -> digest + recorded perm states
        (commitments.rs:83-105)."""
        preimage = ([i] + list(state_0_comm) + list(state_i_comm)
                    + list(acc_comm))
        digest, states = p2.hash_wide(preimage, record=True)
        return digest, states
