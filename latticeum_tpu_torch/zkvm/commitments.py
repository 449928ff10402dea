"""The zkVM's memory and code commitments on a torch device.

Counterpart of ``latticeum_tpu/zkvm/commitments.py::ZkVmCommitter`` and of
``latticeum_tpu/zkvm/prover.py::IncrementalMemTree``.  The page tree
(one leaf per memory page, the sponge of its words) and the code tree (one
leaf per 16-bit code halfword) are built on the device through perm8
(``crypto/poseidon2.py``): each sponge absorb and each compression level is
one perm8 launch over all rows.  Everything else (register hash, memory-op
chain, state/acc/step commitments) is the host copy's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.poseidon2 import merkle_levels_rows
from ..field import goldilocks as gl
from ..host.crypto import poseidon2_ref as p2
from ..host.zkvm import commitments as host_comm


def page_rows(vm, device):
    """All memory pages of `vm` as an int64 (page_count, words_per_page)
    tensor of u32 words on `device` (the rows of vm.page_words)."""
    words = np.frombuffer(b"".join(vm.memory), dtype="<u4").reshape(
        vm.page_count, vm.words_per_page)
    return torch.from_numpy(words.astype(np.int64)).to(device)


def code_rows(code_bytes, device):
    """Code bytes -> (halfwords, 1) int64 leaf rows, little-endian, the last
    odd byte zero-padded (commitments.rs:314-340)."""
    if not code_bytes:
        raise ValueError("empty code")
    padded = bytes(code_bytes) + b"\x00" * (len(code_bytes) % 2)
    hw = np.frombuffer(padded, dtype="<u2").astype(np.int64)
    return torch.from_numpy(hw[:, None].copy()).to(device)


def _root(levels):
    return gl.to_int_lists(levels[-1])[0]


class ZkVmCommitter(host_comm.ZkVmCommitter):
    """The host committer with the memory and code trees on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)

    def vm_mem_comm(self, vm) -> list:
        """Merkle root over per-page leaf digests (commitments.rs:192-217)."""
        return _root(merkle_levels_rows(page_rows(vm, self.device)))

    def vm_code_comm(self, code_bytes: bytes) -> list:
        """Merkle over 16-bit halfwords, one per leaf (commitments.rs:314-340)."""
        return _root(merkle_levels_rows(code_rows(code_bytes, self.device)))


class IncrementalMemTree:
    """Merkle tree over memory pages with O(log n) updates per write.

    The initial levels are built on `device` and brought to the host as int
    lists once; each write then rehashes one page and its path on the host,
    as the JAX package's tree does."""

    def __init__(self, vm, device):
        levels = merkle_levels_rows(page_rows(vm, device))
        self.levels = [gl.to_int_lists(lv) for lv in levels]
        self.vm = vm

    def update_page(self, page_index: int):
        digest = host_comm.hash_narrow(self.vm.page_words(page_index))
        self.levels[0][page_index] = digest
        idx = page_index
        for lvl in range(len(self.levels) - 1):
            idx2 = idx ^ 1
            left = self.levels[lvl][min(idx, idx2)]
            right = self.levels[lvl][max(idx, idx2)]
            idx >>= 1
            self.levels[lvl + 1][idx] = p2.compress8(left, right)

    @property
    def root(self):
        return self.levels[-1][0]

    def open(self, page_index: int):
        return host_comm.merkle_open(self.levels, page_index)
