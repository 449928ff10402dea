"""The zkVM's memory and code commitments on a torch device.

Counterpart of ``latticeum_tpu/zkvm/commitments.py::ZkVmCommitter`` and of
``latticeum_tpu/zkvm/prover.py::IncrementalMemTree``.  The page tree
(one leaf per memory page, the sponge of its words) and the code tree (one
leaf per 16-bit code halfword) are built on the device
(``crypto/poseidon2.py``): the leaves in one sponge8 launch over all rows,
then one perm8 launch per compression level.  Everything else (register
hash, memory-op chain, state/acc/step commitments) is the host copy's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.poseidon2 import (hash_rows_narrow, merkle_levels,
                               merkle_levels_rows)
from ..field import goldilocks as gl
from ..host.crypto import poseidon2_ref as p2
from ..host.utils import tracing
from ..host.zkvm import commitments as host_comm


def page_words(vm):
    """All memory pages of `vm` as an int64 (page_count, words_per_page)
    host array of u32 words (the rows of vm.page_words)."""
    words = np.frombuffer(b"".join(vm.memory), dtype="<u4").reshape(
        vm.page_count, vm.words_per_page)
    return words.astype(np.int64)


def page_rows(vm, device):
    """page_words(vm) as a tensor on `device`."""
    return torch.from_numpy(page_words(vm)).to(device)


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
    as the JAX package's tree does.  With `timings` (a dict of lists), the
    build records its parts under "trees.page_copy", "trees.upload",
    "trees.sponge", "trees.levels" and "trees.fetch", each a span of that
    name that waits for the device as it closes."""

    PARTS = ("page_copy", "upload", "sponge", "levels", "fetch")

    def __init__(self, vm, device, timings=None):
        device = torch.device(device)
        wait = (lambda: torch.cuda.synchronize(device)) if (
            timings is not None and device.type == "cuda") else None

        def part(name):
            return tracing.span("trees." + name, timings, "trees." + name,
                                wait)

        with part("page_copy"):
            words = page_words(vm)
        with part("upload"):
            rows = torch.from_numpy(words).to(device)
        with part("sponge"):
            leaves = hash_rows_narrow(rows)
        with part("levels"):
            levels = merkle_levels(leaves)
        with part("fetch"):
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
