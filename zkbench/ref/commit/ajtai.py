"""Ajtai lattice commitment: cm = A · f over RqNTT.

The reference scheme (latticefold/src/commitment/commitment_scheme.rs:17-77)
holds a dense kappa x n matrix of ring elements and commits with a ring
matvec.  On TPU the matvec is a batched slot-wise product reduced with the
overflow-safe mod-p summation; chunked over n to bound transient memory.

Matrix generation: the reference uses `AjtaiCommitmentScheme::rand` seeded by
`ark_std::test_rng` — note rand's `vec![R::rand(rng); n]` CLONES one sample
per row, so every row of the reference matrix is n copies of one random ring
element (a PoC quirk).  We default to a deterministic Poseidon2-seeded matrix
(`expand_seed`) with an optional `row_constant=True` mode replicating the
reference's row structure, and support loading a captured matrix for parity.
"""

from __future__ import annotations

from .. import backend as B
import numpy as np

from ..crypto import poseidon2_ref as p2
from ..field import goldilocks as gl
from ..ring import rq

P = gl.P


class AjtaiScheme:
    def __init__(self, matrix, kappa: int, n: int):
        """matrix: (kappa, n, 24) limb pair in NTT form."""
        self.matrix = matrix
        self.kappa = kappa
        self.n = n
        self.row_constant = False

    @staticmethod
    def from_seed(kappa: int, n: int, seed: int = 0,
                  row_constant: bool = True):
        """Deterministic matrix via a Poseidon2-based XOF.

        row_constant=True matches the reference's structure (each row is one
        ring element repeated across all n columns,
        commitment_scheme.rs:29-33).
        """
        rows = []
        ch = p2.DuplexChallenger()
        ch.observe(seed % P)
        for _k in range(kappa):
            elem = [ch.sample() for _ in range(24)]
            rows.append(elem)
        arr = np.array(rows, dtype=object)  # (kappa, 24)
        limbs = gl.from_int(arr)
        if row_constant:
            mat = (B.xp.broadcast_to(limbs[0][:, None, :], (kappa, n, 24)),
                   B.xp.broadcast_to(limbs[1][:, None, :], (kappa, n, 24)))
            scheme = AjtaiScheme(mat, kappa, n)
            scheme.rows_limbs = limbs
            scheme.row_constant = True
            return scheme
        # full random matrix: sample kappa*n elements
        full = []
        for _k in range(kappa):
            row = []
            for _i in range(n):
                row.append([ch.sample() for _ in range(24)])
            full.append(row)
        return AjtaiScheme(gl.from_int(np.array(full, dtype=object)), kappa, n)

    def commit(self, f, chunk: int = 1 << 14):
        """f: (n, 24) NTT limbs -> commitment (kappa, 24) limbs (device)."""
        assert f[0].shape[-2] == self.n, (f[0].shape, self.n)
        if getattr(self, "row_constant", False):
            # each row is one ring element repeated: cm_k = a_k * sum_i f_i
            # (exactly equal to the dense matvec for this matrix structure)
            total = gl.sum_axis(f, axis=-2)
            return rq.ntt_mul(self.rows_limbs,
                              (total[0][None], total[1][None]))
        mlo, mhi = self.matrix
        acc = None
        for start in range(0, self.n, chunk):
            end = min(start + chunk, self.n)
            a = (mlo[:, start:end], mhi[:, start:end])       # (kappa, c, 24)
            x = (f[0][None, start:end], f[1][None, start:end])
            prod = rq.ntt_mul(a, x)                          # (kappa, c, 24)
            part = gl.sum_axis(prod, axis=-2)                # (kappa, 24)
            acc = part if acc is None else gl.add(acc, part)
        return acc

    def commit_host(self, f_dev):
        """commit() pulled to host int lists (kappa x 24)."""
        cm = self.commit(f_dev)
        return [[int(v) for v in row] for row in gl.to_int(cm)]
