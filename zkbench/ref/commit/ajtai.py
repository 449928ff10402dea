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

The dense, binding matrix (`from_seed_general`) is drawn with Philox, as the
program draws it.  Its commitments are `commit`'s slot-wise matvec by
definition; `commit_coeff` reaches the same value by an exact float64 matrix
product against the witness's small coefficients where they allow it.
"""

from __future__ import annotations

from .. import backend as B
import numpy as np

from ..crypto import poseidon2_ref as p2
from ..field import goldilocks as gl
from ..ring import rq

P = gl.P

# the dense path cuts each matrix entry (< p < 2^64) into 16-bit limbs
LIMB_BITS = 16
LIMBS = 4
EXACT = 1 << 53         # float64 holds every integer of magnitude below it


class AjtaiScheme:
    def __init__(self, matrix, kappa: int, n: int):
        """matrix: (kappa, n, 24) limb pair in NTT form."""
        self.matrix = matrix
        self.kappa = kappa
        self.n = n
        self.row_constant = False
        self._dense_parts = None        # commit_dense's, made on first use

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

    @staticmethod
    def from_seed_general(kappa: int, n: int, seed: int = 0):
        """Dense uniform kappa x n matrix from `seed`: numpy's Philox
        counter-based generator keyed by the seed, 64-bit draws, each one
        at or above p drawn again (P(reject) ~ 2^-32).  Bit for bit the
        program's binding-commitment matrix (its `general_ajtai` scheme),
        so the reference commits under the matrix the program was given."""
        rng = np.random.Generator(np.random.Philox(key=seed))
        w = rng.integers(0, 1 << 64, size=(kappa, n, 24), dtype=np.uint64)
        bad = w >= np.uint64(P)
        while bad.any():
            w[bad] = rng.integers(0, 1 << 64, size=int(bad.sum()),
                                  dtype=np.uint64)
            bad = w >= np.uint64(P)
        return AjtaiScheme(((w & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                            (w >> np.uint64(32)).astype(np.uint32)), kappa, n)

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

    def commit_coeff(self, f_coeff, f):
        """commit_host(f) of a witness given in both forms, f_coeff (n, 24)
        coefficient limbs and f = crt(f_coeff).  A dense matrix commits by
        `commit_dense` where every coefficient lies within its exact range,
        and by the slot-wise definition otherwise; a row-constant one by
        the definition, whose sums are cheap."""
        if not self.row_constant:
            x = self.small_coeffs(f_coeff)
            if x is not None:
                return self.commit_dense(x)
        return self.commit_host(f)

    def small_coeffs(self, f_coeff):
        """f_coeff (n, 24) limbs -> their centred values (int64), or None
        where one is not canonical or lies beyond commit_dense's exact
        range: magnitude at most (2^53 - 1) / (n (2^16 - 1))."""
        u = np.asarray(f_coeff[0], np.uint64) | (
            np.asarray(f_coeff[1], np.uint64) << np.uint64(32))
        if np.any(u >= np.uint64(P)):
            return None
        neg = u > np.uint64(P // 2)
        mag = np.where(neg, np.uint64(P) - u, u)
        if mag.size and int(mag.max()) > (EXACT - 1) // (
                self.n * ((1 << LIMB_BITS) - 1)):
            return None
        x = mag.astype(np.int64)
        return np.where(neg, -x, x)

    def commit_dense(self, x):
        """The commitment (kappa x 24 host ints) of the witness whose
        coefficient form is x (n, 24) int64, small (see small_coeffs).

        Linearity does the work: crt is F_p-linear and the slot-wise
        product bilinear, so with G[k, j, b] = sum_i A[k, i, j] x[i, b]
        (A in its NTT form, as drawn),

            cm_k = sum_{j, b} G[k, j, b] * (e_j (.) crt(e_b)),

        e_j the unit vectors, (.) the slot-wise product.  G is one float64
        matrix product per 16-bit limb of A.  Exact: a limb is below 2^16
        and |x| at most (2^53 - 1) / (n (2^16 - 1)), so each of a sum's n
        terms is at most (2^53 - 1) / n in magnitude and every partial sum,
        in any order, at most 2^53 - 1: float64 holds each one exactly.
        With |x| < B = 2^15 and n = 98,815 (the production witness) the
        sums stay below 98,815 * 2^16 * 2^15 < 2^47.6.  The limbs are
        joined and reduced mod p in Python ints."""
        planes, pairs = self._dense()
        g = planes @ x.astype(np.float64)          # (LIMBS*kappa*24, 24)
        g = g.astype(np.int64).reshape(LIMBS, self.kappa * 24 * 24)
        joined = sum(g[l].astype(object) << (LIMB_BITS * l)
                     for l in range(LIMBS)) % P
        cm = np.dot(joined.reshape(self.kappa, 24 * 24), pairs) % P
        return [[int(v) for v in row] for row in cm]

    def _dense(self):
        """(A's limbs (LIMBS*kappa*24, n) float64, the products
        e_j (.) crt(e_b) as (24*24, 24) ints), made on first use."""
        if self._dense_parts is None:
            lo, hi = (np.asarray(m).transpose(0, 2, 1) for m in self.matrix)
            mask = np.uint32((1 << LIMB_BITS) - 1)
            planes = np.empty((LIMBS, self.kappa, 24, self.n), np.float64)
            for l, half in enumerate((lo, lo, hi, hi)):
                planes[l] = (half >> np.uint32(LIMB_BITS * (l % 2))) & mask
            eye = gl.from_int(np.eye(24, dtype=np.uint64))
            basis = rq.crt(eye)                                # crt(e_b)
            shape = (24, 24, 24)
            pairs = rq.ntt_mul(
                tuple(np.broadcast_to(c[:, None, :], shape) for c in eye),
                tuple(np.broadcast_to(c[None, :, :], shape) for c in basis))
            self._dense_parts = (planes.reshape(-1, self.n),
                                 gl.to_int(pairs).reshape(24 * 24, 24))
        return self._dense_parts
