"""Core LatticeFold data structures: CCS, CCCS, LCCCS, Witness.

TPU-first layout: CCS matrices are COO index arrays + ring-limb values living
on device; M·z is a gathered slot-wise ring product followed by an
overflow-safe segment-sum over rows — the whole t-matrix sweep is one batched
kernel feed, not t sparse walks.  Mirrors the semantics of
latticefold/src/arith.rs:51-118 (CCS), :180-206 (CCCS/LCCCS), :214-370
(Witness / f_hat).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import backend as B

from ..field import goldilocks as gl, host as H
from ..ring import decompose as dc, rq


def _bit_len(x):
    return (x - 1).bit_length() if x > 1 else 0


@dataclass
class SparseRingMatrix:
    """COO sparse matrix over RqNTT: rows/cols int32, vals (nnz, 24) limbs."""

    nrows: int
    ncols: int
    rows: B.xp.ndarray           # (nnz,) int32
    cols: B.xp.ndarray           # (nnz,) int32
    vals: tuple                 # (nnz, 24) limb pair

    @staticmethod
    def from_host(nrows, ncols, entries):
        """entries: list of (row, col, ring24_int_list)."""
        if not entries:
            return SparseRingMatrix(
                nrows, ncols,
                B.xp.zeros((0,), np.int32), B.xp.zeros((0,), np.int32),
                gl.zeros((0, 24)))
        rows = B.xp.asarray(np.array([e[0] for e in entries], np.int32))
        cols = B.xp.asarray(np.array([e[1] for e in entries], np.int32))
        vals = gl.from_int(np.array([e[2] for e in entries], dtype=object))
        return SparseRingMatrix(nrows, ncols, rows, cols, vals)

    @property
    def max_row(self):
        if not hasattr(self, "_max_row"):
            self._max_row = (int(np.asarray(self.rows).max())
                             if self.rows.shape[0] else 0)
        return self._max_row

    def matvec(self, z, out_rows: int | None = None):
        """M @ z over the ring. z: (ncols, 24) limbs -> (out_rows, 24)."""
        out_rows = out_rows or self.nrows
        if self.rows.shape[0] == 0:
            return gl.zeros((out_rows, 24))
        zg = (z[0][self.cols], z[1][self.cols])        # (nnz, 24)
        prod = rq.ntt_mul(self.vals, zg)               # (nnz, 24)
        return _segment_sum_mod_p(prod, self.rows, out_rows)

    def matvec_T(self, y, out_cols: int | None = None):
        """M^T @ y over the ring: y (nrows, 24) -> (out_cols, 24)."""
        out_cols = out_cols or self.ncols
        if self.rows.shape[0] == 0:
            return gl.zeros((out_cols, 24))
        yg = (y[0][self.rows], y[1][self.rows])
        prod = rq.ntt_mul(self.vals, yg)
        return _segment_sum_mod_p(prod, self.cols, out_cols)


@dataclass
class SparseScalarMatrix:
    """COO matrix whose values are base-field SCALARS (embedded rings).

    The zkVM gate matrices only ever hold scalar coefficients
    (constraints.rs uses R::from(u64) / b_s powers), so M·z multiplies each
    gathered ring row by a scalar — 24x cheaper than a full slot-wise mul.
    """

    nrows: int
    ncols: int
    rows: object            # (nnz,) int32
    cols: object            # (nnz,) int32
    vals: tuple             # (nnz,) limb pair (scalars)

    @staticmethod
    def from_entries(nrows, ncols, entries):
        """entries: list of (row, col, scalar_int)."""
        if not entries:
            return SparseScalarMatrix(
                nrows, ncols, B.xp.zeros((0,), np.int32),
                B.xp.zeros((0,), np.int32), gl.zeros((0,)))
        rows = B.xp.asarray(np.array([e[0] for e in entries], np.int32))
        cols = B.xp.asarray(np.array([e[1] for e in entries], np.int32))
        vals = gl.from_int(np.array([e[2] for e in entries], dtype=object))
        return SparseScalarMatrix(nrows, ncols, rows, cols, vals)

    @property
    def nnz(self):
        return int(self.rows.shape[0])

    @property
    def max_row(self):
        if not hasattr(self, "_max_row"):
            self._max_row = int(self.rows.max()) if self.nnz else 0
        return self._max_row

    def matvec(self, z, out_rows: int | None = None):
        """M @ z: z (ncols, 24) limbs -> (out_rows, 24).

        Reduction runs over the compact populated-row prefix only (gate rows
        occupy a small prefix of the padded 2^s space).
        """
        out_rows = out_rows or self.nrows
        if self.nnz == 0:
            return gl.zeros((out_rows, 24))
        zg = (z[0][self.cols], z[1][self.cols])          # (nnz, 24)
        sv = (self.vals[0][:, None], self.vals[1][:, None])
        prod = gl.mul(sv, zg)
        cap = self.max_row + 1
        compact = _segment_sum_mod_p(prod, self.rows, cap)
        if cap >= out_rows:
            return compact
        pad = out_rows - cap
        return (B.xp.concatenate([compact[0],
                                  B.xp.zeros((pad, 24), np.uint32)]),
                B.xp.concatenate([compact[1],
                                  B.xp.zeros((pad, 24), np.uint32)]))

    def matvec_T(self, y, out_cols: int | None = None):
        """M^T @ y: y (nrows, 24) limbs -> (out_cols, 24).

        Used for evaluation claims: <MLE[Mz], eq(r)> = (M^T eq) · z.
        """
        out_cols = out_cols or self.ncols
        if self.nnz == 0:
            return gl.zeros((out_cols, 24))
        yg = (y[0][self.rows], y[1][self.rows])
        sv = (self.vals[0][:, None], self.vals[1][:, None])
        prod = gl.mul(sv, yg)
        return _segment_sum_mod_p(prod, self.cols, out_cols)


def _segment_sum_mod_p(vals, segment_ids, num_segments):
    """Segment-sum of canonical field limbs, exact mod p.

    Split limbs into 16-bit columns (uint32 accumulators), segment-sum each,
    recombine via reduce128.  Safe for < 2^16 terms per segment.
    """
    lo, hi = vals
    cols = B.xp.stack([lo & gl.MASK16, lo >> 16, hi & gl.MASK16, hi >> 16])
    summed = B.segment_sum(
        B.xp.moveaxis(cols, 0, -1), segment_ids, num_segments)  # (seg, 24, 4)
    c = B.xp.moveaxis(summed, -1, 0)  # (4, seg, 24)
    return gl._combine_cols_small(c)


@dataclass
class CCS:
    """CCS structure (arith.rs:51-75). Matrices padded to m rows."""

    m: int
    n: int
    l: int
    t: int
    q: int
    d: int
    M: list                      # t SparseRingMatrix (device)
    S: list                      # q lists of matrix indices
    c: list                      # q host ring elements (24-int lists)

    @property
    def s(self):
        return _bit_len(self.m)

    @property
    def s_prime(self):
        return _bit_len(self.n)

    def matvecs(self, z, out_rows=None):
        """All t products M_j z -> (t, out_rows, 24) limbs (the Mz MLEs)."""
        outs = [Mj.matvec(z, out_rows or self.m) for Mj in self.M]
        return (B.xp.stack([o[0] for o in outs]), B.xp.stack([o[1] for o in outs]))

    def check_relation(self, z) -> bool:
        """Σ_i c_i ⊙_{j∈S_i} (M_j z) == 0 (arith.rs:78-107)."""
        res = self.relation_residual(self.matvecs(z))
        return bool(B.xp.all(res[0] == 0) & B.xp.all(res[1] == 0))

    def relation_residual(self, mz):
        total = gl.zeros((self.m, 24))
        for i in range(self.q):
            had = None
            for j in self.S[i]:
                term = (mz[0][j], mz[1][j])
                had = term if had is None else rq.ntt_mul(had, term)
            ci = gl.from_int(np.array(self.c[i], dtype=object))
            ci = (B.xp.broadcast_to(ci[0], had[0].shape),
                  B.xp.broadcast_to(ci[1], had[1].shape))
            total = gl.add(total, rq.ntt_mul(had, ci))
        return total


@dataclass
class CCCS:
    cm: list                     # kappa host ring elements
    x_ccs: list                  # l host ring elements

    def z_vector(self, w_ccs):
        """x_ccs || 1 || w (arith.rs:400-408). w_ccs: (nw, 24) device limbs."""
        head = [list(x) for x in self.x_ccs] + [H.ntt_from_u64(1)]
        head_dev = gl.from_int(np.array(head, dtype=object))
        return (B.xp.concatenate([head_dev[0], w_ccs[0]]),
                B.xp.concatenate([head_dev[1], w_ccs[1]]))


@dataclass
class LCCCS:
    r: list                      # s host ring elements (embedded Fq3)
    v: list                      # tau host ring elements
    cm: list                     # kappa host ring elements
    u: list                      # t host ring elements
    x_w: list                    # l host ring elements
    h: list                      # host ring element

    def z_vector(self, w_ccs):
        head = [list(x) for x in self.x_w] + [list(self.h)]
        head_dev = gl.from_int(np.array(head, dtype=object))
        return (B.xp.concatenate([head_dev[0], w_ccs[0]]),
                B.xp.concatenate([head_dev[1], w_ccs[1]]))


TAU = 3  # 24 / 8


@dataclass
class Witness:
    """CCS witness with B-decomposition and f_hat (arith.rs:214-320)."""

    w_ccs: tuple                 # (nw, 24) NTT limbs
    f_coeff: tuple               # (nw*L, 24) coeff-form limbs
    f: tuple                     # (nw*L, 24) NTT limbs
    f_hat: tuple                 # (TAU, 2^nv, 24) NTT limbs (padded MLEs)

    @staticmethod
    def from_w_ccs(w_ccs, B: int, L: int):
        w_coeff = rq.icrt(w_ccs)
        f_coeff = dc.gadget_decompose(w_coeff, B, L)
        f = rq.crt(f_coeff)
        return Witness(w_ccs, f_coeff, f, Witness.build_fhat(f_coeff))

    @staticmethod
    def from_f_coeff(f_coeff, B: int, L: int):
        f = rq.crt(f_coeff)
        w_ccs = dc.gadget_recompose(f, B, L)
        return Witness(w_ccs, f_coeff, f, Witness.build_fhat(f_coeff))

    @staticmethod
    def build_fhat(f_coeff):
        """(nf, 24) coeff limbs -> (TAU, 2^nv, 24) padded NTT-slot packing.

        fhat[j][i] has slot s = (f_coeff[i][8j+s], 0, 0) (arith.rs:273-297).
        """
        lo, hi = f_coeff
        nf = lo.shape[-2]
        nv = (nf - 1).bit_length() if nf > 1 else 0
        npad = 1 << nv
        chunks_lo = lo.reshape(nf, TAU, 8)
        chunks_hi = hi.reshape(nf, TAU, 8)
        out_lo = B.xp.zeros((TAU, npad, 8, 3), np.uint32)
        out_hi = B.xp.zeros((TAU, npad, 8, 3), np.uint32)
        out_lo = B.at_set(out_lo, (slice(None), slice(0, nf), slice(None), 0), B.xp.moveaxis(chunks_lo, 0, 1))
        out_hi = B.at_set(out_hi, (slice(None), slice(0, nf), slice(None), 0), B.xp.moveaxis(chunks_hi, 0, 1))
        return (out_lo.reshape(TAU, npad, 24), out_hi.reshape(TAU, npad, 24))

    def commit(self, scheme):
        return scheme.commit(self.f)
