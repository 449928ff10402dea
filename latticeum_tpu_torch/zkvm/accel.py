"""Device engine: the CCS on the device, boundary transfers, COO matvecs and
eq tables.

Counterpart of ``latticeum_tpu/zkvm/accel.py::DeviceEngine``.  PyTorch runs
eagerly, so there is no jit cache, compile cache or host tail threshold:
every function is a plain sequence of tensor ops on ``self.device``.

All t CCS matrices are held as ONE COO (matrix id per entry), so each Mz
stack, M^T eq stack or challenged-z combination is one gather, one product
and one exact segment sum (``goldilocks.segment_sum``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from ..ring import rq
from . import tables


def _coo_host(ccs):
    """Concatenated (rows, cols, mats, vals u64) of all t matrices.  vals is
    (nnz,) when every matrix holds base-field scalars, else (nnz, 24) with
    scalars embedded as the slot pattern (c, 0, 0) x 8."""
    scalar = all(np.asarray(M.vals[0]).ndim == 1 for M in ccs.M)
    rows, cols, mats, vals = [], [], [], []
    for j, M in enumerate(ccs.M):
        lo = np.asarray(M.vals[0]).astype(np.uint64)
        hi = np.asarray(M.vals[1]).astype(np.uint64)
        v = lo | (hi << np.uint64(32))
        if not scalar and v.ndim == 1:
            full = np.zeros((v.shape[0], 24), np.uint64)
            full[:, 0::3] = v[:, None]
            v = full
        rows.append(np.asarray(M.rows, dtype=np.int64))
        cols.append(np.asarray(M.cols, dtype=np.int64))
        mats.append(np.full(rows[-1].shape, j, np.int64))
        vals.append(v)
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(mats),
            np.concatenate(vals), scalar)


class Engine:
    """The CCS on one device plus the tensor primitives built on it."""

    def __init__(self, ccs, device):
        self.ccs = ccs
        self.device = torch.device(device)
        rows, cols, mats, vals, scalar = _coo_host(ccs)
        self.scalar = scalar
        self.rows = torch.from_numpy(rows).to(self.device)
        self.cols = torch.from_numpy(cols).to(self.device)
        self.mats = torch.from_numpy(mats).to(self.device)
        self.vals = torch.from_numpy(gl.to_i64_bits(vals)).to(self.device)
        self.max_row = int(rows.max()) if rows.size else 0

    # -- boundary --------------------------------------------------------
    def put(self, limbs):
        """Reference (lo, hi) uint32 limb pair -> int64 tensor on device."""
        return gl.from_limbs(limbs, self.device)

    def get(self, x):
        """Tensor -> reference (lo, hi) uint32 limb pair on host."""
        return gl.to_limbs(x)

    def ints(self, values):
        """Host Python ints -> int64 tensor on device."""
        return gl.from_int(values, self.device)

    # -- COO primitives --------------------------------------------------
    def coo_mul(self, g):
        """Per-entry product vals[e] * g[e] for gathered rings g (nnz, 24)."""
        if self.scalar:
            return gl.mul(self.vals[:, None], g)
        return rq.ntt_mul(self.vals, g)

    def mz_stack(self, z, out_rows, row_pos):
        """All t products M_j z -> (t, out_rows, 24); entry e lands at row
        row_pos[e] (the bit-reversed row for the t-layout)."""
        prod = self.coo_mul(z[self.cols])
        s = gl.segment_sum(prod, self.mats * out_rows + row_pos,
                           self.ccs.t * out_rows)
        return s.reshape(self.ccs.t, out_rows, 24)

    def mt_eq_stack(self, eq):
        """All t products M_j^T eq -> (t, n, 24) for an eq table (>= cap rows)."""
        n = self.ccs.n
        prod = self.coo_mul(eq[self.rows])
        s = gl.segment_sum(prod, self.mats * n + self.cols, self.ccs.t * n)
        return s.reshape(self.ccs.t, n, 24)

    def eq_table(self, point, max_rows, t_layout=False, out=None):
        """eq(point, x) over the hypercube, variable 0 = least significant
        index bit, as (rows, 24) with rows = 2^ceil(log2(min(2^nv, max_rows))),
        or (24, rows) in the bit-reversed t-layout; into `out` where given.
        Skipped top variables fold their prod(1 - r_j) into every row
        (``tables.eq_table``, a kernel on the card)."""
        return tables.eq_table(point, max_rows, self.device, t_layout, out)
