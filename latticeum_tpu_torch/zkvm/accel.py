"""Device engine: the CCS on the device, boundary transfers, COO matvecs and
eq tables.

Counterpart of ``latticeum_tpu/zkvm/accel.py::DeviceEngine``.  PyTorch runs
eagerly, so there is no jit cache, compile cache or host tail threshold:
every function is a plain sequence of tensor ops on ``self.device``.

All t CCS matrices are held as ONE COO (matrix id per entry), sorted once,
at construction, by the output segment of each of the three segment maps
the fold step uses (``Csr``): M z into the lin stack's bit-reversed rows,
M^T eq by column, and the fold head's challenged z into bit-reversed rows
of all matrices at once.  Each Mz stack, M^T eq stack or challenged-z
combination is then one ``coo_matvec``: on a card one launch of
``coo_kernel`` (``csrc/coo.cu``, counted in ``coo_matvec.launches``;
counterpart of the XLA ``DeviceEngine.matvecs``, :117, and of
``accel_nifs.py``'s ``lin_g_t``, :437, ``eqT``, :634, and the COO part of
``_build_head``, :997), on the CPU its plain-torch twin
``coo_matvec_twin``: one gather, one product and one exact segment sum
(``goldilocks.segment_sum``).  Any other device raises; there is no
fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import goldilocks as gl
from ..kernels import (check as _check, launch as _launch, ptr as _ptr,
                       route as _route, stream as _stream)
from ..ring import rq
from . import tables

COO_LIGHT = 64   # csrc/coo.cu: most items of a light segment


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


@dataclass
class Csr:
    """One segment map of the COO, its entries sorted by output segment.
    Segment s = blk * per + pos is output position (blk, pos); entry e of
    it (off[s] <= e < off[s + 1]) reads input row gather[e] of matrix
    mats[e] with value vals[e], gather[e] < rows_in.  ``by_size``: the
    non-empty segments, most entries first, with their entry counts
    ``sizes`` on the host (the kernel's heavy segments are a prefix of
    it)."""
    nseg: int
    per: int
    rows_in: int
    off: torch.Tensor        # (nseg + 1,) int32
    gather: torch.Tensor     # (nnz,) int32
    mats: torch.Tensor       # (nnz,) int32
    vals: torch.Tensor       # (nnz,) or (nnz, 24) int64
    by_size: torch.Tensor    # (non-empty,) int32
    sizes: np.ndarray        # (non-empty,) int64, descending

    def n_heavy(self, nwit=1):
        """The segments whose entries x witnesses exceed COO_LIGHT."""
        return int(np.count_nonzero(self.sizes * nwit > COO_LIGHT))


def build_csr(seg, gather, mats, vals, nseg, per, device):
    """The Csr of entries with output segments `seg` (host arrays)."""
    if nseg % per:
        raise ValueError(f"{nseg} segments are not blocks of {per}")
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=nseg)
    if counts.shape[0] != nseg:
        raise ValueError(f"a segment index is not below {nseg}")
    off = np.zeros(nseg + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    full = np.flatnonzero(counts)
    full = full[np.argsort(-counts[full], kind="stable")]

    def i32(a):
        return gl.upload(torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.int32)), device)
    rows_in = int(gather.max()) + 1 if gather.size else 0
    return Csr(nseg, per, rows_in, i32(off), i32(gather[order]),
               i32(mats[order]),
               gl.upload(torch.from_numpy(gl.to_i64_bits(vals[order])),
                         device),
               i32(full), counts[full])


# -- the segment sums ------------------------------------------------------

def coo_out_shape(csr, t_layout):
    blk = csr.nseg // csr.per
    return (blk, 24, csr.per) if t_layout else (blk, csr.per, 24)


def coo_matvec_twin(csr, x, out, t_layout, zeta=None):
    """The segment sums as the port first ran them: the gathered rows (in
    the head mode the challenged z, sum_i zeta_i[mat] * z_i[col]), their
    product with the values, ``gl.segment_sum`` and the output layout,
    added to out in the head mode."""
    dev = x.device
    seg = torch.repeat_interleave(
        torch.arange(csr.nseg, device=dev),
        (csr.off[1:] - csr.off[:-1]).long())
    g = csr.gather.long()
    if zeta is None:
        y = x[g]
    else:
        mats, y = csr.mats.long(), None
        for i in range(x.shape[0]):
            zc = zeta[i][mats]                                 # (nnz, 3)
            term = rq.ntt_scalar_mul(x[i][g], tuple(zc[:, c]
                                                    for c in range(3)))
            y = term if y is None else gl.add(y, term)
    prod = (gl.mul(csr.vals[:, None], y) if csr.vals.dim() == 1
            else rq.ntt_mul(csr.vals, y))
    s = gl.segment_sum(prod, seg, csr.nseg).reshape(-1, csr.per, 24)
    if t_layout:
        s = s.transpose(1, 2)
    s = s.reshape(out.shape)
    return out.copy_(s if zeta is None else gl.add(out, s))


def coo_matvec(csr, x, out, t_layout, zeta=None):
    """out <- the segment sums of `csr` (``csrc/coo.cu`` states them), laid
    out (blk, per, 24) or with `t_layout` (blk, 24, per) (a leading blk of
    1 may be left out).  x: the rows the entries gather, (rows, 24); or,
    in the head mode, with zeta (nwit, t, 3), the witnesses (nwit, rows,
    24) of the challenged z, and out <- out + the sums.  All contiguous;
    returns out."""
    shape = coo_out_shape(csr, t_layout)
    if tuple(out.shape) != shape and not (shape[0] == 1 and
                                          tuple(out.shape) == shape[1:]):
        raise ValueError(f"out: shape {tuple(out.shape)}, expected {shape}")
    _check("out", out, tuple(out.shape))
    nwit = 1
    if zeta is None:
        _check("x", x, (x.shape[0], 24))
    else:
        nwit = x.shape[0]
        _check("x", x, (nwit, x.shape[1], 24))
        _check("zeta", zeta, (nwit, zeta.shape[1], 3))
    if x.shape[-2] < csr.rows_in:
        raise ValueError(f"x: {x.shape[-2]} rows, the entries read "
                         f"{csr.rows_in}")
    tensors = (x, out, csr.off) + (() if zeta is None else (zeta,))
    if _route(tensors) == "cpu":
        return coo_matvec_twin(csr, x, out, t_layout, zeta)
    ring = csr.vals.dim() == 2
    _launch("lt_coo_matvec", _ptr(csr.off), _ptr(csr.gather),
            _ptr(csr.mats), _ptr(csr.vals), _ptr(csr.by_size),
            csr.n_heavy(nwit), csr.sizes.size, csr.nseg, csr.per, _ptr(x),
            x.shape[-2], None if zeta is None else _ptr(zeta), nwit,
            1 if zeta is None else zeta.shape[1], int(ring), int(t_layout),
            _ptr(out), _stream())
    coo_matvec.launches += 1
    return out


coo_matvec.launches = 0


class Engine:
    """The CCS on one device plus the tensor primitives built on it."""

    def __init__(self, ccs, device):
        self.ccs = ccs
        self.device = torch.device(device)
        rows, cols, mats, vals, scalar = _coo_host(ccs)
        self.scalar = scalar
        self.max_row = int(rows.max()) if rows.size else 0
        # the lin stack's rows: the rows the matrices reach, a power of two
        self.cap_pow2 = min(1 << self.max_row.bit_length(), ccs.m)
        t, n, m, cap = ccs.t, ccs.n, ccs.m, self.cap_pow2
        brev_cap = tables.brev_host(cap).numpy()
        brev_m = tables.brev_host(m).numpy()
        self.csr_mz = build_csr(mats * cap + brev_cap[rows], cols, mats, vals,
                                t * cap, cap, self.device)
        self.csr_mt = build_csr(mats * n + cols, rows, mats, vals, t * n, n,
                                self.device)
        self.csr_head = build_csr(brev_m[rows], cols, mats, vals, m, m,
                                  self.device)

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

    # -- COO matvecs -----------------------------------------------------
    def mz_stack(self, z, out=None):
        """All t products M_j z (z (n, 24)) -> (t, 24, cap_pow2) in the
        t-layout: row i of M_j z at column bitrev(i); into `out` where
        given."""
        if out is None:
            out = torch.empty(coo_out_shape(self.csr_mz, True),
                              dtype=gl.DTYPE, device=self.device)
        return coo_matvec(self.csr_mz, z, out, True)

    def mt_eq_stack(self, eq):
        """All t products M_j^T eq -> (t, n, 24) for an eq table (>= cap
        rows, (rows, 24))."""
        out = torch.empty(coo_out_shape(self.csr_mt, False), dtype=gl.DTYPE,
                          device=self.device)
        return coo_matvec(self.csr_mt, eq, out, False)

    def mz_challenged(self, zs, zeta, out):
        """out (24, m) += sum_j M_j (sum_i zeta[i, j] * zs[i]) in the
        t-layout, bit-reversed rows: zs (nwit, n, 24), zeta (nwit, t, 3)."""
        return coo_matvec(self.csr_head, zs, out, True, zeta)

    def eq_table(self, point, max_rows, t_layout=False, out=None):
        """eq(point, x) over the hypercube, variable 0 = least significant
        index bit, as (rows, 24) with rows = 2^ceil(log2(min(2^nv, max_rows))),
        or (24, rows) in the bit-reversed t-layout; into `out` where given.
        Skipped top variables fold their prod(1 - r_j) into every row
        (``tables.eq_table``, a kernel on the card)."""
        return tables.eq_table(point, max_rows, self.device, t_layout, out)
