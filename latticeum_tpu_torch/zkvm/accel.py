"""Device engine: the CCS on the device, boundary transfers, COO matvecs and
eq tables.

Counterpart of ``latticeum_tpu/zkvm/accel.py::DeviceEngine``.  PyTorch runs
eagerly, so there is no jit cache, compile cache or host tail threshold:
every function is a plain sequence of tensor ops on ``self.device``.

All t CCS matrices are held as ONE COO (matrix id per entry), sorted once,
at construction, by the output segment of each of the three segment maps
the fold step uses (``Csr``): M z into the lin stack's bit-reversed rows,
M^T eq by column, and the fold head's challenged z into bit-reversed rows
of all matrices at once.  Each Mz stack or M^T eq stack is then one
``coo_matvec``: on a card one launch of ``coo_kernel`` (``csrc/coo.cu``,
counted in ``coo_matvec.launches``; counterpart of the XLA
``DeviceEngine.matvecs``, :117, and of ``accel_nifs.py``'s ``lin_g_t``,
:437, and ``eqT``, :634).  Both c rows of a fold head's challenged-z
combination are one ``coo_head``: on a card one launch of
``coo_head_kernel`` (counted in ``coo_head.launches``; counterpart of the
COO part of ``_build_head``, :997).  On the CPU each runs the plain-torch
twin ``coo_matvec_twin``: one gather, one product and one exact segment
sum (``goldilocks.segment_sum``), once per c row in the head.  Any other
device raises; there is no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import goldilocks as gl
from ..kernels import (check as _check, counted as _counted,
                       launch as _launch, ptr as _ptr, route as _route,
                       stream as _stream)
from ..ring import rq
from . import tables

COO_LIGHT = 64   # csrc/coo.cu: most entries of a light segment


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
    mats[e] < mats_in with value vals[e], gather[e] < rows_in.  ``full``:
    the non-empty segments, with their entry counts ``sizes`` on the host:
    for coo_kernel most entries first (its heavy segments a prefix), or,
    built with ``head``, in position order, with their first entries and
    then nnz in ``nz_off`` (coo_head_kernel's blocks and runs are cut by
    them).  Only a map built with ``head`` holds ``mats`` and ``nz_off``
    on the device: coo_kernel reads neither."""
    nseg: int
    per: int
    rows_in: int
    mats_in: int
    off: torch.Tensor        # (nseg + 1,) int32
    gather: torch.Tensor     # (nnz,) int32
    mats: torch.Tensor | None    # (nnz,) int32, with head
    vals: torch.Tensor       # (nnz,) or (nnz, 24) int64
    full: torch.Tensor       # (non-empty,) int32
    sizes: np.ndarray        # (non-empty,) int64
    nz_off: torch.Tensor | None  # (non-empty + 1,) int32, with head

    def n_heavy(self):
        """The segments with more than COO_LIGHT entries."""
        return int(np.count_nonzero(self.sizes > COO_LIGHT))


def build_csr(seg, gather, mats, vals, nseg, per, device, head=False):
    """The Csr of entries with output segments `seg` (host arrays), for
    coo_head with `head`, else for coo_matvec."""
    if nseg % per:
        raise ValueError(f"{nseg} segments are not blocks of {per}")
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=nseg)
    if counts.shape[0] != nseg:
        raise ValueError(f"a segment index is not below {nseg}")
    off = np.zeros(nseg + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    full = np.flatnonzero(counts)
    if not head:
        full = full[np.argsort(-counts[full], kind="stable")]

    def i32(a):
        return gl.upload(torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.int32)), device)
    rows_in = int(gather.max()) + 1 if gather.size else 0
    mats_in = int(mats.max()) + 1 if mats.size else 0
    return Csr(nseg, per, rows_in, mats_in, i32(off), i32(gather[order]),
               i32(mats[order]) if head else None,
               gl.upload(torch.from_numpy(gl.to_i64_bits(vals[order])),
                         device),
               i32(full), counts[full],
               i32(np.append(off[full], off[-1])) if head else None)


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


def coo_matvec(csr, x, out, t_layout):
    """out <- the segment sums of `csr` (``csrc/coo.cu`` states them), laid
    out (blk, per, 24) or with `t_layout` (blk, 24, per) (a leading blk of
    1 may be left out).  x: the rows the entries gather, (rows, 24).  All
    contiguous; returns out."""
    shape = coo_out_shape(csr, t_layout)
    if tuple(out.shape) != shape and not (shape[0] == 1 and
                                          tuple(out.shape) == shape[1:]):
        raise ValueError(f"out: shape {tuple(out.shape)}, expected {shape}")
    _check("out", out, tuple(out.shape))
    _check("x", x, (x.shape[0], 24))
    if csr.nz_off is not None:
        raise ValueError("a Csr built for coo_head")
    if x.shape[0] < csr.rows_in:
        raise ValueError(f"x: {x.shape[0]} rows, the entries read "
                         f"{csr.rows_in}")
    if _route((x, out, csr.off)) == "cpu":
        return coo_matvec_twin(csr, x, out, t_layout)
    _launch("lt_coo_matvec", _ptr(csr.off), _ptr(csr.gather),
            _ptr(csr.vals), _ptr(csr.full), csr.n_heavy(),
            csr.sizes.size, csr.nseg, csr.per, _ptr(x),
            int(csr.vals.dim() == 2), int(t_layout), _ptr(out), _stream())
    coo_matvec.launches += 1
    return out


coo_matvec.launches = 0
_counted(coo_matvec, "lt_coo_matvec")


def coo_head_twin(csr, zs, zeta, outs):
    """coo_head as the port first ran it: ``coo_matvec_twin`` in the head
    mode once per c row, over that row's witnesses."""
    k = zs.shape[0] // 2
    for r, out in enumerate(outs):
        coo_matvec_twin(csr, zs[r * k:(r + 1) * k], out, True,
                        zeta[r * k:(r + 1) * k])
    return outs


def coo_head(csr, zs, zeta, outs):
    """outs[r] (24, per) += sum_e vals[e] sum_{i < k} zeta[r k + i, mats[e]]
    * zs[r k + i, gather[e]] over the entries e of each segment, in the
    t-layout (``csrc/coo.cu`` states it): the fold head's challenged z,
    witness i of `zs` (2 k, rows, 24) and `zeta` (2 k, t, 3) into c row
    i // k of the two `outs`.  `csr` is built with ``head`` and is one
    block of segments (nseg == per).  All contiguous; returns outs."""
    if csr.nz_off is None or csr.nseg != csr.per:
        raise ValueError(f"a Csr of {csr.nseg} segments in blocks of "
                         f"{csr.per}: not one block built for coo_head")
    if len(outs) != 2 or zs.dim() != 3 or zs.shape[0] % 2 or \
            not zs.shape[0]:
        raise ValueError(f"{tuple(zs.shape)} witnesses for {len(outs)} "
                         "rows: two c rows of k witnesses each")
    _check("zs", zs, (zs.shape[0], zs.shape[1], 24))
    _check("zeta", zeta, (zs.shape[0], zeta.shape[1], 3))
    for out in outs:
        _check("out", out, (24, csr.per))
    if zs.shape[1] < csr.rows_in or zeta.shape[1] < csr.mats_in:
        raise ValueError(f"zs, zeta: {zs.shape[1]} rows, {zeta.shape[1]} "
                         f"matrices; the entries read {csr.rows_in}, "
                         f"{csr.mats_in}")
    if abs(outs[0].data_ptr() - outs[1].data_ptr()) < 8 * 24 * csr.per:
        raise ValueError("the two outputs overlap")
    if _route((zs, zeta, csr.off) + tuple(outs)) == "cpu":
        return coo_head_twin(csr, zs, zeta, outs)
    _launch("lt_coo_head", _ptr(csr.full), _ptr(csr.nz_off), csr.sizes.size,
            _ptr(csr.gather), _ptr(csr.mats), _ptr(csr.vals),
            int(csr.vals.dim() == 2), _ptr(zs), zs.shape[1], _ptr(zeta),
            zs.shape[0] // 2, zeta.shape[1], csr.per, _ptr(outs[0]),
            _ptr(outs[1]), _stream())
    coo_head.launches += 1
    return outs


coo_head.launches = 0
_counted(coo_head, "lt_coo_head")


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
                                  self.device, head=True)

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

    def mz_challenged(self, zs, zeta, outs):
        """outs[r] (24, m) += sum_j M_j (sum_i zeta[r k + i, j] * zs[r k +
        i]) in the t-layout, bit-reversed rows, for both c rows at once:
        zs (2 k, n, 24), zeta (2 k, t, 3)."""
        return coo_head(self.csr_head, zs, zeta, outs)

    def eq_table(self, point, max_rows, t_layout=False, out=None):
        """eq(point, x) over the hypercube, variable 0 = least significant
        index bit, as (rows, 24) with rows = 2^ceil(log2(min(2^nv, max_rows))),
        or (24, rows) in the bit-reversed t-layout; into `out` where given.
        Skipped top variables fold their prod(1 - r_j) into every row
        (``tables.eq_table``, a kernel on the card)."""
        return tables.eq_table(point, max_rows, self.device, t_layout, out)
