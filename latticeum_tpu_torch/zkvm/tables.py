"""The fold step's eq tables and the fold head's alpha-pass, each a CUDA
kernel of ``csrc/tables.cu`` with its plain-torch twin here.

  * ``eq_table`` (kernel ``eq_table_kernel``, replaces the XLA
    ``DeviceEngine.eq_table`` of latticeum_tpu/zkvm/accel.py:141):
    eq(point, x) over rows = 2^n_dbl hypercube rows, n_dbl =
    ceil(log2(min(2^len(point), max_rows))), variable 0 the least
    significant index bit; the skipped top variables fold their
    prod(1 - r_j) into every row.  Each row is an Fq3 value replicated
    over the 8 NTT slots.  Written in the standard layout (rows, 24) or
    in the bit-reversed t-layout (24, rows): column j holds row
    bitrev(j).
  * ``head_alpha`` (kernel ``head_alpha_kernel``, replaces the alpha-pass
    of the XLA ``DeviceNifs._build_head``, latticeum_tpu/zkvm/
    accel_nifs.py:997): for the t-layout f_hat tail (2 half, 24, m) and
    the alpha powers (2 half, 3),
        c1 = sum_{idx < half} alpha[idx] * tail[idx],
        c2 = sum_{idx >= half} alpha[idx] * tail[idx]
    slot by slot, each (24, m), written into the caller's tensors (the
    fold head's rows 1 and 3).

A wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel (and counts the launch) or raises.  There is no fallback.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import fq3, goldilocks as gl
from ..host.field import host as H
from ..kernels import (check as _check, launch as _launch, ptr as _ptr,
                       route as _route, stream as _stream)
from ..ring import rq


# copied from latticeum_tpu/zkvm/accel_t.py:24
def bitrev_indices(n_bits: int) -> np.ndarray:
    n = 1 << n_bits
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(n_bits):
        out |= ((idx >> b) & 1) << (n_bits - 1 - b)
    return out


@functools.lru_cache(maxsize=None)
def brev_host(n):
    """Bit-reversal permutation of range(n), n a power of two: one host
    tensor per size, shared by every caller (read it, never write it)."""
    return torch.from_numpy(bitrev_indices((n - 1).bit_length() if n > 1
                                           else 0))


def brev_on(n, device):
    """``brev_host(n)`` on `device`; to a card a pinned, non-blocking copy
    that lives as long as its user (no device memory is held between
    calls)."""
    return gl.upload(brev_host(n), device)


def eq_shape(point, max_rows):
    """(n_dbl, tail): the doublings of the table and the Fq3 product of
    (1 - r) over the skipped top variables."""
    rows = 1 << len(point)
    if max_rows is not None:
        rows = min(rows, max_rows)
    n_dbl = (rows - 1).bit_length() if rows > 1 else 0
    tail = (1, 0, 0)
    for r in point[n_dbl:]:
        tail = H.fq3_mul(tail, H.fq3_sub((1, 0, 0), r))
    return n_dbl, tail


def eq_factors(point, max_rows, t_layout):
    """The kernel's factor table (1 + 2 n_dbl, 3) on the host: row 0 the
    tail, row 1 + 2k + b the factor of index bit k at value b, for the
    variable that bit k stands for in the layout."""
    n_dbl, tail = eq_shape(point, max_rows)
    rows = [tail]
    for k in range(n_dbl):
        r = point[n_dbl - 1 - k if t_layout else k]
        rows += [H.fq3_sub((1, 0, 0), r), r]
    return gl.from_int(rows), n_dbl


# -- plain-torch twins ---------------------------------------------------------

def eq_table_twin(point, max_rows, device, t_layout=False):
    """The doubling of ``Engine.eq_table`` as the port first ran it: per
    variable, low = cur * (1 - r_i), high = cur * r_i, concatenated; the
    t-layout is its transpose gathered in bit-reversed order."""
    n_dbl, tail = eq_shape(point, max_rows)
    cur = gl.from_int([H.ntt_from_fq3(tail)], device)
    for r in point[:n_dbl]:
        low = rq.ntt_scalar_mul(
            cur, fq3.const(H.fq3_sub((1, 0, 0), r), device))
        high = rq.ntt_scalar_mul(cur, fq3.const(r, device))
        cur = torch.cat([low, high])
    if t_layout:
        return cur.T[:, brev_on(cur.shape[0], cur.device)]
    return cur


def head_alpha_twin(tail, alpha, c1, c2):
    """The alpha-sums of ``TorchNifs._build_head`` as the port first ran
    them: per half, accumulated ``ntt_scalar_mul_t`` of each tail row."""
    half = tail.shape[0] // 2
    for out, lo in ((c1, 0), (c2, half)):
        acc = None
        for idx in range(lo, lo + half):
            term = rq.ntt_scalar_mul_t(
                tail[idx], tuple(alpha[idx, c] for c in range(3)))
            acc = term if acc is None else gl.add(acc, term)
        out.copy_(acc)
    return c1, c2


# -- wrappers ------------------------------------------------------------------

def eq_table(point, max_rows, device, t_layout=False, out=None):
    """eq(point, x) on `device` as (rows, 24), or (24, rows) bit-reversed
    with `t_layout`; written into `out` where given (contiguous, that
    shape, on `device`).  On a card the factors go up in one pinned,
    non-blocking copy."""
    n_dbl, _ = eq_shape(point, max_rows)
    shape = eq_out_shape(n_dbl, t_layout)
    if out is None:
        out = torch.empty(shape, dtype=gl.DTYPE, device=device)
    if _route((out,)) == "cpu":
        _check("out", out, shape)
        return out.copy_(eq_table_twin(point, max_rows, out.device, t_layout))
    f_host, _ = eq_factors(point, max_rows, t_layout)
    return eq_table_launch(gl.upload(f_host, out.device), n_dbl, t_layout,
                           out)


def eq_out_shape(n_dbl, t_layout):
    rows = 1 << n_dbl
    return (24, rows) if t_layout else (rows, 24)


def eq_table_launch(f, n_dbl, t_layout, out):
    """The kernel alone, on factors `f` (1 + 2 n_dbl, 3) already on the
    card (``eq_factors``); returns `out`."""
    _check("f", f, (1 + 2 * n_dbl, 3))
    _check("out", out, eq_out_shape(n_dbl, t_layout))
    if _route((f, out)) != "cuda":
        raise ValueError("eq_table_launch: tensors not on a CUDA device")
    _launch("lt_eq_table", _ptr(f), _ptr(out), n_dbl, int(t_layout),
            _stream())
    eq_table.launches += 1
    return out


def head_alpha(tail, alpha, c1, c2):
    """c1, c2 (24, m) <- the alpha-sums of the two halves of the t-layout
    tail (2 half, 24, m) with alpha (2 half, 3); returns (c1, c2)."""
    rows, _, m = tail.shape
    if rows % 2 or rows < 2:
        raise ValueError(f"head_alpha: {rows} tail rows, expected an even "
                         "number")
    _check("tail", tail, (rows, 24, m))
    _check("alpha", alpha, (rows, 3))
    _check("c1", c1, (24, m))
    _check("c2", c2, (24, m))
    if _route((tail, alpha, c1, c2)) == "cpu":
        return head_alpha_twin(tail, alpha, c1, c2)
    _launch("lt_head_alpha", _ptr(tail), _ptr(alpha), _ptr(c1), _ptr(c2),
            rows // 2, m, _stream())
    head_alpha.launches += 1
    return c1, c2


KERNELS = (eq_table, head_alpha)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


reset_launches()
