"""Batched ring inner products as int8 digit-plane matrix products.

Counterpart of ``latticeum_tpu/field/mxu.py``.  The evaluation claims and
the general Ajtai commitment contract RqNTT vectors:

    out[j, k] = sum_n A[j, n] * B[k, n]        (slot-wise Fq3 products)

Every u64 field value is split into 9 balanced base-256 digits (8 int8
digits and a {0, 1} carry plane), so the contraction over n becomes one
int8 x int8 -> int32 matrix product per NTT slot:

    C[s, (j, i, dA), (k, i', dB)] = sum_n digit_dA(A[j, n, s, i])
                                          * digit_dB(B[k, n, s, i'])

with i, i' the Fq3 components.  |digit| <= 128, so each int32 sum of at
most CHUNK_N = 2^16 products is exact; longer contractions run in chunks.
The Fq3 product structure and the digit weights 2^{8(dA+dB)} are applied
after the product, on the small (t, kb) output.

Three steps, each a function here:
  * ``digit_split`` (CUDA kernel ``csrc/mxu.cu::digit_split_kernel``, replaces
    the XLA ``digit_planes`` of latticeum_tpu/field/mxu.py:45 and the plane
    layout of its ``ring_contract``): u64 values in the standard layout
    (rows, n, 24) or the t-layout (rows, 24, n) -> int8 planes, chunk by
    chunk, each chunk an (8, rows_pad, width) block with plane row
    (3 j + i) 9 + d, zero in every padding row and column;
  * ``torch._int_mm`` per slot and chunk (the JAX package leaves this
    product to ``jax.lax.dot_general``);
  * ``plane_recombine`` (kernel ``plane_recombine_kernel``, replaces the
    XLA ``_recombine`` of mxu.py:91): one chunk's int32 products ->
    (t, kb, 24) field elements, added to the sums of the earlier chunks.

Each kernel has its plain-torch twin here, which follows the JAX package
(digit chain, (9, 9) plane weights).  A wrapper given CPU tensors runs the
twin; given CUDA tensors it launches the kernel (and counts the launch) or
raises.  There is no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import (check as _check, counted as _counted,
                       launch as _launch, ptr as _ptr, route as _route,
                       stream as _stream)
from . import goldilocks as gl

P = gl.P
W_NONRESIDUE = 1 << 40
NPLANES = 9          # 8 balanced base-256 digits + 1 carry plane
CHUNK_N = 1 << 16    # contraction chunk: 2^16 products of |d| <= 2^7 < 2^31
COL_ALIGN = 16       # padded columns: a multiple of this (the GEMM's depth)
ROW_ALIGN = 8        # padded plane rows: a multiple of this (the GEMM's N)
# (i, i', output component, nonresidue applies) of the Fq3 product
# (fq3.mul / goldilocks/mod.rs:29-54):
#   c0 = a0b0 + W(a1b2 + a2b1), c1 = a0b1 + a1b0 + W a2b2,
#   c2 = a0b2 + a1b1 + a2b0
FQ3_TERMS = ((0, 0, 0, False), (1, 2, 0, True), (2, 1, 0, True),
             (0, 1, 1, False), (1, 0, 1, False), (2, 2, 1, True),
             (0, 2, 2, False), (1, 1, 2, False), (2, 0, 2, False))


def _round_up(x, m):
    return -(-x // m) * m


@dataclass
class Planes:
    """Digit planes of `rows` ring vectors of length `n`: a flat int8 buffer
    of chunks; chunk c covers columns [c chunk, c chunk + width) and holds
    an (8, rows_pad, width) block (slot, plane row, column)."""
    data: torch.Tensor
    rows: int
    n: int
    rows_pad: int
    n_pad: int
    chunk: int

    def chunks(self):
        """The (8, rows_pad, width) block of every chunk, in order."""
        for c0 in range(0, self.n_pad, self.chunk):
            width = min(self.chunk, self.n_pad - c0)
            start = 8 * self.rows_pad * c0
            yield self.data[start:start + 8 * self.rows_pad * width].view(
                8, self.rows_pad, width)


def plane_shape(rows, n):
    """(rows_pad, n_pad, chunk) of the planes of `rows` vectors of length n:
    plane rows up to a multiple of ROW_ALIGN (the GEMM takes M > 16 and N a
    multiple of 8), columns up to a multiple of COL_ALIGN."""
    n_pad = _round_up(n, COL_ALIGN)
    return (_round_up(rows * 3 * NPLANES, ROW_ALIGN), n_pad,
            min(CHUNK_N, n_pad))


# -- plain-torch twins ---------------------------------------------------------

def digit_planes(x):
    """u64 values (int64 bits), any shape S -> int8 digits, shape S + (9,).

    Balanced base-256: value = sum_{i<8} d_i 256^i + d_8 2^64 with
    d_i in [-128, 127] and d_8 in {0, 1}.  `>>` on int64 is arithmetic, so
    every byte is masked after its shift."""
    digits = []
    carry = torch.zeros_like(x)
    for i in range(8):
        d = ((x >> (8 * i)) & 0xFF) + carry
        carry = (d > 127).to(x.dtype)
        digits.append((d - 256 * carry).to(torch.int8))
    digits.append(carry.to(torch.int8))
    return torch.stack(digits, dim=-1)


def digit_split_twin(x, t_layout=False):
    rows = x.shape[0]
    n = x.shape[-1] if t_layout else x.shape[1]
    rows_pad, n_pad, chunk = plane_shape(rows, n)
    v = (x.reshape(rows, 8, 3, n) if t_layout
         else x.reshape(rows, n, 8, 3).permute(0, 2, 3, 1))   # (rows, 8, 3, n)
    d = digit_planes(v).permute(1, 0, 2, 4, 3).reshape(8, rows * 27, n)
    full = torch.zeros((8, rows_pad, n_pad), dtype=torch.int8,
                       device=x.device)
    full[:, :rows * 27, :n] = d
    data = torch.cat([full[:, :, c0:c0 + chunk].reshape(-1)
                      for c0 in range(0, n_pad, chunk)])
    return Planes(data, rows, n, rows_pad, n_pad, chunk)


def _weights(scale, device):
    """(9, 9) plane weights scale * 2^{8(dA+dB)} mod p."""
    return gl.from_int([[pow(2, 8 * (a + b), P) * scale % P
                         for b in range(NPLANES)] for a in range(NPLANES)],
                       device)


def _int32_to_field(v):
    """Signed integers (|v| < 2^63) -> canonical field elements."""
    v = v.to(gl.DTYPE)
    return torch.where(v < 0, gl.neg(-v), v)


def plane_recombine_twin(O, out):
    """Add one chunk's plane products O (8, ra, rb) int32 into out
    (t, kb, 24); returns out."""
    t, kb = out.shape[0], out.shape[1]
    blk = O[:, :t * 27, :kb * 27].reshape(8, t, 3, NPLANES, kb, 3, NPLANES)
    wts = {False: _weights(1, O.device),
           True: _weights(W_NONRESIDUE, O.device)}
    comps = [None, None, None]
    for i, i2, comp, w in FQ3_TERMS:
        g = _int32_to_field(blk[:, :, i, :, :, i2, :])     # (8, t, 9, kb, 9)
        term = gl.mul(g, wts[w][:, None, :])
        s = gl.sum_axis(term.permute(0, 1, 3, 2, 4).reshape(8, t, kb, -1), -1)
        comps[comp] = s if comps[comp] is None else gl.add(comps[comp], s)
    part = torch.stack(comps, dim=-1).permute(1, 2, 0, 3).reshape(t, kb, 24)
    out.copy_(gl.add(out, part))
    return out


# -- wrappers ------------------------------------------------------------------

def digit_split(x, t_layout=False):
    """(rows, n, 24), or (rows, 24, n) with t_layout, int64 -> Planes."""
    if x.dim() != 3 or x.shape[-2 if t_layout else -1] != 24:
        raise ValueError(f"digit_split: shape {tuple(x.shape)}, expected "
                         + ("(rows, 24, n)" if t_layout else "(rows, n, 24)"))
    _check("x", x, tuple(x.shape))
    if _route((x,)) == "cpu":
        return digit_split_twin(x, t_layout)
    rows = x.shape[0]
    n = x.shape[-1] if t_layout else x.shape[1]
    rows_pad, n_pad, chunk = plane_shape(rows, n)
    if rows >= 65535 or -(-n_pad // chunk) > 65535 or rows_pad * chunk >= 2**31:
        raise ValueError(f"digit_split: {rows} rows of {n}, more than the "
                         "kernel's grid and 32-bit offsets hold")
    data = torch.empty(8 * rows_pad * n_pad, dtype=torch.int8,
                       device=x.device)
    s_row, s_col, s_pos = ((24 * n, 1, n) if t_layout else (24 * n, 24, 1))
    _launch("lt_digit_split", _ptr(x), _ptr(data), rows, n, s_row, s_col,
            s_pos, rows_pad, n_pad, chunk, _stream())
    digit_split.launches += 1
    return Planes(data, rows, n, rows_pad, n_pad, chunk)


def plane_recombine(O, out):
    """out (t, kb, 24) += the field values of one chunk's plane products
    O (8, ra, rb) int32; returns out."""
    t, kb = out.shape[0], out.shape[1]
    if O.dim() != 3 or O.shape[0] != 8 or O.shape[1] < t * 27 \
            or O.shape[2] < kb * 27 or O.dtype != torch.int32 \
            or not O.is_contiguous():
        raise ValueError(f"plane_recombine: O {tuple(O.shape)} {O.dtype}, "
                         f"expected contiguous int32 (8, >= {t * 27}, "
                         f">= {kb * 27})")
    _check("out", out, (t, kb, 24))
    if _route((O, out)) == "cpu":
        return plane_recombine_twin(O, out)
    _launch("lt_plane_recombine", _ptr(O), _ptr(out), t, kb, O.shape[1],
            O.shape[2], _stream())
    plane_recombine.launches += 1
    return out


def contract(pa: Planes, pb: Planes):
    """(t, kb, 24) out[j, k] = sum_n A[j, n] * B[k, n] from the planes of
    A (t vectors) and B (kb vectors): per chunk one int8 product per slot,
    then its recombination."""
    if (pa.n, pa.chunk) != (pb.n, pb.chunk):
        raise ValueError(f"planes of length {pa.n} (chunk {pa.chunk}) and "
                         f"{pb.n} (chunk {pb.chunk})")
    dev = pa.data.device
    out = torch.zeros((pa.rows, pb.rows, 24), dtype=gl.DTYPE, device=dev)
    O = torch.empty((8, pa.rows_pad, pb.rows_pad), dtype=torch.int32,
                    device=dev)
    for la, lb in zip(pa.chunks(), pb.chunks()):
        for s in range(8):
            # lb[s].t(): the second operand as a column-major view, no copy
            torch._int_mm(la[s], lb[s].t(), out=O[s])
        plane_recombine(O, out)
    return out


def contract_gemms(pb: Planes):
    """The ``torch._int_mm`` launches ``contract(pa, pb)`` makes: one a
    slot a chunk."""
    return 8 * -(-pb.n_pad // pb.chunk)


def ring_contract(A, B, t_layout=False):
    """Batched ring inner products: A (t, n, 24) and B (kb, n, 24), or both
    (t, 24, n) and (kb, 24, n) with t_layout -> (t, kb, 24) with
    out[j, k] = sum_n A[j, n] * B[k, n]."""
    ring_contract.calls += 1
    return contract(digit_split(A.contiguous(), t_layout),
                    digit_split(B.contiguous(), t_layout))


KERNELS = (_counted(digit_split, "lt_digit_split"),
           _counted(plane_recombine, "lt_plane_recombine"))


def reset_launches():
    for w in KERNELS:
        w.launches = 0
    ring_contract.calls = 0


reset_launches()
