"""Balanced base-b decomposition (digits in [-b/2, b/2]) for power-of-two b.

Counterpart of ``latticeum_tpu/ring/decompose.py``: the field value maps to
its signed representative in [-(q-1)/2, (q-1)/2], then digits are peeled
with r = |v| mod b; r <= b/2 gives digit sign*r, else sign*(r - b) and a
carry of one into |v| >> log2(b).  The magnitude is below 2^63, so it is a
non-negative int64 and arithmetic shifts are exact.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl

_Q_HALF = (gl.P - 1) // 2


def decompose_balanced(x, b: int, num_digits: int):
    """x (...) field elements -> digits (..., num_digits) field elements."""
    if b < 2 or b & (b - 1):
        raise ValueError(f"basis {b} must be a power of two >= 2")
    k = b.bit_length() - 1
    half = b // 2
    is_neg = gl._ult(torch.full_like(x, _Q_HALF), x)
    mag = torch.where(is_neg, gl.neg(x), x)
    digits = []
    for _ in range(num_digits):
        r = mag & (b - 1)
        big = r > half
        dmag = torch.where(big, b - r, r)
        mag = (mag >> k) + big.to(mag.dtype)
        digits.append(torch.where(is_neg ^ big, gl.neg(dmag), dmag))
    return torch.stack(digits, dim=-1)


def recompose(digits, b: int, dim: int = -1):
    """Horner recompose along `dim`: sum_j digits[j] * b^j mod p."""
    d = torch.movedim(digits, dim, 0)
    bb = torch.full_like(d[0], b)
    acc = d[-1]
    for j in range(d.shape[0] - 2, -1, -1):
        acc = gl.add(gl.mul(acc, bb), d[j])
    return acc


def gadget_decompose(w, b: int, L: int):
    """(..., n, 24) coefficient form -> (..., n*L, 24); rows [i*L, i*L+L)
    are the L digit polynomials of w[i]."""
    d = torch.movedim(decompose_balanced(w, b, L), -1, -2)   # (..., n, L, 24)
    return d.reshape(d.shape[:-3] + (d.shape[-3] * L, d.shape[-1]))


def gadget_recompose(f, b: int, L: int):
    """Inverse of gadget_decompose: (..., n*L, 24) -> (..., n, 24)."""
    n = f.shape[-2] // L
    return recompose(f.reshape(f.shape[:-2] + (n, L, f.shape[-1])), b, dim=-2)


def decompose_vec_into_k_vecs(w, b: int, K: int):
    """(..., n, 24) -> (K, ..., n, 24): output[k][i] is digit k of w[i]."""
    return torch.movedim(decompose_balanced(w, b, K), -1, 0)
