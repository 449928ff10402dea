"""Balanced base-b decomposition (digits in [-b/2, b/2]) for power-of-two b.

Counterpart of ``latticeum_tpu/ring/decompose.py``: the field value maps to
its signed representative in [-(q-1)/2, (q-1)/2], then digits are peeled
with r = |v| mod b; r <= b/2 gives digit sign*r, else sign*(r - b) and a
carry of one into |v| >> log2(b).  The magnitude is below 2^63, so it is a
non-negative int64 and arithmetic shifts are exact.  What is left after
the last digit is dropped.

On a card the digits are one launch of ``balanced_digits`` and the Horner
recomposition one launch of ``digit_recompose`` (``csrc/decompose.cu``;
counterparts of ``latticeum_tpu/ring/decompose.py:49`` and ``:77``),
counted in ``decompose_balanced.launches`` and ``recompose.launches``;
each kernel writes or reads the layout its caller needs (digits last, the
gadget rows, the k vectors) with no copy.  On the CPU the plain-torch
twins ``decompose_balanced_twin`` and ``recompose_twin`` run.  Any other
device raises; there is no fallback.
"""

from __future__ import annotations

import math

import torch

from ..field import goldilocks as gl
from ..kernels import counted as _counted, launch as _launch, \
    ptr as _ptr, route as _route, stream as _stream

_Q_HALF = (gl.P - 1) // 2
_MAX_LOG_B = 62                   # b - r and b itself stay int64


def decompose_balanced_twin(x, b: int, num_digits: int):
    """Plain torch of decompose_balanced."""
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


def recompose_twin(digits, b: int, dim: int = -1):
    """Plain torch of recompose."""
    d = torch.movedim(digits, dim, 0)
    bb = torch.full_like(d[0], b)
    acc = d[-1]
    for j in range(d.shape[0] - 2, -1, -1):
        acc = gl.add(gl.mul(acc, bb), d[j])
    return acc


def _check(name, x, b, count):
    if x.dtype != gl.DTYPE:
        raise TypeError(f"{name}: dtype {x.dtype}, expected int64")
    if b < 2 or b & (b - 1) or b.bit_length() - 1 > _MAX_LOG_B:
        raise ValueError(f"{name}: basis {b} must be a power of two in "
                         f"[2, 2^{_MAX_LOG_B}]")
    if count < 1:
        raise ValueError(f"{name}: {count} digits, expected >= 1")


def _digits(x, b, num_digits, out_shape, cols, row_stride, digit_stride):
    """One launch of balanced_digits: element e of x at out + (e // cols)
    row_stride + digit digit_stride + e % cols."""
    x = x.contiguous()
    out = torch.empty(out_shape, dtype=gl.DTYPE, device=x.device)
    if x.numel():
        _launch("lt_balanced_digits", _ptr(x), _ptr(out), x.numel(), cols,
                row_stride, digit_stride, b.bit_length() - 1, num_digits,
                _stream())
        decompose_balanced.launches += 1
    return out


def _recompose(d, b, num_digits, out_shape, cols, row_stride, digit_stride):
    """One launch of digit_recompose: output e from the digits at d +
    (e // cols) row_stride + j digit_stride + e % cols."""
    d = d.contiguous()
    out = torch.empty(out_shape, dtype=gl.DTYPE, device=d.device)
    if out.numel():
        _launch("lt_digit_recompose", _ptr(d), _ptr(out), out.numel(), cols,
                row_stride, digit_stride, b, num_digits, _stream())
        recompose.launches += 1
    return out


def decompose_balanced(x, b: int, num_digits: int):
    """x (...) field elements -> digits (..., num_digits) field elements."""
    _check("decompose_balanced", x, b, num_digits)
    if _route((x,)) == "cpu":
        return decompose_balanced_twin(x, b, num_digits)
    return _digits(x, b, num_digits, tuple(x.shape) + (num_digits,), 1,
                   num_digits, 1)


def recompose(digits, b: int, dim: int = -1):
    """Horner recompose along `dim`: sum_j digits[j] * b^j mod p."""
    if digits.dim() == 0:
        raise ValueError("recompose: digits must have a digit axis")
    dim %= digits.dim()
    num_digits = digits.shape[dim]
    _check("recompose", digits, b, num_digits)
    if _route((digits,)) == "cpu":
        return recompose_twin(digits, b, dim)
    after = math.prod(digits.shape[dim + 1:])
    out_shape = digits.shape[:dim] + digits.shape[dim + 1:]
    return _recompose(digits, b, num_digits, out_shape, max(after, 1),
                      num_digits * after, after)


def gadget_decompose(w, b: int, L: int):
    """(..., n, 24) coefficient form -> (..., n*L, 24); rows [i*L, i*L+L)
    are the L digit polynomials of w[i]."""
    _check("gadget_decompose", w, b, L)
    if w.dim() < 2:
        raise ValueError(f"gadget_decompose: shape {tuple(w.shape)}, "
                         "expected (..., n, width)")
    width = w.shape[-1]
    out_shape = w.shape[:-2] + (w.shape[-2] * L, width)
    if _route((w,)) == "cpu":
        d = torch.movedim(decompose_balanced_twin(w, b, L), -1, -2)
        return d.reshape(out_shape)
    return _digits(w, b, L, out_shape, max(width, 1), L * width, width)


def gadget_recompose(f, b: int, L: int):
    """Inverse of gadget_decompose: (..., n*L, 24) -> (..., n, 24)."""
    _check("gadget_recompose", f, b, L)
    if f.dim() < 2 or f.shape[-2] % L:
        raise ValueError(f"gadget_recompose: shape {tuple(f.shape)}, "
                         f"expected (..., n*{L}, width)")
    n = f.shape[-2] // L
    return recompose(f.reshape(f.shape[:-2] + (n, L, f.shape[-1])), b, dim=-2)


def decompose_vec_into_k_vecs(w, b: int, K: int):
    """(..., n, 24) -> (K, ..., n, 24): output[k][i] is digit k of w[i]."""
    _check("decompose_vec_into_k_vecs", w, b, K)
    if _route((w,)) == "cpu":
        return torch.movedim(decompose_balanced_twin(w, b, K), -1, 0)
    size = w.numel()
    return _digits(w, b, K, (K,) + tuple(w.shape), max(size, 1), 0, size)


KERNELS = (_counted(decompose_balanced, "lt_balanced_digits"),
           _counted(recompose, "lt_digit_recompose"))


def reset_launches():
    for k in KERNELS:
        k.launches = 0


reset_launches()
