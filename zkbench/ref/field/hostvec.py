"""Vectorized host-side ring/Fq3 arithmetic (numpy uint32 limbs).

The protocol glue between device kernels moves thousands of small ring
values per fold (claim chains over 2K instances x t matrices, rho-linear
combinations, RotSums).  The pure-Python int path (field.host) costs
~1 s/step at production scale; this module runs the same exact mod-p math
batched through the goldilocks limb kernels on numpy (field.goldilocks in
numpy mode), 100-1000 values per op.

Conventions:
  * ring batch:  (lo, hi) uint32 arrays, shape (..., 24)  — RqNTT slot-major
  * fq3 batch:   triple of (lo, hi) pairs, each shape (...)
All functions assume (and keep) canonical values < p.  Callers wrap
invocations in backend.numpy_mode().
"""

from __future__ import annotations

import numpy as np

from . import goldilocks as gl

P = gl.P


def rings(values):
    """Nested lists/array of ints (each a 24-int ring) -> (..., 24) limbs.

    Values may be any ints (negatives taken mod p)."""
    arr = np.asarray(values, dtype=object)
    try:
        w = arr.astype(np.uint64)
    except (OverflowError, TypeError, ValueError):
        flat = arr.reshape(-1)
        out = np.empty(flat.shape, dtype=np.uint64)
        for i, v in enumerate(flat):
            out[i] = int(v) % P
        w = out.reshape(arr.shape)
    return gl.from_int(w)


def to_rings(limbs):
    """(..., 24) limbs -> nested python int lists."""
    return gl.to_int(limbs).tolist()


def fq3s(values):
    """List/array of (c0, c1, c2) int tuples -> fq3 batch of shape (...)."""
    arr = np.asarray(values, dtype=object)
    lo, hi = rings(arr) if arr.shape[-1] == 24 else gl.from_int(arr)
    return tuple((lo[..., c], hi[..., c]) for c in range(3))


def fq3_seq_powers(base, count):
    """base^(1..count) for an fq3 batch `base` of shape (n,).

    Returns a tuple of 3 component (lo, hi) pairs with shape (count, n)
    (power-major).  Log-depth doubling: powers m+1..2m = (powers 1..m) *
    base^m, so count=125 takes 7 batched muls."""
    from . import fq3 as f3
    cur = tuple((base[c][0][None], base[c][1][None]) for c in range(3))
    while cur[0][0].shape[0] < count:
        m = cur[0][0].shape[0]
        top = tuple((cur[c][0][m - 1][None], cur[c][1][m - 1][None])
                    for c in range(3))
        nxt = f3.mul(cur, top)
        cur = tuple((np.concatenate([cur[c][0], nxt[c][0]]),
                     np.concatenate([cur[c][1], nxt[c][1]]))
                    for c in range(3))
    return tuple((cur[c][0][:count], cur[c][1][:count]) for c in range(3))


def ntt_scalar_mul_batch(r, s3):
    """Ring batch (..., 24) times fq3 batch broadcastable to (...)."""
    from ..ring import rq
    return rq.ntt_scalar_mul(r, s3)


def ntt_mul_batch(a, b):
    from ..ring import rq
    return rq.ntt_mul(a, b)


def ring_slots_fq3(limbs):
    """Ring batch (..., 24) -> fq3 batch of shape (..., 8) (slot order)."""
    lo = limbs[0].reshape(limbs[0].shape[:-1] + (8, 3))
    hi = limbs[1].reshape(limbs[1].shape[:-1] + (8, 3))
    return tuple((lo[..., c], hi[..., c]) for c in range(3))


def fq3_to_ring_rows(f3b):
    """fq3 batch of shape (..., 8) -> ring batch (..., 24) (inverse of
    ring_slots_fq3)."""
    lo = np.stack([f3b[c][0] for c in range(3)], axis=-1)
    hi = np.stack([f3b[c][1] for c in range(3)], axis=-1)
    return (lo.reshape(lo.shape[:-2] + (24,)),
            hi.reshape(hi.shape[:-2] + (24,)))
