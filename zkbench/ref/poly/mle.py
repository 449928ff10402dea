"""Dense multilinear extensions over RqNTT, batched for TPU.

An MLE over {0,1}^nv with ring-element values is a limb pair of shape
(..., 2^nv, 24): hypercube index on axis -2 (variable 0 = least-significant
index bit, matching the reference's DenseMultilinearExtension layout,
stark-rings/crates/poly/src/mle/dense.rs:18-27,171-196), ring slot-major
NTT coefficients on axis -1.

Unlike the reference's lazily-truncated vectors, the TPU form is always
dense/padded — XLA wants static shapes, and the padding region is exact
zeros so results are identical.
"""

from __future__ import annotations

from .. import backend as B

from ..field import goldilocks as gl
from ..ring import rq


def from_rings(rings, nv: int):
    """Host list of ring elements (each 24 ints) -> padded MLE limbs."""
    import numpy as np
    n = 1 << nv
    arr = np.zeros((n, 24), dtype=object)
    for i, r in enumerate(rings):
        arr[i, :] = r
    return gl.from_int(arr)


def fix_variable(mle, r_fq3):
    """Fold variable 0 at Fq3 point r: new[b] = a[2b] + r*(a[2b+1]-a[2b]).

    mle: (..., n, 24) limbs; r_fq3: fq3 limb triple (scalars or batch-
    broadcastable).  Returns (..., n/2, 24).
    """
    lo, hi = mle
    n = lo.shape[-2]
    lo = lo.reshape(lo.shape[:-2] + (n // 2, 2, 24))
    hi = hi.reshape(hi.shape[:-2] + (n // 2, 2, 24))
    left = (lo[..., 0, :], hi[..., 0, :])
    right = (lo[..., 1, :], hi[..., 1, :])
    diff = gl.sub(right, left)
    return gl.add(left, rq.ntt_scalar_mul(diff, r_fq3))


def evaluate(mle, rs_fq3):
    """Evaluate at a point (list of Fq3 limb triples, variable 0 first).

    Accepts lazily-truncated MLEs (length < 2^len(rs)): the zero tail is
    padded back in as folding shrinks the array to one entry."""
    out = mle
    for r in rs_fq3:
        if out[0].shape[-2] == 1:
            z = B.xp.zeros_like(out[0])
            out = (B.xp.concatenate([out[0], z], axis=-2),
                   B.xp.concatenate([out[1], z], axis=-2))
        out = fix_variable(out, r)
    lo, hi = out
    return (lo[..., 0, :], hi[..., 0, :])


def fq3_const(c):
    """Host Fq3 tuple -> device limb triple (rank-0)."""
    return tuple(gl.const(x) for x in c)


def build_eq_table(r_fq3_list, max_rows=None):
    """eq(r, x) evaluations over the hypercube as an MLE (n, 24) limbs.

    eq(r, x) = prod_i (r_i x_i + (1-r_i)(1-x_i)); variable 0 = LSB (index
    bit i = x_i).  Matches latticefold's build_eq_x_r
    (utils/sumcheck/utils.rs:123-160).  Vectorized doubling on device; with
    max_rows, later doubling steps only extend the kept prefix (exact for
    consumers that only read rows < max_rows).
    """
    from ..field import host as H
    cur = from_rings([H.ntt_from_u64(1)], 0)  # (1, 24)
    for r in r_fq3_list:
        rd = fq3_const(r)
        one_minus = fq3_const(H.fq3_sub((1, 0, 0), r))
        low = rq.ntt_scalar_mul(cur, one_minus)
        n = cur[0].shape[0]
        if max_rows is not None and n >= max_rows:
            cur = low
            continue
        high = rq.ntt_scalar_mul(cur, rd)
        if max_rows is not None and 2 * n > max_rows:
            high = (high[0][: max_rows - n], high[1][: max_rows - n])
        cur = (B.xp.concatenate([low[0], high[0]]),
               B.xp.concatenate([low[1], high[1]]))
    return cur
