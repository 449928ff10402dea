"""Evaluation claims as exact torch reductions.

Counterpart of ``latticeum_tpu/field/mxu.py::ring_contract`` as used by
``accel_nifs.py`` (``_eval_fhat``, ``_eval_fhat_batched``, ``eval_claims``,
``eval_claims_batched``).  The reference contracts with int8 digit-plane
GEMMs on the TPU's matrix unit; here each claim is a slot-wise ring product
followed by ``goldilocks.sum_axis``, one witness at a time to bound the
transient memory.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..ring import rq


def eval_fhat(f_hat, eq_t):
    """<f_hat_j, eq> for t-layout MLEs f_hat (..., 24, n) against one eq
    table eq_t (24, n) in the same column order -> (..., 24)."""
    flat = f_hat.reshape(-1, 24, f_hat.shape[-1])
    out = torch.stack([gl.sum_axis(rq.ntt_mul_t(m, eq_t), -1) for m in flat])
    return out.reshape(f_hat.shape[:-1])


def eval_claims(eqT, z):
    """u[k][j] = sum_col eqT[j, col] * z[k, col] for M^T eq rows eqT
    (t, n, 24) and stacked z vectors (K, n, 24) -> (K, t, 24)."""
    return torch.stack([gl.sum_axis(rq.ntt_mul(eqT, zk[None]), -2)
                        for zk in z])
