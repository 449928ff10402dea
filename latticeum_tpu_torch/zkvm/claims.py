"""Evaluation claims.

Counterpart of the claims of ``latticeum_tpu/zkvm/accel_nifs.py``
(``_eval_fhat``, ``_eval_fhat_batched``, ``eval_claims``,
``eval_claims_batched``) on its default route: every claim is a batched
ring inner product, ``field/mxu.py::ring_contract`` (int8 digit planes).

``eval_fhat_slotwise`` and ``eval_claims_slotwise`` compute the same claims
as slot-wise ring products and ``goldilocks.sum_axis``, one witness at a
time: the independent plain reference of the tests and ``chip_smoke.py``.
The prover does not call them.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl, mxu
from ..ring import rq


def eval_fhat(f_hat, eq_t):
    """<f_hat_j, eq> for t-layout MLEs f_hat (..., 24, n) against one eq
    table eq_t (24, n) in the same column order -> (..., 24)."""
    flat = f_hat.reshape(-1, 24, f_hat.shape[-1])
    out = mxu.ring_contract(flat, eq_t[None], t_layout=True)   # (rows, 1, 24)
    return out[:, 0].reshape(f_hat.shape[:-1])


def eval_claims(eqT, z):
    """u[k][j] = sum_col eqT[j, col] * z[k, col] for M^T eq rows eqT
    (t, n, 24) and stacked z vectors (K, n, 24) -> (K, t, 24)."""
    return mxu.ring_contract(eqT, z).transpose(0, 1)


def eval_fhat_slotwise(f_hat, eq_t):
    flat = f_hat.reshape(-1, 24, f_hat.shape[-1])
    out = torch.stack([gl.sum_axis(rq.ntt_mul_t(m, eq_t), -1) for m in flat])
    return out.reshape(f_hat.shape[:-1])


def eval_claims_slotwise(eqT, z):
    return torch.stack([gl.sum_axis(rq.ntt_mul(eqT, zk[None]), -2)
                        for zk in z])
