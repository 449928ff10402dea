"""The array cores of the folding hot path, in plain torch.

Counterpart of ``latticeum_tpu/parallel/kernels.py``: the same functions
on (k, n, 24) int64 Goldilocks tensors in the standard layout (the
hypercube on axis -2, adjacent rows paired).  The JAX ones are XLA
functions, not Pallas kernels, so these have no hand kernel.  Sharded over
the rows (``mesh.shard_mles``, ``shard_matrix``, ``shard_vector``), a
rank's round evaluations and Ajtai sums are partial sums, which
``mesh.Communicator.all_reduce_field`` completes.
"""

from __future__ import annotations

import torch

from ..field import fq3, goldilocks as gl
from ..ring import rq


def sumcheck_round_evals(mles, degree: int, comb_fn):
    """One sum-check round: mles (k, n, 24) -> evals (degree+1, 24).

    Pairs the hypercube as (index/2, bit), evaluates the comb at
    t = 0..degree by stepping v1 - v0, and sums over the pairs."""
    k, n = mles.shape[0], mles.shape[-2]
    pairs = mles.reshape(k, n // 2, 2, 24)
    v0, v1 = pairs[:, :, 0], pairs[:, :, 1]
    evals = [comb_fn(v0), comb_fn(v1)]
    step = gl.sub(v1, v0)
    vals = v1
    for _ in range(2, degree + 1):
        vals = gl.add(vals, step)
        evals.append(comb_fn(vals))
    return torch.stack([gl.sum_axis(e, -2) for e in evals])


def fix_variable_dev(mles, r3):
    """Fold the lowest hypercube variable at the Fq3 point r3, a (3,)
    tensor: (k, n, 24) -> (k, n/2, 24)."""
    k, n = mles.shape[0], mles.shape[-2]
    pairs = mles.reshape(k, n // 2, 2, 24)
    left, right = pairs[:, :, 0], pairs[:, :, 1]
    return gl.add(left, rq.ntt_scalar_mul(gl.sub(right, left), fq3.of(r3)))


def ajtai_commit_kernel(matrix, f):
    """cm = A f: (kappa, n, 24) x (n, 24) -> (kappa, 24)."""
    return gl.sum_axis(rq.ntt_mul(matrix, f[None]), -2)


def product_comb(vals):
    """The product of all MLEs' values: (k, ..., 24) -> (..., 24)."""
    acc = vals[0]
    for i in range(1, vals.shape[0]):
        acc = rq.ntt_mul(acc, vals[i])
    return acc


def fold_step_core(mles, matrix, f, degree: int):
    """One sum-check round over the witness-row hypercube and one Ajtai
    commitment: (evals (degree+1, 24), cm (kappa, 24))."""
    return (sumcheck_round_evals(mles, degree, product_comb),
            ajtai_commit_kernel(matrix, f))


def rand_field(shape, generator):
    """Canonical field elements drawn from `generator` on its device: a low
    half below 2^32 and a high half below 2^32 - 1, so every value is < p,
    as the JAX package's ``rand_mles`` draws its limbs."""
    dev = generator.device
    lo = torch.randint(0, 1 << 32, shape, generator=generator, device=dev,
                       dtype=gl.DTYPE)
    hi = torch.randint(0, gl.MASK32, shape, generator=generator, device=dev,
                       dtype=gl.DTYPE)
    return lo | (hi << 32)


def rand_mles(k, n, generator):
    """(k, n, 24) random canonical field elements on `generator`'s device."""
    return rand_field((k, n, 24), generator)
