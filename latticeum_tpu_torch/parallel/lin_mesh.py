"""The production-structure linearization sum-check sharded over
torch.distributed ranks, and the CRT with the ring-coordinate axis sharded
over the mesh's "slots" ranks.

Counterpart of ``latticeum_tpu/parallel/lin_mesh.py``.  The (t + 1, 24,
n0) stack (the zkVM's 125 Mz rows and the eq row, n0 <= 2^nv columns,
the zkVM's 52 multisets with their +-1 constants) goes through the port's
chained lin sum-check (``zkvm/accel_rounds.run_lin_rounds_factored``),
each rank holding its strided column shard.  A truncated stack (n0 <
2^nv) ends with the reconstruction rounds, which run after the gather on
every rank.  The slots exchange gathers the 24 coefficients of a rank's
batch rows from its "slots" ranks, applies the CRT and keeps the rank's
own ring slots: the layout whose stage exchange the JAX package measures
for the day the ring axis is worth sharding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.crypto.transcript import Transcript
from ..host.nifs.test_fixtures import get_test_ccs
from ..host.zkvm.builder import create_riscv_ccs
from ..host.zkvm.layout import CCSLayout
from ..host.zkvm.params import default_params
from ..ring import rq
from ..zkvm import accel_rounds, comb
from ..zkvm.accel import Engine
from . import mesh as M
from .fold_mesh import (_result, _timed, count_collectives, eq_t,
                        in_turns, rand_point, sharded_run)
from .kernels import rand_field


def _zkvm_S_c():
    """The zkVM's multisets, their +-1 constants and its matrix count t,
    from the host copy's CCS at default_params() (shapes only)."""
    ccs = create_riscv_ccs(CCSLayout(default_params()))
    signs = tuple(1 if int(c[0]) == 1 else -1 for c in ccs.c)
    return tuple(tuple(int(j) for j in s) for s in ccs.S), signs, ccs.t


def lin_inputs(nv, n0=None, S_c=None, seed=17, device="cpu"):
    """The lin sum-check's inputs at 2^nv rows, its stack n0 columns wide
    (2^nv unless given): seeded betas, t random Mz rows and the betas' eq
    row (truncated to n0 rows, the skipped variables folded in, as the
    prover's lin_g_t builds it), the multisets and signs `S_c` (the zkVM's
    when None), all drawn on `device` from `seed`."""
    S, signs, t_rows = _zkvm_S_c() if S_c is None else S_c
    n0 = 1 << nv if n0 is None else n0
    beta = rand_point(np.random.default_rng(seed), nv)
    eq = eq_t(Engine(get_test_ccs(), device), beta, n0)
    gen = torch.Generator(device).manual_seed(seed)
    mz = rand_field((t_rows, 24, n0), gen)
    return {"nv": nv, "S": S, "signs": signs, "beta": beta,
            "degree": max(len(s) for s in S) + 1,
            "sets": comb.lin_sets(S, signs, t_rows, device),
            "g": torch.cat([mz, eq[None]])}


def run_lin_sumcheck(inputs, comm=None, log=None):
    """One transcripted lin sum-check over `inputs` (``lin_inputs``),
    sharded over `comm`'s ranks when given.  Returns (proof, chals, final,
    transcript)."""
    g = inputs["g"]
    if comm is not None:
        g = M.shard_cols(g, comm.rank, comm.world)
    t = Transcript(record_samples=True)
    proof, chals, final = accel_rounds.run_lin_rounds_factored(
        t, g, inputs["nv"], inputs["degree"], inputs["sets"], inputs["beta"],
        log=log, comm=comm)
    return proof, chals, final, t


def sharded_lin_vs_single(comm, nv=10, n0=None, device="cpu", seed=17,
                          S_c=None, log=None):
    """The lin sum-check with the zkVM's multiset structure unsharded (rank
    by rank) and sharded over `comm` on the same inputs: equality flags,
    shapes, each run's seconds and the sharded run's collectives and
    kernel launches."""
    inputs = lin_inputs(nv, n0, S_c, seed, device)
    one, single_s = in_turns(comm, _timed, device, run_lin_sumcheck, inputs,
                             log=log)
    return {"m": 1 << nv, "n0": inputs["g"].shape[-1],
            "t_rows": inputs["g"].shape[0] - 1,
            "multisets": len(inputs["S"]),
            **_result(comm, one, single_s,
                      sharded_run(comm, device, run_lin_sumcheck, inputs))}


def crt_batch(batch, seed=23, device="cpu"):
    """(batch, 24) random coefficient-form rings."""
    return rand_field((batch, 24), torch.Generator(device).manual_seed(seed))


def slots_crt_exchange(mesh, x):
    """CRT of x (batch, 24) with the batch sharded over the mesh's "rows"
    and the 24 coefficients over its "slots" (rank (r, s) of an R x S mesh
    holds rows r::R and coefficients s::S): the slots ranks all-gather
    their coefficients, each applies the CRT to its rows and keeps its own
    ring slots s::S (3 values each).  Returns this rank's NTT values
    (batch/R, 8/S, 3), the replicated CRT's same part, and the
    collectives of the exchange."""
    R, S = tuple(mesh.mesh.shape)
    r, s = mesh.get_local_rank("rows"), mesh.get_local_rank("slots")
    comm = M.Communicator(mesh.get_group("slots"))
    if x.shape[0] % R or rq.N_SLOTS % S:
        raise ValueError(f"a {tuple(x.shape)} batch does not split over "
                         f"{R} x {S}")
    mine = x[r::R, s::S].contiguous()
    (full,), colls = count_collectives(comm, comm.all_gather_cols, mine)
    out = rq.crt(full).reshape(-1, rq.N_SLOTS, 3)[:, s::S]
    want = rq.crt(x)[r::R].reshape(-1, rq.N_SLOTS, 3)[:, s::S]
    return {"mesh": {"rows": R, "slots": S}, "batch": x.shape[0],
            "out": out, "replicated": want, "equal": torch.equal(out, want),
            "collectives": {k: v for k, v in colls.items() if k != "log"},
            "exchanged": colls["calls"].get("all_gather", 0) > 0}
