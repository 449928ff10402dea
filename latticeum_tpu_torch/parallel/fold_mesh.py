"""The production fold sum-check sharded over torch.distributed ranks.

Counterpart of ``latticeum_tpu/parallel/fold_mesh.py``.  The (5 + 2K*TAU,
24, m) t-layout stack [eq_r1, c1, eq_r2, c2, eq_beta, f_hat...] goes
through the port's eq-factored chained sum-check
(``zkvm/accel_rounds.run_fold_rounds_factored``), each rank holding its
strided column shard; each round's sums are all-reduced exactly before
the round tail, so every rank's proof, challenges, finals and transcript
equal the unsharded run's bit for bit (``parallel/mesh.py``).  The JAX
package fills the head with random rows; the eq-factored rounds need the
eq tables of real points, so here the head holds eq tables of seeded
points and the tail balanced digits in {-1, 0, 1}, as honest f_hat rows.
The row-constant Ajtai commitment shards its witness rows and all-reduces
their sum.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..field import goldilocks as gl
from ..host.crypto.transcript import Transcript
from ..host.field import host as H
from ..host.nifs import folding as fold
from ..host.nifs.test_fixtures import get_test_ccs
from ..host.poly.sumcheck import interpolate_uni_poly
from ..crypto import challenger
from ..ring import rq
from ..zkvm import accel_rounds, comb
from ..zkvm.accel import Engine
from . import mesh as M
from .kernels import rand_field

TAU = 3


def rand_point(rng, nv):
    return [tuple(int(v) for v in rng.integers(0, gl.P, 3, dtype=np.uint64))
            for _ in range(nv)]


def fold_inputs(nv, K, b_small=2, seed=11, device="cuda"):
    """Production-shaped inputs of the fold sum-check at m = 2^nv: the
    squeezed mu and beta challenges of a fresh transcript (as the JAX
    package squeezes its mu), seeded points r1 and r2, their eq tables, two
    random c rows and 2K*TAU rows of balanced digits (digit, 0, 0) per
    slot, the values drawn on `device` from `seed`."""
    device = M.device_of(device)
    rng = np.random.default_rng(seed)
    _, beta, _, mu_s = fold.squeeze_alpha_beta_zeta_mu(Transcript(), nv, K)
    points = (rand_point(rng, nv), rand_point(rng, nv), beta)
    engine = Engine(get_test_ccs(), device)
    eqs = [engine.eq_table(p, None, t_layout=True) for p in points]
    gen = torch.Generator(device).manual_seed(seed)
    n = 1 << nv
    c = rand_field((2, 24, n), gen)
    digits = torch.randint(-1, 2, (2 * K * TAU, 8, n), generator=gen,
                           device=device)
    tail = torch.zeros((2 * K * TAU, 8, 3, n), dtype=gl.DTYPE, device=device)
    tail[:, :, 0] = torch.where(digits < 0, digits + gl.P_I64, digits)
    return {"nv": nv, "K": K, "b_small": b_small, "mu_s": mu_s,
            "points": points,
            "head": torch.stack([eqs[0], c[0], eqs[1], c[1], eqs[2]]),
            "tail": tail.reshape(2 * K * TAU, 24, n)}


def run_fold_sumcheck(inputs, comm=None, log=None):
    """One transcripted fold sum-check over `inputs` (``fold_inputs``),
    sharded over `comm`'s ranks when given.  Returns (proof, chals, final,
    transcript): host ints, the final rows as a host tensor, and the host
    transcript with its absorptions and samples."""
    head, tail = inputs["head"], inputs["tail"]
    if comm is not None:
        head = M.shard_cols(head, comm.rank, comm.world)
        tail = M.shard_cols(tail, comm.rank, comm.world)
    b_small = inputs["b_small"]
    t = Transcript(record_samples=True)
    proof, chals, final = accel_rounds.run_fold_rounds_factored(
        t, head, tail, inputs["nv"], 2 * b_small, inputs["mu_s"],
        inputs["points"], b_small, inputs["K"], log=log, comm=comm)
    return proof, chals, final, t


def same_transcript(a, b):
    """Two host transcripts agree: challenger state and pending input,
    absorptions and recorded samples."""
    return (a.export_for_device() == b.export_for_device()
            and a.absorptions == b.absorptions and a.samples == b.samples)


def count_collectives(comm, fn, *args, **kwargs):
    """Run fn and return (its result, the collectives `comm` made meanwhile:
    calls, bytes and seconds per collective, and the log in order).  The
    port's counterpart of counting collectives in the compiled HLO."""
    start = len(comm.log)
    out = fn(*args, **kwargs)
    made = comm.log[start:]
    counts = {"calls": {}, "bytes": {}, "seconds": {}, "log": made}
    for kind, nbytes, dt in made:
        for key, v in (("calls", 1), ("bytes", nbytes), ("seconds", dt)):
            counts[key][kind] = counts[key].get(kind, 0) + v
    return out, counts


def launches():
    """The launch counts of the sum-checks' kernels: the four comb kernels,
    fold_c_round (with the pair sums and the end), the lin reconstruction
    tail and round_tail (0 on the CPU, where their twins run)."""
    out = {w.__name__: w.launches for w in comb.WRAPPERS}
    out["fold_c_round"] = comb.fold_c_round.launches
    out["lin_recon_tail"] = comb.lin_recon_tail.launches
    out["round_tail"] = challenger.round_tail.launches
    return out


def sharded_run(comm, device, fn, *args):
    """fn(*args, comm) timed, with the collectives it made and the kernel
    launches it counted: ((result, seconds), collectives, launches)."""
    before = launches()
    out, colls = count_collectives(comm, _timed, device, fn, *args, comm)
    return out, colls, {k: v - before[k] for k, v in launches().items()}


def _timed(device, fn, *args, **kwargs):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def in_turns(comm, fn, *args, **kwargs):
    """fn run by one rank after the other (the others wait at a barrier),
    so that an unsharded reference has the device to itself."""
    out = None
    for k in range(comm.world):
        if comm.rank == k:
            out = fn(*args, **kwargs)
        if comm.world > 1:
            dist.barrier(group=comm.group)
    return out


def ajtai_inputs(n, kappa=32, seed=3, device="cuda"):
    """Row-constant Ajtai rows (kappa, 24) and a witness f (n, 24)."""
    device = M.device_of(device)
    gen = torch.Generator(device).manual_seed(seed)
    return rand_field((kappa, 24), gen), rand_field((n, 24), gen)


def ajtai_commit(rows, f):
    """Row-constant commitment a_k * sum_i f_i -> (kappa, 24)."""
    return rq.ntt_mul(rows, gl.sum_axis(f, 0)[None])


def sharded_ajtai_commit(comm, rows, f_shard):
    """The same with f's rows sharded: each rank's sum of its rows,
    all-reduced, then the product with the replicated rows."""
    total = comm.all_reduce_field(gl.sum_axis(f_shard, 0))
    return rq.ntt_mul(rows, total[None])


def _result(comm, one, single_s, run):
    """The entries that both sharded-vs-single dicts share."""
    (p1, c1, f1, t1), (((pn, cn, fn, tn), sharded_s), colls, counts) = (
        one, run)
    return {"devices": comm.world, "backend": comm.backend,
            "rounds_total": len(pn),
            "rounds_sharded": colls["calls"].get("all_reduce", 0),
            "proof_equal": p1 == pn, "chals_equal": c1 == cn,
            "final_equal": torch.equal(f1, fn),
            "transcript_equal": same_transcript(t1, tn),
            "collectives": {k: v for k, v in colls.items() if k != "log"},
            "launches": counts, "single_s": single_s, "sharded_s": sharded_s}


def sharded_vs_single(comm, m=1 << 13, K=15, b_small=2, device="cuda",
                      seed=11, kappa=32, log=None):
    """The fold sum-check at m = 2^nv unsharded (rank by rank) and sharded
    over `comm`, on the same inputs, and the row-constant Ajtai commitment
    of an m/2-row witness unsharded and sharded: the JAX function's result
    dict (equality flags, shapes), with each run's seconds and the
    sharded run's collectives and kernel launches."""
    device = M.device_of(device)
    nv = int(m).bit_length() - 1
    inputs = fold_inputs(nv, K, b_small, seed, device)
    one, single_s = in_turns(comm, _timed, device, run_fold_sumcheck,
                             inputs, log=log)
    run = sharded_run(comm, device, run_fold_sumcheck, inputs)
    rows, f = ajtai_inputs(m // 2, kappa, seed + 1, device)
    cm_1 = ajtai_commit(rows, f)
    cm_n = sharded_ajtai_commit(comm, M.replicate(rows),
                                M.shard_vector(f, comm.rank, comm.world))
    return {"m": m, "K": K, "mles": 5 + 2 * K * TAU,
            **_result(comm, one, single_s, run),
            "ajtai_equal": torch.equal(cm_1, cm_n)}


def sharded_dryrun(comm, m=1 << 10, K=15, b_small=2, device="cuda",
                   log=None):
    """One sharded fold sum-check, checked without an unsharded run by the
    sum-check chain: p_i(0) + p_i(1) == p_{i-1}(r_{i-1}) for every round
    i >= 1 (the verifier's round check), which any corrupt shard or
    diverged transcript breaks."""
    device = M.device_of(device)
    nv = int(m).bit_length() - 1
    proof, chals, _, _ = run_fold_sumcheck(
        fold_inputs(nv, K, b_small, device=device), comm, log)
    if len(proof) != nv or len(chals) != nv:
        raise AssertionError(f"{len(proof)} rounds, {len(chals)} challenges")
    for i in range(1, nv):
        if (H.ntt_add(proof[i][0], proof[i][1])
                != interpolate_uni_poly(proof[i - 1], chals[i - 1])):
            raise AssertionError(f"the sum-check chain broke at round {i}")
    return {"m": m, "K": K, "mles": 5 + 2 * K * TAU, "devices": comm.world,
            "rounds_total": nv, "chain_checks_ok": nv - 1}
