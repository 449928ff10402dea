"""The work of the ranks that tests/test_torch_mesh.py spawns.  Each rank
imports this module by name, so it imports only the port (no jax), and
returns plain Python values: the parent compares them with the unsharded
port and the JAX package."""

import torch

from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.parallel import (fold_mesh, kernels, lin_mesh,
                                          mesh as M, multihost)

FOLD_CASES = ((5, 2), (4, 15))       # (nv, K): K = 15 is the production stack
LIN_CASES = ((4, None), (6, 16))     # (nv, n0): full width, then truncated
AJTAI = (64, 4)                      # witness rows, kappa
CRT_BATCH = 16
KERNEL_SHAPE = (3, 16, 4)            # MLEs, rows, kappa


def record(proof, chals, final, t):
    """A sum-check's result as plain values."""
    return {"proof": proof, "chals": chals, "final": gl.to_int_lists(final),
            "export": t.export_for_device(), "absorptions": t.absorptions,
            "samples": t.samples}


def kernel_inputs():
    k, n, kappa = KERNEL_SHAPE
    gen = torch.Generator().manual_seed(5)
    return (kernels.rand_mles(k, n, gen), kernels.rand_mles(kappa, n, gen),
            kernels.rand_field((n, 24), gen))


def sumcheck_cases(comm, S_c, with_single):
    """Every sharded case of the test file on this rank."""
    torch.set_num_threads(1)
    out = {}
    for nv, K in FOLD_CASES:
        (res, colls) = fold_mesh.count_collectives(
            comm, fold_mesh.run_fold_sumcheck,
            fold_mesh.fold_inputs(nv, K, device="cpu"), comm)
        out["fold", nv, K] = {**record(*res), "calls": colls["calls"]}
    for nv, n0 in LIN_CASES:
        (res, colls) = fold_mesh.count_collectives(
            comm, lin_mesh.run_lin_sumcheck,
            lin_mesh.lin_inputs(nv, n0, S_c, device="cpu"), comm)
        out["lin", nv, n0] = {**record(*res), "calls": colls["calls"]}
    rows, f = fold_mesh.ajtai_inputs(*AJTAI, device="cpu")
    out["ajtai"] = gl.to_int_lists(fold_mesh.sharded_ajtai_commit(
        comm, rows, M.shard_vector(f, comm.rank, comm.world)))
    crt = lin_mesh.slots_crt_exchange(M.make_mesh(comm.world, "cpu"),
                                      lin_mesh.crt_batch(CRT_BATCH,
                                                         device="cpu"))
    out["crt"] = {"out": gl.to_int_lists(crt["out"]),
                  **{k: crt[k] for k in ("mesh", "equal", "collectives",
                                         "exchanged")}}
    mles, matrix, fv = kernel_inputs()
    evals, cm = kernels.fold_step_core(
        M.shard_mles(mles, comm.rank, comm.world),
        M.shard_matrix(matrix, comm.rank, comm.world),
        M.shard_vector(fv, comm.rank, comm.world), 3)
    out["kernels"] = [gl.to_int_lists(comm.all_reduce_field(x))
                      for x in (evals, cm)]
    top = torch.full((5, 24), gl.P_I64 - 1, dtype=gl.DTYPE)
    out["top"] = gl.to_int_lists(comm.all_reduce_field(top))
    out["dryrun"] = fold_mesh.sharded_dryrun(comm, m=1 << 3, K=1,
                                             device="cpu")
    if with_single:
        out["fold_vs_single"] = fold_mesh.sharded_vs_single(
            comm, m=1 << 2, K=1, device="cpu", kappa=4)
        out["lin_vs_single"] = lin_mesh.sharded_lin_vs_single(
            comm, nv=2, device="cpu", S_c=S_c)
    return out


def global_fold(comm, m, K):
    """full_fold_global and fold_round_global over the world's ranks."""
    torch.set_num_threads(1)
    mesh = multihost.global_mesh(device="cpu")
    proof, chals, final, state, _ = multihost.full_fold_global(comm, m, K,
                                                               device="cpu")
    return {"mesh": (tuple(mesh.mesh.shape), mesh.mesh_dim_names),
            "fold": (proof, chals, gl.to_int_lists(final), state),
            "round0": multihost.fold_round_global(comm, m, K, device="cpu")}
