"""The sharded sum-checks of the port (latticeum_tpu_torch/parallel/) over
torch.distributed ranks on the CPU, against the unsharded port and the
JAX package's host sum-check.  Tolerance: none (integers mod p).

The ranks are spawned once per world for the whole module (gloo, two and
four processes, each world at a fresh file:// rendezvous under the test's
temporary directory, so parallel test files never share a port), and a
third world of two ranks joins through the launcher's variables
(env:// on loopback) for full_fold_global, as
scripts/dryrun_multihost.py does for the JAX package.  The rendezvous,
every collective and every join time out after 60 s.  Every rank's
proofs, challenges, finals and transcript (state, absorptions, samples)
must equal the unsharded run's; the communicator must count one
all-reduce for each round run sharded and one gather a sum-check."""

import datetime
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from latticeum_tpu import backend as B
from latticeum_tpu.crypto.transcript import Transcript
from latticeum_tpu.field import goldilocks as gl_ref, host as H
from latticeum_tpu.nifs import folding as fold, linearization as lin
from latticeum_tpu.poly import sumcheck
from latticeum_tpu.ring import rq as rq_ref
from latticeum_tpu.zkvm.accel_t import bitrev_indices
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.parallel import (fold_mesh, kernels, lin_mesh,
                                          mesh as M, multihost)

import torch_mesh_ranks as work

WORLDS = (2, 4)
TIMEOUT_S = 60
GLOBAL = (1 << 4, 15)          # full_fold_global's m and K


def limbs(x):
    return gl.to_limbs(x.contiguous())


def std_limbs(g_t):
    """t-layout (rows, 24, n) bit-reversed -> standard (rows, n, 24) limbs."""
    n = g_t.shape[-1]
    brev = torch.from_numpy(bitrev_indices((n - 1).bit_length()))
    return limbs(g_t[..., brev].transpose(1, 2))


def host_record(th, ph, ch, fh):
    return {"proof": ph, "chals": ch,
            "final": gl_ref.to_int(fh).astype(np.uint64)[:, 0].tolist(),
            "export": th.export_for_device(), "absorptions": th.absorptions,
            "samples": th.samples}


def references(S_c):
    """Per sum-check case: the unsharded port's record and the JAX host
    sum-check's on the same MLEs."""
    out = {}
    for nv, K in work.FOLD_CASES:
        inp = fold_mesh.fold_inputs(nv, K)
        port = work.record(*fold_mesh.run_fold_sumcheck(inp))
        g = std_limbs(torch.cat([inp["head"], inp["tail"]]))
        with B.numpy_mode():
            th = Transcript(record_samples=True)
            ph, ch, fh = sumcheck.prove(th, g, nv, 4, fold.make_comb_fn(
                inp["mu_s"], 2, K))
        out["fold", nv, K] = port, host_record(th, ph, ch, fh)
    S, signs, t_rows = S_c
    for nv, n0 in work.LIN_CASES:
        inp = lin_mesh.lin_inputs(nv, n0, S_c)
        port = work.record(*lin_mesh.run_lin_sumcheck(inp))
        with B.numpy_mode():
            c = gl_ref.from_int(np.array(
                [H.ntt_from_u64(1 if x > 0 else gl.P - 1) for x in signs],
                dtype=object))
            two = lin.make_comb_fn2(S)
            th = Transcript(record_samples=True)
            ph, ch, fh = sumcheck.prove(
                th, std_limbs(inp["g"]), nv, inp["degree"],
                lambda v: two(v, c), eq_info=(inp["beta"], t_rows))
        out["lin", nv, n0] = port, host_record(th, ph, ch, fh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three worlds, run at once while this process computes the
    references: {2: [rank results], 4: [...], "env": [...]}, refs."""
    S_c = lin_mesh._zkvm_S_c()
    rdv = tmp_path_factory.mktemp("rendezvous")
    with ThreadPoolExecutor(3) as pool:
        futures = {w: pool.submit(
            multihost.spawn_ranks, w, "gloo", work.sumcheck_cases, S_c,
            w == 2, init_method=f"file://{rdv}/world{w}",
            timeout_s=TIMEOUT_S, wait_s=600) for w in WORLDS}
        futures["env"] = pool.submit(
            multihost.spawn_ranks, 2, "gloo", work.global_fold, *GLOBAL,
            timeout_s=TIMEOUT_S, wait_s=600)
        refs = references(S_c)
        return {k: f.result() for k, f in futures.items()}, refs


CASES = ([("fold",) + c for c in work.FOLD_CASES]
         + [("lin",) + c for c in work.LIN_CASES])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sumcheck_matches_unsharded_and_host(runs, world, case):
    results, refs = runs
    port, host = refs[case]
    assert port == host
    for rank, res in enumerate(results[world]):
        got = {k: v for k, v in res[case].items() if k != "calls"}
        assert got == port, f"rank {rank}"


@pytest.mark.parametrize("world", WORLDS)
def test_one_all_reduce_per_sharded_round_and_one_gather(runs, world):
    """Each sum-check runs sharded while every rank keeps at least the
    columns its kernel takes: log2(n0 / W) rounds, each with one
    all-reduce; then one gather, and the rest (the truncated lin stack's
    reconstruction rounds included) runs on every rank."""
    results, _ = runs
    for case in CASES:
        n0 = 1 << case[1] if case[0] == "fold" or case[2] is None else case[2]
        sharded = (n0 // world).bit_length() - 1
        for res in results[world]:
            assert res[case]["calls"] == {"all_reduce": sharded,
                                          "all_gather": 1}, case
            assert 0 < sharded < len(res[case]["proof"])


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_is_exact_mod_p(runs, world):
    results, _ = runs
    for res in results[world]:
        assert res["top"] == [[world * (gl.P - 1) % gl.P] * 24] * 5


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ajtai_commit_matches_jax(runs, world):
    results, _ = runs
    rows, f = fold_mesh.ajtai_inputs(*work.AJTAI)
    with B.numpy_mode():
        total = gl_ref.sum_axis(limbs(f), axis=0)
        want = rq_ref.ntt_mul(limbs(rows), total)
    want = gl_ref.to_int(want).astype(np.uint64).tolist()
    for res in results[world]:
        assert res["ajtai"] == want


@pytest.mark.parametrize("world", WORLDS)
def test_slots_crt_exchange_matches_jax(runs, world):
    results, _ = runs
    x = lin_mesh.crt_batch(work.CRT_BATCH)
    with B.numpy_mode():
        full = gl_ref.to_int(rq_ref.crt(limbs(x))).astype(np.uint64)
    rows, slots = M.mesh_shape(world)
    for rank, res in enumerate(results[world]):
        crt = res["crt"]
        r, s = divmod(rank, slots)
        want = full[r::rows].reshape(-1, 8, 3)[:, s::slots].tolist()
        assert crt["out"] == want and crt["equal"]
        assert crt["mesh"] == {"rows": rows, "slots": slots}
        assert crt["exchanged"]
        assert crt["collectives"]["calls"] == {"all_gather": 1}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fold_step_core_matches_unsharded(runs, world):
    results, _ = runs
    mles, matrix, f = work.kernel_inputs()
    want = [gl.to_int_lists(x)
            for x in kernels.fold_step_core(mles, matrix, f, 3)]
    for res in results[world]:
        assert res["kernels"] == want


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dryrun_chain_holds(runs, world):
    results, _ = runs
    for res in results[world]:
        assert res["dryrun"] == {"m": 8, "K": 1, "mles": 11,
                                 "devices": world, "rounds_total": 3,
                                 "chain_checks_ok": 2}


@pytest.mark.parametrize("which", ["fold_vs_single", "lin_vs_single"])
def test_sharded_vs_single_flags(runs, which):
    results, _ = runs
    for res in results[2]:
        flags = res[which]
        assert all(flags[k] for k in ("proof_equal", "chals_equal",
                                      "final_equal", "transcript_equal"))
        assert flags.get("ajtai_equal", True)
        assert flags["collectives"]["calls"]["all_gather"] == 1
        assert flags["rounds_sharded"] == flags["collectives"]["calls"][
            "all_reduce"] > 0


def test_full_fold_global_over_env_ranks_matches_one_process(runs):
    """Two ranks joined through MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE
    agree with each other and with the single-process run."""
    results, _ = runs
    proof, chals, final, state, _ = multihost.full_fold_global(None, *GLOBAL)
    single = (proof, chals, gl.to_int_lists(final), state)
    round0 = multihost.fold_round_global(None, *GLOBAL)
    for res in results["env"]:
        assert res["mesh"] == ((2, 1), ("rows", "slots"))
        assert res["fold"] == single
        assert res["round0"] == round0


def test_init_distributed_without_launcher_is_a_no_op(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.init_distributed("gloo") is False
    with pytest.raises(ValueError):
        multihost.init_distributed("mpi")


def test_communicator_checks_its_tensors(tmp_path, monkeypatch):
    """In a world of one rank both collectives return their input; a
    tensor that is not a field tensor, or on a device the backend does
    not take, raises."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        comm = M.Communicator()
        x = gl.from_int([[gl.P - 1, 5], [0, 1 << 63]])
        assert torch.equal(comm.all_reduce_field(x), x)
        assert torch.equal(comm.all_gather_cols(x)[0], x)
        assert comm.calls == {"all_reduce": 1, "all_gather": 1}
        with pytest.raises(ValueError):
            comm.all_reduce_field(x.to(torch.int32))
        monkeypatch.setattr(comm, "backend", "nccl")
        with pytest.raises(ValueError):
            comm.all_gather_cols(x)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world,shape", [(1, (1, 1)), (2, (2, 1)),
                                         (4, (2, 2)), (8, (4, 2))])
def test_mesh_factoring(world, shape):
    assert M.mesh_shape(world) == shape


def test_strided_shards_keep_round_pairs_local():
    """Global columns j and j + n/2 land on one rank at local i and
    i + n/(2W), and the shards interleave back in global order."""
    x = torch.arange(2 * 24 * 16, dtype=gl.DTYPE).reshape(2, 24, 16)
    for world in (1, 2, 4, 8):
        shards = [M.shard_cols(x, k, world) for k in range(world)]
        for k, s in enumerate(shards):
            half = s.shape[-1] // 2
            assert torch.equal(s[..., half:] - s[..., :half],
                               torch.full_like(s[..., :half], 8))
            assert torch.equal(s, x[..., k::world])
        back = torch.stack(shards, dim=-1).reshape(x.shape)
        assert torch.equal(back, x)
    with pytest.raises(ValueError):
        M.shard_cols(x, 0, 3)


@pytest.mark.cuda
def test_sharded_sumchecks_on_cuda():
    """Two gloo ranks sharing the card: the sharded fold and lin
    sum-checks (the comb kernels and round_tail on the card in each rank)
    against each rank's unsharded card run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    fold_res = multihost.spawn_ranks(2, "gloo", fold_mesh.sharded_vs_single,
                                     1 << 10, 15, 2, "cuda",
                                     timeout_s=TIMEOUT_S)
    lin_res = multihost.spawn_ranks(2, "gloo",
                                    lin_mesh.sharded_lin_vs_single, 10, 256,
                                    "cuda", timeout_s=TIMEOUT_S)
    for flags in fold_res + lin_res:
        assert all(flags[k] for k in ("proof_equal", "chals_equal",
                                      "final_equal", "transcript_equal"))
        assert flags.get("ajtai_equal", True)
        assert flags["collectives"]["calls"]["all_gather"] == 1
