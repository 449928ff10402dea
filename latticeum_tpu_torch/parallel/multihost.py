"""Multi-process initialization, the global mesh, and the fold over it.

Counterpart of ``latticeum_tpu/parallel/multihost.py``.  Each process is
one rank of a ``torch.distributed`` default group, joined from the
launcher's standard variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them) or from an explicit rendezvous.
Every rank runs the same host program; the round sums come back
all-reduced, so every rank's transcript evolves identically (the
multi-controller pattern the JAX package's global mesh uses).  Nothing
here tells a rank about other hosts: the rendezvous address is the
caller's.  ``spawn_ranks`` starts a world of ranks on this host, as
scripts/dryrun_multihost.py starts the JAX package's processes.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..field import goldilocks as gl
from ..zkvm import accel_rounds
from . import fold_mesh
from . import mesh as M


def init_distributed(backend, init_method=None, rank=None, world_size=None,
                     timeout_s=60):
    """Join the default process group over `backend` ("gloo" or "nccl"):
    at `init_method` with `rank` and `world_size` when given, else from
    the launcher's variables.  Without either (no ``MASTER_ADDR``) this is
    a single-process run: nothing is initialized and it returns False.
    The rendezvous and every collective time out after `timeout_s`."""
    if backend not in M.BACKEND_DEVICES:
        raise ValueError(f"backend {backend!r} is not supported")
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(rows=None, device="cuda"):
    """A DeviceMesh over every rank, dims ("rows", "slots"): rows defaults
    to the world size (slots 1), as the JAX package's global mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    device = M.device_of(device)
    world = dist.get_world_size()
    rows = rows or world
    if world % rows:
        raise ValueError(f"{world} ranks do not form {rows} rows")
    return init_device_mesh(device.type, (rows, world // rows),
                            mesh_dim_names=("rows", "slots"))


def fold_round_global(comm=None, m=1 << 10, K=15, b_small=2,
                      device="cuda"):
    """Round 0 of the production fold sum-check over every rank: each
    rank's sums over its strided columns, all-reduced.  Returns the round's
    (2*b_small + 4, 24) sums as host ints, the same on every rank and
    equal to a single process's (comm None)."""
    device = M.device_of(device)
    inputs = fold_mesh.fold_inputs(int(m).bit_length() - 1, K, b_small,
                                   device=device)
    head, tail = inputs["head"], inputs["tail"]
    if comm is not None:
        head = M.shard_cols(head, comm.rank, comm.world)
        tail = M.shard_cols(tail, comm.rank, comm.world)
    mu = accel_rounds._ints([list(v) for v in accel_rounds.mu_powers(
        inputs["mu_s"], K)], device)
    sums, _, _, _ = accel_rounds.fold_round_sums(
        head[0::2], head[1:4:2], tail.contiguous(), mu, b_small, None)
    if comm is not None:
        sums = comm.all_reduce_field(sums)
    return gl.to_int_lists(sums)


def full_fold_global(comm=None, m=1 << 10, K=15, b_small=2,
                     device="cuda"):
    """The whole production fold sum-check (log2 m rounds, the transcript)
    over every rank, or in one process (comm None).  Returns (proof,
    chals, final, transcript state, wall seconds): all but the seconds
    bit-identical on every rank and to the single process."""
    device = M.device_of(device)
    inputs = fold_mesh.fold_inputs(int(m).bit_length() - 1, K, b_small,
                                   device=device)
    t0 = time.perf_counter()
    proof, chals, final, t = fold_mesh.run_fold_sumcheck(inputs, comm)
    wall = time.perf_counter() - t0
    return proof, chals, final, list(t.ch.state), wall


def free_port():
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, backend, init_method, master, timeout_s, fn,
               args, results):
    """One spawned rank: join the group (from the launcher's variables,
    set here from `master` = (address, port), when `init_method` is None),
    run fn(comm, *args) and report."""
    try:
        if init_method is None:
            os.environ.update(MASTER_ADDR=master[0], MASTER_PORT=master[1],
                              RANK=str(rank), WORLD_SIZE=str(world))
            joined = init_distributed(backend, timeout_s=timeout_s)
        else:
            joined = init_distributed(backend, init_method, rank, world,
                                      timeout_s)
        if not joined:
            raise RuntimeError("no rendezvous for the process group")
        try:
            out = fn(M.Communicator(), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(world, backend, fn, *args, init_method=None, timeout_s=60,
                wait_s=600):
    """Run fn(comm, *args) in `world` new processes (start method spawn),
    each one rank of a default group over `backend`, and return their
    results in rank order.  fn must be importable by name and return
    something picklable (no tensors).  The ranks meet at `init_method`
    (e.g. file:// of a fresh path), or, when it is None, at the
    launcher's variables, which each rank sets for itself (this
    process's environment is left as it is): MASTER_ADDR 127.0.0.1, a
    free MASTER_PORT, its RANK and the WORLD_SIZE.  The rendezvous and
    each collective time out after `timeout_s`; the whole run after
    `wait_s`, and each join after `timeout_s`.  A rank that fails or a run that times out raises, and
    every process started here is stopped before this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    master = ("127.0.0.1", str(free_port())) if init_method is None else None
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, backend, init_method, master, timeout_s, fn, args,
        results)) for r in range(world)]
    out = {}
    deadline = time.monotonic() + wait_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(f"{world - len(out)} of {world} ranks "
                                   f"gave no result in {wait_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout_s)
    finally:
        for p in procs:
            if p.pid is not None and p.is_alive():
                p.kill()
                p.join(timeout_s)
    return [out[r] for r in range(world)]
