"""The (rows, slots) process mesh, the shardings and the communicator of
the sharded sum-checks.

Counterpart of ``latticeum_tpu/parallel/mesh.py``.  The JAX package lets
GSPMD place its collectives; here they are placed by hand, and there are
exactly two, both in ``Communicator``:

* ``all_reduce_field``: an exact sum mod p over the ranks.  Field elements
  are int64 bit patterns of u64 values, so a plain int64 SUM would wrap
  and not reduce mod p.  Their 32-bit halves are summed instead (exact
  below 2^31 ranks) and recombined, as ``goldilocks.sum_axis`` does; so,
  as the JAX package keeps its limb arithmetic exact, the reduction order
  cannot change a result.
* ``all_gather_cols``: the ranks' column shards back in global column
  order.

The sum-checks run in the bit-reversed t-layout, where every round pairs
column j with column j + n/2.  A contiguous slice per rank would put the
two on different ranks, so the t-layout is sharded by stride
(``shard_cols``: rank k holds global columns k, k + W, k + 2W, ...): global
columns j and j + n/2 are then local columns i and i + n/(2W) of one rank,
and stay so after every fold.  The standard-layout shardings
(``shard_mles``, ``shard_matrix``, ``shard_vector``) take contiguous
blocks of the row axis, as the JAX package's NamedShardings do, which
keeps ``kernels.sumcheck_round_evals``'s adjacent pairs on one rank.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..field import goldilocks as gl

# The devices each backend takes tensors on.  gloo stages CUDA tensors
# through host memory itself; NCCL takes card tensors only.
BACKEND_DEVICES = {"gloo": ("cpu", "cuda"), "nccl": ("cuda",)}


def mesh_shape(world: int):
    """(rows, slots) of a world of `world` ranks: slots 2 when the world is
    even and above 2, as the JAX package factors its devices."""
    slots = 2 if world % 2 == 0 and world > 2 else 1
    return world // slots, slots


def make_mesh(world: int, device):
    """A DeviceMesh over the initialized default group, dims ("rows",
    "slots"), rank = row * slots + slot."""
    from torch.distributed.device_mesh import init_device_mesh
    if dist.get_world_size() != world:
        raise ValueError(f"the default group has {dist.get_world_size()} "
                         f"ranks, not {world}")
    return init_device_mesh(torch.device(device).type, mesh_shape(world),
                            mesh_dim_names=("rows", "slots"))


def shard_cols(x, rank: int, world: int):
    """The strided t-layout shard of rank `rank`: columns rank::world of the
    minor axis."""
    if x.shape[-1] % world:
        raise ValueError(f"{x.shape[-1]} columns do not split over {world} "
                         "ranks")
    return x[..., rank::world].contiguous()


def _block(x, dim, rank, world):
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    return x.narrow(dim, rank * (n // world), n // world).contiguous()


def shard_mles(x, rank: int, world: int):
    """(k, n, 24) MLEs: rank's contiguous block of the hypercube axis."""
    return _block(x, -2, rank, world)


def shard_matrix(x, rank: int, world: int):
    """Ajtai (kappa, n, 24): rank's block of the contraction axis."""
    return _block(x, -2, rank, world)


def shard_vector(x, rank: int, world: int):
    """(n, 24): rank's block of the rows."""
    return _block(x, 0, rank, world)


def replicate(x):
    """Every rank holds all of `x`."""
    return x.contiguous()


class Communicator:
    """The two collectives of the sharded sum-checks over one process group
    (the default group when `group` is None), each counted: ``calls``,
    ``bytes`` (what this rank contributes) and ``seconds`` per collective,
    and ``log``, one (collective, bytes, seconds) entry per call in order.
    The seconds are host time inside the call: under gloo the call returns
    when the exchange is done, so they include the wait for the device work
    the tensor depends on and its copies through host memory; under NCCL
    they are the enqueue alone."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if self.backend not in BACKEND_DEVICES:
            raise ValueError(f"backend {self.backend} is not supported")
        self.reset()

    def reset(self):
        self.calls = {"all_reduce": 0, "all_gather": 0}
        self.bytes = {"all_reduce": 0, "all_gather": 0}
        self.seconds = {"all_reduce": 0.0, "all_gather": 0.0}
        self.log = []

    def _run(self, kind, t, collective, *args):
        t0 = time.perf_counter()
        collective(*args, group=self.group)
        dt = time.perf_counter() - t0
        nbytes = t.numel() * t.element_size()
        self.calls[kind] += 1
        self.bytes[kind] += nbytes
        self.seconds[kind] += dt
        self.log.append((kind, nbytes, dt))

    def _check(self, x):
        if x.device.type not in BACKEND_DEVICES[self.backend]:
            raise ValueError(f"{self.backend} takes no {x.device.type} "
                             "tensors")
        if x.dtype != gl.DTYPE:
            raise ValueError(f"field tensors are int64, not {x.dtype}")

    def all_reduce_field(self, x):
        """The sum mod p of `x` over the ranks, every rank the same."""
        self._check(x)
        halves = torch.stack([x & gl.MASK32, gl._srl(x, 32)])
        self._run("all_reduce", halves, dist.all_reduce, halves)
        return gl._combine_halves(halves[0], halves[1])

    def all_gather_cols(self, *xs):
        """Each tensor of `xs` (..., w), a strided column shard, back at its
        global width (..., w * world) in global column order, on every
        rank.  All of them in one collective."""
        for x in xs:
            self._check(x)
        flat = torch.cat([x.reshape(-1) for x in xs])
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        self._run("all_gather", flat, dist.all_gather, parts, flat)
        out, off = [], 0
        for x in xs:
            n = x.numel()
            cols = torch.stack([p[off:off + n].reshape(x.shape)
                                for p in parts], dim=-1)
            out.append(cols.reshape(x.shape[:-1] + (x.shape[-1] * self.world,)))
            off += n
        return out
