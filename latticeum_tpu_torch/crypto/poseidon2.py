"""Batched Poseidon2 width-8 over Goldilocks on torch tensors, and the
Merkle construction built on it.

Counterpart of ``latticeum_tpu/crypto/poseidon2.py`` (``perm8``,
``hash_rows_narrow``, ``compress_level``, ``merkle_root_rows``) and of its
Pallas kernel ``latticeum_tpu/parallel/pallas_kernels.py:109``
(``make_perm8_kernel``), whose CUDA body is ``csrc/poseidon2.cu``.

A state is a row of 8 field elements, u64 bits in ``torch.int64`` (the
port's element type, ``field/goldilocks.py``).  ``perm8`` (the permutation)
and ``sponge8`` (the rate-4 sponge of whole rows, all absorbs in one launch)
given a CPU tensor run their plain-torch twins; given a CUDA tensor they
launch their kernel (and count the launch) or raise.  There is no fallback.
The kernels come in forms, S lanes per state (see ``csrc/poseidon2.cu``):
``perm8`` and ``sponge8`` pick S from the number of rows by a fixed rule
(``kernel_lanes``); ``perm8_lanes`` and ``sponge8_lanes`` run a given S so
that the forms can be compared.  The Merkle levels are one perm8 call per
level.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..host.crypto import consts
from ..kernels import check, counted, launch, ptr, route, stream

WIDTH = 8
RATE = 4
DIGEST = 4
_consts_on = {}      # device -> (94,) round constants (csrc/poseidon2.cu)


def _const_row(values, device):
    return gl.from_int(list(values), device)


def _sbox(x):
    x2 = gl.mul(x, x)
    x4 = gl.mul(x2, x2)
    x6 = gl.mul(x4, x2)
    return gl.mul(x6, x)


def _mds_light(state):
    """M4-block + circulant-sum external linear layer (batched)."""
    cols = [state[:, i] for i in range(WIDTH)]
    out = []
    for blk in range(0, WIDTH, 4):
        c0, c1, c2, c3 = cols[blk:blk + 4]
        d0 = gl.add(gl.add(gl.add(c0, c0), gl.add(c1, gl.add(c1, c1))),
                    gl.add(c2, c3))
        d1 = gl.add(gl.add(c0, gl.add(c1, c1)),
                    gl.add(gl.add(c2, gl.add(c2, c2)), c3))
        d2 = gl.add(gl.add(c0, c1),
                    gl.add(gl.add(c2, c2), gl.add(c3, gl.add(c3, c3))))
        d3 = gl.add(gl.add(gl.add(c0, gl.add(c0, c0)), c1),
                    gl.add(c2, gl.add(c3, c3)))
        out.extend([d0, d1, d2, d3])
    sums = [gl.add(out[k], out[k + 4]) for k in range(4)]
    return torch.stack([gl.add(out[i], sums[i % 4]) for i in range(WIDTH)],
                       dim=-1)


def _matmul_internal(state, diag):
    tot = gl.sum_axis(state, -1)
    return gl.add(gl.mul(state, diag), tot[:, None])


def perm8_twin(state):
    """Plain-torch perm8, step for step as latticeum_tpu/crypto/poseidon2.py
    (:20-92): (n, 8) -> (n, 8)."""
    dev = state.device
    diag = _const_row(consts.DIAG_8, dev)
    state = _mds_light(state)
    for rc in consts.W8_EXTERNAL_INITIAL:
        state = _mds_light(_sbox(gl.add(state, _const_row(rc, dev))))
    for rc in consts.INTERNAL_22:
        s0 = _sbox(gl.add(state[:, 0], gl.const(rc, dev)))
        state = torch.cat([s0[:, None], state[:, 1:]], dim=1)
        state = _matmul_internal(state, diag)
    for rc in consts.W8_EXTERNAL_TERMINAL:
        state = _mds_light(_sbox(gl.add(state, _const_row(rc, dev))))
    return state


def _kernel_consts(device):
    """The 94 round constants in the kernel's order, once per device."""
    if device not in _consts_on:
        flat = ([v for rc in consts.W8_EXTERNAL_INITIAL for v in rc]
                + [v for rc in consts.W8_EXTERNAL_TERMINAL for v in rc]
                + list(consts.INTERNAL_22) + list(consts.DIAG_8))
        _consts_on[device] = gl.from_int(flat, device)
    return _consts_on[device]


# Lanes per state: the instantiations of csrc/poseidon2.cu.
LANES = (1, 2, 4, 8)


def kernel_lanes(n):
    """S for perm8 and sponge8 over n rows: the fastest on the H100 at the
    smallest measured n at or above this one (PERF.md section 6;
    chip_smoke.py times every S at n = 1, 64, 512 and every power of two
    from 1024 to 16384, then 65536 and 524288, and sponge8 at 1024 ...
    16384 rows of 256 words).  More lanes per state shorten each lane's
    chain and fill the card while n is small; fewer issue fewer
    instructions once it is full."""
    if n <= 2048:
        return 8
    if n <= 4096:
        return 4
    if n <= 16384:
        return 2
    return 1


def _check_lanes(lanes):
    if lanes not in LANES:
        raise ValueError(f"no perm8 form with {lanes} lanes per state; "
                         f"lanes: {LANES}")


def perm8_lanes(state, lanes):
    """perm8 with `lanes` lanes per state."""
    check("state", state, (state.shape[0], WIDTH))
    _check_lanes(lanes)
    if route((state,)) == "cpu":
        return perm8_twin(state)
    out = torch.empty_like(state)
    if state.shape[0]:
        launch("lt_perm8", ptr(state), ptr(out),
               ptr(_kernel_consts(state.device)), state.shape[0], lanes,
               stream())
        perm8.launches += 1
    return out


def perm8(state):
    """Poseidon2 width-8 permutation of every row of `state` (n, 8)
    (replaces pallas_kernels.make_perm8_kernel)."""
    return perm8_lanes(state, kernel_lanes(state.shape[0]))


perm8.launches = 0
counted(perm8, "lt_perm8")


# -- the sponge ---------------------------------------------------------------

def sponge8_twin(rows, perm=perm8_twin):
    """Plain-torch sponge: ceil(L / 4) absorbs, each one `perm` over all
    rows; an absorb of w words overwrites state[0:w] and keeps the rest."""
    n, length = rows.shape
    state = torch.zeros((n, WIDTH), dtype=gl.DTYPE, device=rows.device)
    for pos in range(0, length, RATE):
        w = min(RATE, length - pos)
        state[:, :w] = rows[:, pos:pos + w]
        state = perm(state)
    return state[:, :DIGEST].contiguous()


def sponge8_lanes(rows, lanes):
    """sponge8 with `lanes` lanes per state."""
    if rows.dim() != 2:
        raise ValueError(f"rows: {rows.dim()} dimensions, expected 2")
    check("rows", rows, tuple(rows.shape))
    _check_lanes(lanes)
    if route((rows,)) == "cpu":
        return sponge8_twin(rows)
    n, length = rows.shape
    out = torch.empty((n, DIGEST), dtype=gl.DTYPE, device=rows.device)
    if n:
        launch("lt_sponge8", ptr(rows), ptr(out),
               ptr(_kernel_consts(rows.device)), n, length, lanes, stream())
        sponge8.launches += 1
    return out


def sponge8(rows):
    """Width-8 rate-4 overwrite sponge over every row of `rows` (n, L) of
    field values -> (n, 4) digests (the padding-free sponge of
    poseidon2_ref.hash_narrow), all absorbs of a row in one launch."""
    return sponge8_lanes(rows, kernel_lanes(rows.shape[0]))


sponge8.launches = 0
counted(sponge8, "lt_sponge8")


# -- Merkle levels ------------------------------------------------------------

def hash_rows_narrow(rows):
    """(n, L) rows -> (n, 4) leaf digests (``sponge8``)."""
    return sponge8(rows.contiguous())


def compress_level(digests):
    """(2n, 4) digests -> (n, 4): the truncated perm8 of each adjacent pair
    (poseidon2_ref.compress8)."""
    n = digests.shape[0] // 2
    return perm8(digests.reshape(n, WIDTH))[:, :DIGEST].contiguous()


def merkle_levels_rows(rows):
    """Merkle levels over the rows of a row-major matrix (n, L): leaf i is
    the sponge of row i, the leaves padded to a power of two with the zero
    digest, then compression levels up to the root.  Returns [(2^k, 4)
    tensors], leaves first, root last (latticeum_tpu/zkvm/commitments.py
    merkle_levels over hash_narrow leaves)."""
    return merkle_levels(hash_rows_narrow(rows))


def merkle_levels(digests):
    """Leaf digests (n, 4) padded to a power of two with the zero digest,
    then one compression level after another up to the root: [(2^k, 4)
    tensors], leaves first, root last."""
    n = digests.shape[0]
    npad = 1 << (n - 1).bit_length() if n > 1 else 1
    if npad != n:
        digests = torch.cat([digests, torch.zeros(
            (npad - n, DIGEST), dtype=gl.DTYPE, device=digests.device)])
    levels = [digests]
    while digests.shape[0] > 1:
        digests = compress_level(digests)
        levels.append(digests)
    return levels
