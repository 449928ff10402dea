"""The Poseidon2 width-16 duplex challenger on the device, and the tail of
a chained sum-check round built on it.

Counterpart of ``latticeum_tpu/zkvm/accel_dev_fs.py`` (``perm16_dev``,
``challenger_step``, ``_eqf_dev``, :56-180) and of the small kernels the
JAX package chains after each round's comb (``accel_rounds.py:303-391``:
``_make_weight_lin``, ``_make_weight_fold``, ``_make_chal_fn``, ``_eupd_fn``,
``_eupd3_fn``).  The CUDA body is ``csrc/challenger.cu``.

The challenger is Plonky3's ``DuplexChallenger<Goldilocks, 16, 12>`` as the
host transcript runs it (``host/crypto/poseidon2_ref.py``): an observe
buffers values and duplexes (overwrite ``state[0:12]``, permute) when 12
are pending; a sample pops ``state[11]``, ``state[10]``, ... after one more
duplex of what is pending.  A sum-check round observes the pending values
and the round message, samples the challenge (c0, c1, c2), observes it back
and absorbs it embedded into a ring (24 more values): 27 values, two full
chunks and 3 pending.

``round_tail`` is one round's tail, one launch on the card:

* weighted (the factored rounds): the round's sums (R, 24) at the comb's
  points are extended to the n_msg message points by the Lagrange matrices
  ``lag`` (T, n_msg, R), one per eq table, weighted by
  ``E_k * eqf(point_k, t)`` and summed over the T tables: the message
  (n_msg, 24);
* unweighted (the lin reconstruction rounds): the sums are the message;

then the challenger observes pending + message and samples the challenge,
and (weighted only) each table's running eq prefix becomes
``E_k * eqf(point_k, c)``.  The message, the challenge and the state go
to device buffers; nothing comes back to the host.

A wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel (and counts the launch) or raises.  There is no fallback.
Values are canonical Goldilocks elements in int64 (``field/goldilocks.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..field import fq3, goldilocks as gl
from ..host.crypto import consts
from ..kernels import check, launch, ptr, route, stream
from ..ring import rq

WIDTH, RATE = 16, 12
MAX_TABLES, MAX_MSG, MAX_ROWS, MAX_PENDING = 3, 16, 16, 11
_consts_on = {}      # device -> (166,) kernel constants (csrc/challenger.cu)
_twin_on = {}        # device -> the twin's round constants


# -- the permutation ----------------------------------------------------------

def _sbox(x):
    x2 = gl.mul(x, x)
    return gl.mul(gl.mul(x2, x2), gl.mul(x2, x))


def _mds16(s):
    """The external linear layer on (..., 16): M4 on each block of 4, then
    each element plus the sum of its column over the 4 blocks."""
    blk = s.reshape(s.shape[:-1] + (4, 4))
    c = [blk[..., k] for k in range(4)]                    # (..., 4 blocks)
    t01, t23 = gl.add(c[0], c[1]), gl.add(c[2], c[3])
    alls = gl.add(t01, t23)
    d = torch.stack([gl.add(alls, gl.add(c[k], gl.add(c[(k + 1) % 4],
                                                      c[(k + 1) % 4])))
                     for k in range(4)], dim=-1)           # (..., 4b, 4k)
    cols = gl.sum_axis(d, -2)                              # (..., 4k)
    return gl.add(d, cols[..., None, :]).reshape(s.shape)


def _twin_consts(device):
    if device not in _twin_on:
        _twin_on[device] = tuple(gl.from_int(v, device) for v in (
            consts.W16_EXTERNAL_INITIAL, consts.W16_EXTERNAL_TERMINAL,
            consts.INTERNAL_22, consts.DIAG_16))
    return _twin_on[device]


def perm16_twin(state):
    """Plain-torch Poseidon2 width-16 permutation of every (..., 16) row,
    step for step as accel_dev_fs.perm16_dev: the initial linear layer, 4
    external, 22 internal and 4 external rounds."""
    ext_i, ext_t, int22, diag = _twin_consts(state.device)
    state = _mds16(state)
    for rc in ext_i:
        state = _mds16(_sbox(gl.add(state, rc)))
    for rc in int22:
        s0 = _sbox(gl.add(state[..., :1], rc))
        state = torch.cat([s0, state[..., 1:]], dim=-1)
        state = gl.add(gl.mul(state, diag), gl.sum_axis(state, -1)[..., None])
    for rc in ext_t:
        state = _mds16(_sbox(gl.add(state, rc)))
    return state


def challenger_step_twin(state, buf):
    """Observe the L values of `buf` (pending first), sample 3, observe the
    27 values of the challenge's round trip.  state (16,), buf (L,) ->
    (state', (c0, c1, c2)) with the c_i rank-0 tensors; the caller's next
    pending values are (c0, c1, c2)."""
    nfull, rem = divmod(buf.shape[-1], RATE)
    for k in range(nfull):
        state = perm16_twin(torch.cat([buf[RATE * k:RATE * (k + 1)],
                                       state[RATE:]]))
    if rem:
        state = perm16_twin(torch.cat([buf[RATE * nfull:], state[rem:]]))
    # else the last chunk's duplex already refilled the output buffer (an
    # observe clears it before it appends): the sample pops without one
    chal = state[[11, 10, 9]]
    for _ in range(2):
        state = perm16_twin(torch.cat([chal.repeat(4), state[RATE:]]))
    return state, (chal[0], chal[1], chal[2])


def permutations(length):
    """Permutations of one challenger step over `length` observed values."""
    return length // RATE + (length % RATE > 0) + 2


# -- eq factors ---------------------------------------------------------------

def eqf_at(b3, r3):
    """eqf(b, r) = 1 - b - r + 2br for Fq3 triples of tensors."""
    br = fq3.mul(b3, r3)
    one = (torch.ones_like(br[0]), torch.zeros_like(br[0]),
           torch.zeros_like(br[0]))
    return fq3.add(fq3.sub(fq3.sub(one, b3), r3), fq3.add(br, br))


def eqf_t(b3, t: int):
    """eqf(b, t) = b (2t - 1) + (1 - t) at the integer point t."""
    s = gl.const((2 * t - 1) % gl.P, b3[0].device)
    return (gl.add(gl.mul(b3[0], s), gl.const((1 - t) % gl.P, b3[0].device)),
            gl.mul(b3[1], s), gl.mul(b3[2], s))


# -- the round tail -----------------------------------------------------------

def round_tail_twin(sums, lag, points, E, state, pend, weighted=True):
    """One round's tail in plain torch.  sums (R, 24); weighted: lag
    (T, n_msg, R), points and E (T, 3).  Returns (msg (n_msg, 24),
    chal (3,), state', E')."""
    if weighted:
        ext = gl.sum_axis(gl.mul(lag[..., None], sums[None, None]), -2)
        e3, b3 = fq3.of(E[:, None]), fq3.of(points[:, None])
        n_msg = lag.shape[1]
        w = tuple(torch.cat(c, dim=-1) for c in zip(
            *[fq3.mul(e3, eqf_t(b3, t)) for t in range(n_msg)]))  # (T, n_msg)
        part = fq3.mul(rq._as_slots(ext), tuple(c[..., None] for c in w))
        msg = rq._from_slots(tuple(gl.sum_axis(c, 0) for c in part))
    else:
        msg = sums
    state, chal = challenger_step_twin(state, torch.cat([pend,
                                                         msg.reshape(-1)]))
    if weighted:                        # E_k * eqf(point_k, c), every table
        c3 = tuple(c.expand(E.shape[0]) for c in chal)
        E = torch.stack(fq3.mul(fq3.of(E), eqf_at(fq3.of(points), c3)),
                        dim=-1)
    return msg, torch.stack(chal), state, E


def kernel_consts(device):
    """The 166 constants in the kernel's order, once per device."""
    if device not in _consts_on:
        flat = ([v for rc in consts.W16_EXTERNAL_INITIAL for v in rc]
                + [v for rc in consts.W16_EXTERNAL_TERMINAL for v in rc]
                + list(consts.INTERNAL_22) + list(consts.DIAG_16))
        _consts_on[device] = gl.upload(gl.from_int(flat), device)
    return _consts_on[device]


def _check_tail(sums, lag, points, E, state, pend, msgs, chals, r, weighted):
    nv, n_msg = msgs.shape[0], msgs.shape[1]
    rows = sums.shape[0]
    check("sums", sums, (rows, 24))
    check("state", state, (WIDTH,))
    check("pend", pend, (pend.shape[0],))
    check("msgs", msgs, (nv, n_msg, 24))
    check("chals", chals, (nv, 3))
    if not 0 <= r < nv:
        raise ValueError(f"round {r} outside 0..{nv - 1}")
    if pend.shape[0] > MAX_PENDING:
        raise ValueError(f"{pend.shape[0]} pending values, at most "
                         f"{MAX_PENDING}")
    if not 1 <= n_msg <= MAX_MSG:
        raise ValueError(f"{n_msg} message points outside 1..{MAX_MSG}")
    if not weighted:
        if rows != n_msg:
            raise ValueError(f"unweighted: {rows} sums for {n_msg} points")
        return (sums, state, pend, msgs, chals)
    tables = lag.shape[0]
    if not 1 <= tables <= MAX_TABLES or not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{tables} tables of {rows} sums: at most "
                         f"{MAX_TABLES} of {MAX_ROWS}")
    check("lag", lag, (tables, n_msg, rows))
    check("points", points, (tables, nv, 3))
    check("E", E, (tables, 3))
    return (sums, lag, points, E, state, pend, msgs, chals)


def round_tail(sums, lag, points, E, state, pend, msgs, chals, r,
               weighted=True):
    """Round r's tail (replaces the chain of accel_rounds._make_weight_*,
    _make_chal_fn and _eupd*_fn): writes the message to msgs[r] (msgs
    (nv, n_msg, 24)) and the challenge to chals[r] (chals (nv, 3)), and
    updates the challenger state (16,) and, weighted, E (T, 3) in place.
    pend: the pending values the round observes first (the exported
    input buffer at round 0, chals[r - 1] after it).  points (T, nv, 3):
    row r holds each table's eq point of this round.  Unweighted, lag,
    points and E are None and sums (n_msg, 24) is the message."""
    tensors = _check_tail(sums, lag, points, E, state, pend, msgs, chals, r,
                          weighted)
    if route(tensors) == "cpu":
        msg, chal, st, e = round_tail_twin(
            sums, lag, points[:, r] if weighted else None, E, state, pend,
            weighted)
        msgs[r] = msg
        chals[r] = chal
        state.copy_(st)
        if weighted:
            E.copy_(e)
        return
    null = ctypes.c_void_p(None)
    launch("lt_round_tail", ptr(sums), ptr(lag) if weighted else null,
           ptr(points) if weighted else null, ptr(E) if weighted else null,
           ptr(state), ptr(pend), ptr(msgs), ptr(chals),
           ptr(kernel_consts(sums.device)), lag.shape[0] if weighted else 0,
           msgs.shape[1], sums.shape[0], pend.shape[0], msgs.shape[0], r,
           int(weighted), stream())
    round_tail.launches += 1


round_tail.launches = 0


# -- the permutation chain alone ----------------------------------------------

def perm16_chain_twin(state, n):
    for _ in range(n):
        state = perm16_twin(state)
    return state


def perm16_chain(state, n):
    """n permutations of one state (16,) in a row, in one launch on the
    card: the permutations of a round tail and nothing else, so its time
    is the latency floor of round_tail's design.  Returns the new state."""
    check("state", state, (WIDTH,))
    if route((state,)) == "cpu":
        return perm16_chain_twin(state, n)
    out = state.clone()
    launch("lt_perm16_chain", ptr(out), ptr(kernel_consts(state.device)), n,
           stream())
    perm16_chain.launches += 1
    return out


perm16_chain.launches = 0
