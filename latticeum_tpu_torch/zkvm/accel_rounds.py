"""Eq-factored (Gruen) sum-check rounds chained on the device, Fiat-Shamir
challenger included.

Counterpart of ``latticeum_tpu/zkvm/accel_rounds.py`` on its default path,
the device chain (``_chain_enabled``, :65-73): ``run_lin_rounds_factored``
(:688-835) and ``run_fold_rounds_factored`` (:1106-1300), with the
truncated lin stack's reconstruction rounds of
``accel_dev_fs.run_fixed_phase_dev`` (:314-345).  Every round of a
sum-check is enqueued on the device: the round's comb kernel (``comb.py``),
then ``challenger.round_tail``, which extends and weights the sums into the
round message, runs the duplex challenger over it and writes the
challenge, which the next round's comb kernel reads from device memory.
Nothing comes back to the host until the sum-check ends; then ONE copy
brings the messages, the challenges, the final evaluations and the
challenger state, and the host transcript takes them up: its absorptions,
its recorded samples (which the collector's ``ReplayTranscript`` replays)
and its challenger (``_chain_bookkeep``, :492-513, and
``accel_dev_fs.finish_fixed_phase_host``, :372-416).  ``fetches`` counts
those copies.  Every value the chain needs from the host (the exported
challenger, the betas and eq points, the Lagrange rows) is uploaded
before its first round, and the reconstruction eq table's factors before
the reconstruction, each in a pinned copy that does not wait.

Messages and challenges are bit-identical to the host path ``nifs/*.prove``
(host sum-check, host transcript).  Shrink rounds run until the arrays are
one column wide; there is no fixed-width phase.  When the lin stack is
truncated (its width below 2^nv, ROADMAP C.h5), the remaining variables
are finished by unfactored rounds over an eq table rebuilt from this call's
betas, scaled by prod eqf(beta_j, r_j) over the device challenges; the
betas are arguments of every call, never kept from an earlier one (the
fault of the JAX package's device path, ROADMAP C.h9).  Those rounds,
their round tails and the folds around them are one
``comb.lin_recon_tail`` launch.

All arrays are t-layout (rows, 24, n) with a bit-reversed hypercube, so a
round pairs the two contiguous halves.

Given a communicator (``parallel/mesh.py``), both sum-checks run sharded:
each rank holds the strided column shard of the stack, so every round's
pairs stay on one rank, and each round's sums are all-reduced (exactly,
mod p) before its round tail, which every rank then runs on the same sums:
challenger states, challenges and messages stay bit-identical to the
unsharded run without a broadcast.  At the round whose kernel would get
fewer local columns than it takes (and at the last round at the latest)
the ranks all-gather their columns once, and every rank finishes the
sum-check unsharded.  Without one, nothing of that runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import challenger
from ..field import fq3, goldilocks as gl
from ..host.field import host as H
from ..host.utils import tracing
from ..ring import rq
from . import comb

P = gl.P
fetches = 0          # device -> host copies made by the sum-checks


# -- host-side constants ------------------------------------------------------

# copied from latticeum_tpu/zkvm/accel_fs.py:177
def _lagrange_ext_consts(npts: int, n_targets: int):
    """(n_targets, npts) int matrix: row t gives Σ_j M[t,j]·S(j) = S(t) for a
    degree-(npts-1) polynomial known at points 0..npts-1.  Exact mod p."""
    M = np.empty((n_targets, npts), dtype=object)
    for t in range(n_targets):
        for j in range(npts):
            num, den = 1, 1
            for m in range(npts):
                if m == j:
                    continue
                num = num * (t - m) % P
                den = den * (j - m) % P
            M[t, j] = num * pow(den, P - 2, P) % P
    return M


def fold_lagrange(npts_h, n_msg):
    """(3, n_msg, npts_h + 4) Lagrange rows over the fold's round sums
    [h at 0 .. npts_h - 1, c1 at 0, c2 at 0, c1 at 1, c2 at 1] (the layout
    of the JAX package's ``_make_weight_fold``): tables r1 and r2 extend
    their linear c term from {0, 1}, table beta the h sums."""
    ext_h = _lagrange_ext_consts(npts_h, n_msg)
    ext_c = _lagrange_ext_consts(2, n_msg)
    lag = np.zeros((3, n_msg, npts_h + 4), dtype=object)
    for tbl in range(2):
        lag[tbl, :, npts_h + tbl] = ext_c[:, 0]
        lag[tbl, :, npts_h + 2 + tbl] = ext_c[:, 1]
    lag[2, :, :npts_h] = ext_h
    return lag


def mu_powers(mu_s, K, TAU=3):
    """mu_k^{d+1}, k-major (row k*TAU + d) -> host list of Fq3 triples."""
    out = []
    for k in range(2 * K):
        p = (1, 0, 0)
        for _d in range(TAU):
            p = H.fq3_mul(p, tuple(int(x) % P for x in mu_s[k]))
            out.append(p)
    return out


# -- the host boundary of a chained sum-check ---------------------------------

def _ints(values, device):
    return gl.upload(gl.from_int(values), device)


def _export(transcript, device):
    """The host challenger's state (16,) and pending input (b <= 11,) on
    `device`.  Valid at a sum-check's start, where an observe comes next."""
    state, pending = transcript.export_for_device()
    return _ints(state, device), _ints(pending, device)


def _pending(pend0, chals, r):
    """What round r observes first: the exported input at round 0, the
    previous challenge after it."""
    return pend0 if r == 0 else chals[r - 1]


def _fetch(*tensors):
    """One device -> host copy of all `tensors`, counted in `fetches` (and
    by the tracer, from a card, as gl.FETCH)."""
    global fetches
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if tracing.active() and flat.device.type != "cpu":
        tracing.add(gl.FETCH)
    flat = flat.cpu()
    fetches += 1
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.reshape(t.shape) for p, t in zip(parts, tensors)]


def _take_up(transcript, msgs, chals, state):
    """The host transcript takes up a fetched sum-check: each round's
    message joins its absorptions and each challenge its recorded samples;
    its challenger gets the final state, the last challenge pending.
    Returns (proof rows, challenges) as host ints."""
    proof = gl.to_int_lists(msgs)
    out = [tuple(c) for c in gl.to_int_lists(chals)]
    for msg, c in zip(proof, out):
        transcript.absorptions.append([list(row) for row in msg])
        if transcript.samples is not None:
            transcript.samples.extend(c)
    transcript.import_from_device(gl.to_int_lists(state), list(out[-1]))
    return proof, out


def _gather_round(width, world, rounds):
    """The round at whose start a sharded sum-check over `width` global
    columns all-gathers them: the first whose comb kernel would get fewer
    local columns than it takes (2 at round 0, 4 after: comb.py's width
    checks; the input halves each round after the first), and the last
    round at the latest, so each sum-check gathers exactly once.  The
    rounds before it are the sharded ones, each with one all-reduce.  An
    unsharded sum-check has -1 (it neither gathers nor reduces)."""
    local = width // world
    return next((r for r in range(rounds)
                 if local >> max(r - 1, 0) < (4 if r else 2)), rounds - 1)


def _world(comm):
    return 1 if comm is None else comm.world


# -- linearization ------------------------------------------------------------

def _factored_rounds(n0, nv):
    """Rounds of the lin stack before it is one column wide: round 0 pairs
    the n0 columns, each later round folds first (comb.lin_roundr)."""
    r, width = 0, n0
    while r < nv and (width // 2 if r else width) >= 2:
        width //= 2 if r else 1
        r += 1
    return r


def _eqf_product(betas, chals):
    """prod_j eqf(beta_j, r_j) over (k, 3) device tensors -> Fq3 triple."""
    e = challenger.eqf_at(fq3.of(betas), fq3.of(chals))
    zero = torch.zeros((), dtype=gl.DTYPE, device=betas.device)
    out = (zero + 1, zero, zero)
    for j in range(betas.shape[0]):
        out = fq3.mul(out, tuple(c[j] for c in e))
    return out


def _lin_reconstruct(mz, r, sets, betas, scale, state, pend0, msgs, chals):
    """Unfactored rounds r..nv-1 of a truncated lin stack ((nv, degree + 1)
    = msgs.shape[:2]), one comb.lin_recon_tail launch: mz the Mz rows
    after the factored rounds (t, 24, 2), folded at chals[r - 1] into
    column 0 of a 2^(nv-r) wide table (mz (t, 24, 1) as it is when r is
    0), under the eq row: the eq table of the remaining `betas` (host Fq3
    triples, uploaded here), whose weight is `scale` = prod eqf(beta_j,
    r_j) over the rounds before, a (3,) device tensor.  Each round's
    message is its plain sums at degree+1 points, through the unweighted
    round tail.  Returns the final rows [Mz..., eq], folded and scaled."""
    return comb.lin_recon_tail(mz.contiguous(),
                               _ints([list(b) for b in betas], mz.device),
                               scale, state, pend0, msgs, chals, sets, r)


def run_lin_rounds_factored(transcript, g_t, nv, degree, sets, beta_s,
                            recon_betas=None, log=None, comm=None):
    """Eq-factored linearization sum-check, chained on the device.

    g_t: (t+1, 24, n0) t-layout stack, eq row last (n0 <= 2^nv, a power of
    two); sets: the multisets with their constants (comb.lin_sets for +-1
    signs, comb.lin_sets_general for any rings); beta_s: this proof's
    betas.  Each round folds the previous challenge into the Mz rows and
    evaluates q = sum_i c_i prod Mz_j at deg(q)+1 = degree points, weighted
    by the pair-summed eq table (lin_round0 / lin_roundr);
    the round tail extends them to the degree+1 message points and weights
    them by E * eqf(beta_r, t); the eq table advances by pair sums only.
    A truncated stack finishes with the reconstruction rounds over the eq
    table of `recon_betas` (beta_s unless given: chip_smoke.py replays the
    JAX package's stale betas, ROADMAP C.h9, through it).  With a
    communicator `comm`, g_t is this rank's strided column shard of the
    stack (see the module docstring).  Returns (proof, chals, final): host
    ints, and the final rows [Mz..., eq] as a (t+1, 24) host tensor."""
    dev = g_t.device
    t_rows = g_t.shape[0] - 1
    n0 = g_t.shape[-1] * _world(comm)
    npts_q, n_msg = degree, degree + 1
    n_fact = _factored_rounds(n0, nv)
    if comm is not None and not n_fact:
        raise ValueError(f"a {n0}-column lin stack has no round to shard")
    gather = _gather_round(n0, comm.world, n_fact) if comm else -1
    transcript.absorb_u64(nv)
    transcript.absorb_u64(degree)
    state, pend0 = _export(transcript, dev)
    lag = _ints([_lagrange_ext_consts(npts_q, n_msg)], dev)
    betas = _ints([[list(b) for b in beta_s]], dev)          # (1, nv, 3)
    E = _ints([[1, 0, 0]], dev)
    if n_fact < nv:
        own = recon_betas is None
        recon = beta_s if own else recon_betas
        if not own:
            recon_d = _ints([list(b) for b in recon[:n_fact]],
                            dev).reshape(n_fact, 3)
    # every round writes its row of both
    msgs = torch.empty((nv, n_msg, 24), dtype=gl.DTYPE, device=dev)
    chals = torch.empty((nv, 3), dtype=gl.DTYPE, device=dev)

    mz, eq = g_t[:t_rows], g_t[t_rows]
    for r in range(n_fact):
        if r == gather:
            mz, eq = comm.all_gather_cols(mz, eq)
        Tc = comb.pair_sum(eq)
        if r == 0:
            Sq = comb.lin_round0(mz.contiguous(), Tc, sets, npts_q)
        else:
            Sq, mz = comb.lin_roundr(mz, Tc, chals[r - 1], sets, npts_q)
        if r < gather:
            Sq = comm.all_reduce_field(Sq)
        challenger.round_tail(Sq, lag, betas, E, state,
                              _pending(pend0, chals, r), msgs, chals, r)
        eq = Tc
    if n_fact < nv:
        # E is prod_{j < n_fact} eqf(beta_j, r_j) already
        scale = (E[0] if own else
                 torch.stack(_eqf_product(recon_d, chals[:n_fact])))
        final = _lin_reconstruct(mz, n_fact, sets, recon[n_fact:], scale,
                                 state, pend0, msgs, chals)
    else:
        if n_fact:
            mz = comb.fold_t(mz, chals[n_fact - 1])
        # the unfactored eq row equals E * T (T the carried pair-sum table)
        final = torch.cat([mz, rq.ntt_scalar_mul_t(eq, fq3.of(E[0]))[None]])
        final = final[..., 0]
    msgs, chals, final, state = _fetch(msgs, chals, final, state)
    proof, out = _take_up(transcript, msgs, chals, state)
    if log:
        log(f"      lin rounds: {n_fact} factored + {nv - n_fact} "
            f"reconstruction (n0={n0}), one fetch")
    return proof, out, final


# -- folding ------------------------------------------------------------------

def fold_round_sums(eqs, c2r, t_s, mu, b_small, r3):
    """One fold round over the columns at hand: the sums [h at 2*b_small
    points, c1 and c2 at 0, c1 and c2 at 1] (2*b_small + 4, 24), the
    pair-summed eq tables, and the c and f_hat rows (after round 0 folded
    at r3 first; r3 None at round 0).  Two launches fill the sums' rows:
    comb.fold_c_round the c terms (and the pair sums, which the tail comb
    reads), the tail comb the h sums."""
    npts = 2 * b_small
    sums = torch.empty((npts + 4, 24), dtype=gl.DTYPE, device=t_s.device)
    c2r, Tn = comb.fold_c_round(c2r, eqs, r3, sums[npts:])
    if r3 is None:
        comb.fold_round0(t_s, Tn[2], mu, b_small, out=sums[:npts])
    else:
        _, t_s = comb.fold_roundr(t_s, Tn[2], mu, r3, b_small,
                                  out=sums[:npts])
    return sums, Tn, c2r, t_s


def run_fold_rounds_factored(transcript, head, tail, nv, degree, mu_s,
                             eq_points, b_small, K, TAU=3, log=None,
                             comm=None):
    """Eq-factored folding sum-check, chained on the device.

    head: (5, 24, n) rows [eq_r1, c1, eq_r2, c2, eq_beta]; tail: the
    (2K*TAU, 24, n) f_hat rows, n = 2^nv; eq_points = (r1, r2, beta) host Fq3
    lists; mu_s the 2K host mu challenges.  Each round folds the challenge
    into the f_hat rows (fold_roundr) and the c rows, pair-sums the three eq
    tables, evaluates h at 2*b_small points over the tail (T_beta-weighted,
    fold_round0 / fold_roundr) and the two linear c terms at {0, 1}
    (T_r-weighted; comb.fold_c_round); the round tail extends and weights
    the three tables' sums into the message.  One comb.fold_c_end launch
    makes the final rows.  With a communicator `comm`, head and tail are
    this rank's strided column shards (see the module docstring).  Returns
    (proof, chals, final): host ints, and the final rows [eq1, c1, eq2, c2,
    eq_beta, f_hat...] as a host tensor."""
    dev = tail.device
    n0 = tail.shape[-1] * _world(comm)
    if n0 != 1 << nv:
        raise ValueError(f"fold sum-check needs full-width MLEs "
                         f"({n0} != 2^{nv})")
    gather = _gather_round(n0, comm.world, nv) if comm else -1
    npts_h, n_msg = 2 * b_small, degree + 1
    transcript.absorb_u64(nv)
    transcript.absorb_u64(degree)
    state, pend0 = _export(transcript, dev)
    lag = _ints(fold_lagrange(npts_h, n_msg), dev)
    mu = _ints([list(m) for m in mu_powers(mu_s, K, TAU)], dev)
    points = _ints([[list(p) for p in tbl] for tbl in eq_points], dev)
    E = _ints([[1, 0, 0]] * 3, dev)
    msgs = torch.zeros((nv, n_msg, 24), dtype=gl.DTYPE, device=dev)
    chals = torch.zeros((nv, 3), dtype=gl.DTYPE, device=dev)

    t_s = tail.contiguous()
    c2r, eqs = head[1:4:2], head[0::2]
    for r in range(nv):
        if r == gather:
            t_s, c2r, eqs = comm.all_gather_cols(t_s, c2r, eqs)
        sums, eqs, c2r, t_s = fold_round_sums(eqs, c2r, t_s, mu, b_small,
                                              chals[r - 1] if r else None)
        if r < gather:
            sums = comm.all_reduce_field(sums)
        challenger.round_tail(sums, lag, points, E, state,
                              _pending(pend0, chals, r), msgs, chals, r)
    final = comb.fold_c_end(c2r, eqs, t_s, chals[nv - 1], E)[..., 0]
    msgs, chals, final, state = _fetch(msgs, chals, final, state)
    proof, out = _take_up(transcript, msgs, chals, state)
    if log:
        log(f"      fold rounds: {nv} factored (n0={n0}), one fetch")
    return proof, out, final
