"""The port's device Fiat-Shamir (crypto/challenger.py) against the JAX
package's (zkvm/accel_dev_fs.py and the chain kernels of
zkvm/accel_rounds.py, run on XLA:CPU) and against the host duplex
challenger; the chained sum-check runners against the host sum-check.

* perm16_twin against ``accel_dev_fs.perm16_dev`` and the scalar oracle
  ``poseidon2_ref.perm16``, on seeded states with edge values and the SAGE
  vector of tests/test_poseidon2.py;
* challenger_step_twin against the host ``DuplexChallenger`` (observe L,
  sample 3, observe the 27 values of the challenge's round trip) for
  L in {3, 12, 24, 27, 123, 243} and b + 24 n_msg (b = 0 .. 11, n_msg = 5,
  a fold round), and against ``accel_dev_fs.challenger_step`` at
  L = 3, 12, 24, 27, 120, 123, 243 (each length is one XLA:CPU compile of
  about 9 s: every branch of the step, L % 12 == 0 included);
* round_tail (lin, fold, unweighted) against the composed JAX
  ``_make_weight_lin`` / ``_make_weight_fold``, ``_make_chal_fn`` and
  ``_eupd_fn`` / ``_eupd3_fn``;
* two truncated lin sum-checks in one process with different betas, each
  equal to the host ``sumcheck.prove`` with one fetch (the port cannot
  carry one proof's betas into the next: ROADMAP C.h9).

Tolerance: none (exact integers).  The CUDA kernels are held against the
twins on the card (``cuda`` marker)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.crypto import poseidon2_ref as p2_ref
from latticeum_tpu.crypto.transcript import Transcript
from latticeum_tpu.field import goldilocks as gl_ref, host as H
from latticeum_tpu.nifs import linearization as lin
from latticeum_tpu.poly import mle, sumcheck
from latticeum_tpu.zkvm import accel_dev_fs as DFS, accel_rounds as jax_rounds
from latticeum_tpu.zkvm.accel_fs import _lagrange_ext_consts
from latticeum_tpu.zkvm.accel_t import bitrev_indices
from latticeum_tpu_torch.crypto import challenger
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.zkvm import accel_rounds, comb

P = gl.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = [0, 1, 2, 0xFFFFFFFF, 1 << 32, P - 1, P - 2]


def _sage_v():
    spec = importlib.util.spec_from_file_location(
        "sage_vectors", os.path.join(ROOT, "tests", "test_poseidon2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SAGE_V


def rnd(rng, *shape):
    return rng.integers(0, P, shape, dtype=np.uint64)


def tt(u):
    """A copy of the uint64 array `u` as an int64 tensor (the wrappers
    update some of their arguments in place)."""
    return torch.from_numpy(gl.to_i64_bits(np.array(u, np.uint64)))


def jlimbs(u):
    import jax.numpy as jnp
    u = np.asarray(u, np.uint64)
    return (jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((u >> np.uint64(32)).astype(np.uint32)))


def u64(pair):
    import jax
    lo, hi = jax.device_get(pair)
    return (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))


def ints(x):
    return gl.to_int_lists(x)


# -- the permutation ----------------------------------------------------------

@pytest.fixture(scope="module")
def perm_cases():
    u = rnd(np.random.default_rng(0), 8, 16)
    u[0, :len(EDGES)] = EDGES
    u[1] = P - 1
    u = np.concatenate([u, np.array([_sage_v()], np.uint64)])
    return u, ints(challenger.perm16_twin(tt(u)))


def test_perm16_twin_matches_scalar_oracle(perm_cases):
    u, got = perm_cases
    assert got == [p2_ref.perm16([int(v) for v in row]) for row in u]


def test_perm16_twin_matches_jax_perm16_dev(perm_cases):
    import jax
    u, got = perm_cases
    with B.jax_mode():
        pc = DFS._p2_consts()
        f = jax.jit(lambda s: DFS.perm16_dev(s, pc))
        want = [u64(f(jlimbs(row))).tolist() for row in u]
    assert got == want


# -- one challenger step ------------------------------------------------------

FOLD_LENGTHS = tuple(b + 24 * 5 for b in range(12))


def _step_case(L):
    rng = np.random.default_rng(L)
    return rnd(rng, 16), rnd(rng, L)


def _twin_step(state, buf):
    st, chal = challenger.challenger_step_twin(tt(state), tt(buf))
    return ints(st), [int(c) for c in ints(torch.stack(chal))]


@pytest.mark.parametrize("L", sorted({3, 12, 24, 27, 123, 243}
                                     | set(FOLD_LENGTHS)))
def test_challenger_step_twin_matches_host_duplex(L):
    """The host challenger with the first min(L, 11) values pending (as
    export_for_device leaves them) observes the rest, samples the
    challenge and observes it back (get_challenge, absorb_fq3)."""
    state, buf = _step_case(L)
    ch = p2_ref.DuplexChallenger()
    ch.state = [int(v) for v in state]
    pend = min(L, 11)
    ch.input_buffer = [int(v) for v in buf[:pend]]
    for v in buf[pend:]:
        ch.observe(int(v))
    c = [ch.sample() for _ in range(3)]
    for v in c + H.ntt_from_fq3(tuple(c)):
        ch.observe(v)
    st, chal = _twin_step(state, buf)
    assert chal == c
    assert st == ch.state and ch.input_buffer == c


@pytest.mark.parametrize("L", [3, 12, 24, 27, 120, 123, 243])
def test_challenger_step_twin_matches_jax(L):
    import jax
    state, buf = _step_case(L)
    with B.jax_mode():
        pc = DFS._p2_consts()
        st, chal = jax.jit(lambda s, b: DFS.challenger_step(s, b, pc))(
            jlimbs(state), jlimbs(buf))
        want_st = u64(st).tolist()
        want_c = [int(u64(c)) for c in chal]
    assert _twin_step(state, buf) == (want_st, want_c)


# -- the round tail -----------------------------------------------------------

def _tail_case(kind, seed):
    """Inputs of one round tail: (sums, lag, points, E) as uint64 arrays
    (None unweighted), the state and the pending values."""
    rng = np.random.default_rng(seed)
    if kind == "lin":
        npts, n_msg, b, tables = 4, 5, 5, 1
        lag = np.array([accel_rounds._lagrange_ext_consts(npts, n_msg)],
                       np.uint64)
        rows = npts
    elif kind == "fold":
        npts, n_msg, b, tables = 4, 5, 3, 3
        lag = np.array(accel_rounds.fold_lagrange(npts, n_msg), np.uint64)
        rows = npts + 4
    else:
        n_msg, b, tables, rows = 4, 0, 0, 4
        lag = None
    sums = rnd(rng, rows, 24)
    points = rnd(rng, tables, 3) if tables else None
    E = rnd(rng, tables, 3) if tables else None
    return (sums, lag, points, E, rnd(rng, 16), rnd(rng, b)), n_msg


def _jax_tail(kind, case, n_msg):
    sums, lag, points, E, state, pend = case

    def ext(npts):
        return jlimbs(np.array(_lagrange_ext_consts(npts, n_msg), np.uint64))
    with B.jax_mode():
        if kind == "lin":
            msg = jax_rounds._make_weight_lin(n_msg, sums.shape[0])(
                jlimbs(sums), jlimbs(E[0]), jlimbs(points[0]),
                ext(sums.shape[0]))
        elif kind == "fold":
            npts_h = sums.shape[0] - 4
            msg = jax_rounds._make_weight_fold(n_msg, npts_h)(
                jlimbs(sums), jlimbs(E), jlimbs(points), ext(npts_h), ext(2))
        else:
            msg = jlimbs(sums)
        st, chal = jax_rounds._make_chal_fn()(jlimbs(state), jlimbs(pend),
                                              msg)
        if kind == "lin":
            E2 = u64(jax_rounds._eupd_fn(jlimbs(E[0]), jlimbs(points[0]),
                                         chal))[None]
        elif kind == "fold":
            E2 = u64(jax_rounds._eupd3_fn(jlimbs(E), jlimbs(points), chal))
        else:
            E2 = None
        return u64(msg), u64(chal), u64(st), E2


@pytest.mark.parametrize("kind", ["lin", "fold", "unweighted"])
def test_round_tail_matches_jax_chain(kind):
    """The wrapper on CPU tensors (the twin, written into the round's rows
    and the state and E in place) against the JAX chain's kernels."""
    case, n_msg = _tail_case(kind, seed=len(kind))
    want = _jax_tail(kind, case, n_msg)
    sums, lag, points, E, state, pend = case
    nv, r = 3, 1
    weighted = kind != "unweighted"
    pts = None
    if weighted:
        pts = np.zeros((points.shape[0], nv, 3), np.uint64)
        pts[:, r] = points
    E_t, st_t = (tt(E) if weighted else None), tt(state)
    msgs = torch.zeros((nv, n_msg, 24), dtype=torch.int64)
    chals = torch.zeros((nv, 3), dtype=torch.int64)
    challenger.round_tail(tt(sums), tt(lag) if weighted else None,
                          tt(pts) if weighted else None, E_t, st_t, tt(pend),
                          msgs, chals, r, weighted=weighted)
    assert np.array_equal(gl.to_u64(msgs[r]), want[0])
    assert np.array_equal(gl.to_u64(chals[r]), want[1])
    assert np.array_equal(gl.to_u64(st_t), want[2])
    assert not msgs[0].any() and not chals[2].any()     # only row r written
    if weighted:
        assert np.array_equal(gl.to_u64(E_t), want[3])


def test_round_tail_validates_its_arguments():
    z = lambda *s: torch.zeros(s, dtype=torch.int64)  # noqa: E731
    with pytest.raises(ValueError):       # more pending values than a chunk
        challenger.round_tail(z(4, 24), None, None, None, z(16), z(12),
                              z(2, 4, 24), z(2, 3), 0, weighted=False)
    with pytest.raises(ValueError):       # round outside the buffers
        challenger.round_tail(z(4, 24), None, None, None, z(16), z(3),
                              z(2, 4, 24), z(2, 3), 2, weighted=False)
    with pytest.raises(ValueError):       # lag rows against the sums
        challenger.round_tail(z(4, 24), z(1, 4, 5), z(1, 2, 3), z(1, 3),
                              z(16), z(3), z(2, 4, 24), z(2, 3), 0)
    challenger.round_tail.launches = 0
    challenger.round_tail(z(4, 24), z(1, 4, 4), z(1, 2, 3), z(1, 3), z(16),
                          z(3), z(2, 4, 24), z(2, 3), 0)
    assert challenger.round_tail.launches == 0    # the twin ran


# -- whole sum-checks ---------------------------------------------------------

def _lin_case(seed, nv, n0):
    """A lin sum-check over (Mz..., eq) MLEs truncated to n0 of 2^nv
    columns, on the host and through the port's chained runner."""
    S, signs = [(0, 1, 2), (1,), (2, 2)], (1, -1, 1)
    rng = np.random.default_rng(seed)
    beta = [tuple(int(v) for v in rnd(rng, 3)) for _ in range(nv)]
    mz = rnd(rng, 3, n0, 24)
    with B.numpy_mode():
        eq = mle.build_eq_table(beta, max_rows=n0)
        g = (np.concatenate([(mz & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                             np.asarray(eq[0])[None]]),
             np.concatenate([(mz >> np.uint64(32)).astype(np.uint32),
                             np.asarray(eq[1])[None]]))
        c = gl_ref.from_int(np.array([H.ntt_from_u64(1 if x > 0 else P - 1)
                                      for x in signs], dtype=object))
        two = lin.make_comb_fn2(S)
        th = Transcript(record_samples=True)
        host = sumcheck.prove(th, g, nv, 4, lambda v: two(v, c),
                              eq_info=(beta, 3))
    brev = torch.from_numpy(bitrev_indices((n0 - 1).bit_length()))
    g_t = gl.from_limbs(g).transpose(1, 2)[..., brev].contiguous()
    td = Transcript(record_samples=True)
    before = accel_rounds.fetches
    port = accel_rounds.run_lin_rounds_factored(
        td, g_t, nv, 4, comb.lin_sets(S, signs, 3, "cpu"), beta)
    assert accel_rounds.fetches == before + 1
    final = (np.asarray(host[2][0])[:, 0].astype(np.uint64)
             | (np.asarray(host[2][1])[:, 0].astype(np.uint64)
                << np.uint64(32)))
    return ((host[0], host[1], final.tolist(), th.export_for_device(),
             th.samples),
            (port[0], port[1], ints(port[2]), td.export_for_device(),
             td.samples))


def test_two_lin_sumchecks_with_other_betas_match_host():
    """Two truncated lin sum-checks (3 factored and 3 reconstruction
    rounds) with different betas, one after the other: each equals the
    host sum-check, so the second's reconstruction used its own betas."""
    for seed in (1, 2):
        host, port = _lin_case(seed, 6, 8)
        assert port == host, f"seed {seed}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lin", "fold", "unweighted"])
def test_cuda_round_tail_matches_twin(kind):
    """round_tail on the card against its twin at every pending length
    0 ... 11, then perm16_chain against its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = "cuda"
    rng = np.random.default_rng(70)
    nv = 4
    case, n_msg = _tail_case(kind, seed=len(kind))
    sums, lag, points, E, state, _ = case
    weighted = kind != "unweighted"
    for b in range(12):
        pend = rnd(rng, b)
        pts = rnd(rng, points.shape[0], nv, 3) if weighted else None
        out = []
        for d in ("cpu", dev):
            def on(u):
                return None if u is None else tt(u).to(d)
            E_t, st = on(E), on(state)
            msgs = torch.zeros((nv, n_msg, 24), dtype=torch.int64,
                               device=d)
            chals = torch.zeros((nv, 3), dtype=torch.int64, device=d)
            challenger.round_tail(on(sums), on(lag), on(pts), E_t, st,
                                  on(pend), msgs, chals, 2,
                                  weighted=weighted)
            out.append([x.cpu() for x in (msgs, chals, st)]
                       + ([E_t.cpu()] if weighted else []))
        for a, w in zip(*out):
            assert torch.equal(a, w), (kind, b)
    u = tt(rnd(rng, 16)).to(dev)
    for n in (1, 13):
        assert torch.equal(challenger.perm16_chain(u, n).cpu(),
                           challenger.perm16_chain_twin(u.cpu(), n))
