"""The port's native Poseidon2 core (host/native/poseidon2.cpp) against the
JAX package's pure-Python oracle, latticeum_tpu.crypto.poseidon2_ref, and
its round constants, on the values where branch-free and lazily reduced
arithmetic could go wrong.  The core takes its constants from the port's
own copy, so an error in that copy shows here too.

  * states of all 0, all p - 1, all p - 2, mixes of 2^32 - 1, 2^32, 2^63
    and p - 2^32, states within 2^32 of p (the linear layer's and the
    internal rounds' 128-bit sums pass 2^64 many times) and raw u64 in
    [p, 2^64), for perm8 and perm16 and a chain of 256 perm16 calls;
  * inputs walked back through the oracle's inverse rounds, so that an
    s-box squares 2^48, 2^56 or 2^63 (the 128-bit reduction's borrow)
    and output lanes are a multiple of p summed unreduced (the last
    conditional subtract);
  * the sponges, the Merkle compression and the duplex challenger on raw
    u64 in [p, 2^64) (the absorb path's conditional subtract) and on
    edge values, at lengths around each rate;
  * the duplex challenger's state across a partial input buffer and
    through Transcript.export_for_device / import_from_device;
  * every value the C ABI exposes (states, digests, the challenger's
    sponge state and buffers) is canonical, below p.

Tolerance: none (exact integers).  Skipped where no C++ compiler builds
the core (the transcript then runs the oracle itself).
"""

import numpy as np
import pytest

from latticeum_tpu.crypto import consts, poseidon2_ref as p2
from latticeum_tpu_torch.host.crypto import native
from latticeum_tpu_torch.host.crypto.transcript import Transcript

P = p2.P
EDGES = [0, 1, 2**32 - 1, 2**32, 2**63, P - 2**32, P - 2, P - 1]


@pytest.fixture(scope="module", autouse=True)
def core():
    if not native.available():
        pytest.skip("no native Poseidon2 core (no C++ compiler)")


def _state(kind, width, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return [0] * width
    if kind == "p-1":
        return [P - 1] * width
    if kind == "p-2":
        return [P - 2] * width
    if kind == "edge_mix":
        return [EDGES[(3 * i + seed) % len(EDGES)] for i in range(width)]
    if kind == "near_p":
        return [int(v) for v in rng.integers(P - 2**32, P, width,
                                             dtype=np.uint64)]
    if kind == "above_p":
        return [int(v) for v in rng.integers(P, 2**64 - 1, width,
                                             dtype=np.uint64, endpoint=True)]
    raise ValueError(kind)


KINDS = ["zeros", "p-1", "p-2", "edge_mix", "near_p", "above_p"]


def _canonical(vals):
    return all(0 <= int(v) < P for v in vals)


def _perms(width):
    """-> (the core's permutation, the oracle's) of a width."""
    return ((native.perm8, p2.perm8) if width == 8
            else (native.perm16, p2.perm16))


def _constants(width):
    """-> (external initial, external terminal, diagonal) of a width."""
    if width == 8:
        return (consts.W8_EXTERNAL_INITIAL, consts.W8_EXTERNAL_TERMINAL,
                consts.DIAG_8)
    return (consts.W16_EXTERNAL_INITIAL, consts.W16_EXTERNAL_TERMINAL,
            consts.DIAG_16)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", [8, 16])
def test_perm_matches_oracle(width, kind):
    native_perm, ref_perm = _perms(width)
    for seed in range(4):
        state = _state(kind, width, seed)
        got = native_perm(state)
        assert got == ref_perm(state), (kind, seed)
        assert _canonical(got)


def test_perm16_chain_matches_oracle():
    state = _state("edge_mix", 16)
    ref = list(state)
    for i in range(256):
        state = native.perm16(state)
        ref = p2.perm16(ref)
        assert state == ref, i
        assert _canonical(state)


INV7 = pow(7, -1, P - 1)                 # x -> x^INV7 inverts the s-box


def _matrix(fn, width):
    cols = [fn([int(i == j) for i in range(width)]) for j in range(width)]
    return [[cols[j][i] for j in range(width)] for i in range(width)]


def _inverse(m):
    """Gauss-Jordan inverse mod p."""
    w = len(m)
    a = [list(row) + [int(i == j) for j in range(w)]
         for i, row in enumerate(m)]
    for c in range(w):
        r = next(r for r in range(c, w) if a[r][c])
        a[c], a[r] = a[r], a[c]
        inv = pow(a[c][c], -1, P)
        a[c] = [v * inv % P for v in a[c]]
        for r in range(w):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [(v - f * u) % P for v, u in zip(a[r], a[c])]
    return [row[w:] for row in a]


def _apply(m, v):
    return [sum(x * y for x, y in zip(row, v)) % P for row in m]


def _input_for(width, k, state):
    """The permutation's input whose state before round k (0-29: 4
    external, 22 internal, 4 external rounds, after the first linear
    layer; 30: the output) is `state`, by the oracle's rounds inverted."""
    ext_init, ext_term, diag = _constants(width)
    rounds = ([("ext", rc) for rc in ext_init]
              + [("int", rc) for rc in consts.INTERNAL_22]
              + [("ext", rc) for rc in ext_term])
    me_inv = _inverse(_matrix(p2.mds_light, width))
    mi_inv = _inverse(_matrix(lambda v: p2._matmul_internal(v, diag), width))
    s = list(state)
    for kind, rc in reversed(rounds[:k]):
        if kind == "ext":
            s = [(pow(x, INV7, P) - c) % P
                 for x, c in zip(_apply(me_inv, s), rc)]
        else:
            s = _apply(mi_inv, s)
            s[0] = (pow(s[0], INV7, P) - rc) % P
    return _apply(me_inv, s)


def _crafted(width, case):
    """-> a permutation input that takes the case's rarely taken path."""
    if case == "external_sbox_borrow":
        # the first external round's s-box inputs: x^2 = 2^96, 2^112, 2^126
        xs = [2**48, 2**56, 2**63, P - 2**48, 2**48 + 1, 2**32, P - 1, 0]
        rc = _constants(width)[0][0]
        before = [(xs[i % 8] - rc[i]) % P for i in range(width)]
        return _input_for(width, 0, before)
    if case == "internal_sbox_borrow":
        # the first internal round's s-box input 2^56: x^2 = 2^112
        before = [2**56 - consts.INTERNAL_22[0]] + EDGES * 2
        return _input_for(width, 4, before[:width])
    # the last linear layer's input v (2 c0 + 3 c1 + c2 + c3 = p - 1 + 1)
    # gives lanes 0 and 4 a multiple of p, however v's lanes are held
    v = [0, 0, P - 1, 1] + [0] * (width - 4)
    return _input_for(width, 30, p2.mds_light(v))


@pytest.mark.parametrize("case", ["external_sbox_borrow",
                                  "internal_sbox_borrow",
                                  "output_multiple_of_p"])
@pytest.mark.parametrize("width", [8, 16])
def test_perm_matches_oracle_on_crafted_rounds(width, case):
    native_perm, ref_perm = _perms(width)
    state = _crafted(width, case)
    want = ref_perm(state)
    if case == "output_multiple_of_p":
        assert want[0] == want[4] == 0
    got = native_perm(state)
    assert got == want
    assert _canonical(got)


def _stream(kind, n, seed=0):
    """n values: edge values or raw u64 in [p, 2^64) (the % P path)."""
    if kind == "edge":
        return [EDGES[(5 * i + seed) % len(EDGES)] for i in range(n)]
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(P, 2**64 - 1, n, dtype=np.uint64,
                                         endpoint=True)]


@pytest.mark.parametrize("kind", ["edge", "above_p"])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 8, 11, 12, 13, 24, 25, 100])
def test_sponges_match_oracle(n, kind):
    vals = _stream(kind, n, seed=n)
    narrow, wide = native.hash_narrow(vals), native.hash_wide(vals)
    assert narrow == p2.hash_narrow(vals)
    assert wide == p2.hash_wide(vals)
    assert _canonical(narrow) and _canonical(wide)


@pytest.mark.parametrize("kind", ["edge", "above_p"])
def test_rows_and_compression_match_oracle(kind):
    rows = np.array(_stream(kind, 6 * 9, seed=1),
                    dtype=np.uint64).reshape(6, 9)
    leaves = native.hash_rows_narrow(rows)
    assert [[int(v) for v in r] for r in leaves] == \
        [p2.hash_narrow([int(v) for v in r]) for r in rows]
    digests = np.array([_state("edge_mix", 4, s) for s in range(4)]
                       + [[P - 1] * 4] * 2 + [_state("near_p", 4, 9)] * 2,
                       dtype=np.uint64)
    level = native.compress_level(digests)
    want = [p2.compress8([int(v) for v in digests[2 * i]],
                         [int(v) for v in digests[2 * i + 1]])
            for i in range(4)]
    assert [[int(v) for v in r] for r in level] == want
    assert _canonical(leaves.ravel()) and _canonical(level.ravel())


def _exposed(ch):
    """The values of the challenger's state the C ABI exposes."""
    return [int(v) for v in ch.st[:16]] + [int(v) for v in ch.st[18:42]]


@pytest.mark.parametrize("kind", ["edge", "above_p"])
def test_challenger_matches_duplex_oracle(kind):
    ch, ref = native.NativeChallenger(), p2.DuplexChallenger()
    vals = _stream(kind, 200, seed=3)
    pos = 0
    for take in [1, 11, 12, 13, 0, 5, 24, 7, 30, 2]:
        ch.observe_many(vals[pos:pos + take])
        for v in vals[pos:pos + take]:
            ref.observe(v)
        pos += take
        for _ in range(take % 4):
            assert ch.sample() == ref.sample()
        assert ch.state == ref.state
        assert int(ch.st[16]) == len(ref.input_buffer)
        assert _canonical(_exposed(ch))
    for _ in range(30):                         # past one output buffer
        assert ch.sample() == ref.sample()
    ch.observe(vals[-1])
    ref.observe(vals[-1])
    assert ch.sample() == ref.sample()
    assert _canonical(_exposed(ch))


def _python_transcript():
    t = Transcript()
    t.ch = p2.DuplexChallenger()
    return t


@pytest.mark.parametrize("kind", ["edge", "above_p"])
@pytest.mark.parametrize("pending", [0, 1, 5, 11])
def test_transcript_export_import_round_trip(pending, kind):
    t, ref = Transcript(), _python_transcript()
    assert isinstance(t.ch, native.NativeChallenger)
    vals = _stream(kind, 3 * 12 + (pending - 3) % 12, seed=pending)
    for tr in (t, ref):
        tr.absorb_slice([[P - 1] * 24, EDGES * 3])
        tr.get_challenge()                      # leaves 3 values pending
    t.ch.observe_many(vals)
    for v in vals:
        ref.ch.observe(v)
    state, buf = t.export_for_device()
    assert (state, buf) == ref.export_for_device()
    assert len(buf) == pending
    assert _canonical(state) and _canonical(buf)

    # the device hands back an edge state, maybe unreduced, and a buffer
    back_state = EDGES + _stream(kind, 8, seed=7)
    back_buf = _stream(kind, pending, seed=11)
    for tr in (t, ref):
        tr.import_from_device(back_state, back_buf)
    assert t.export_for_device() == ref.export_for_device()
    assert _canonical(_exposed(t.ch))
    for tr in (t, ref):
        tr.absorb_fq3((P - 1, 2**63, 2**32))
    assert t.get_challenge() == ref.get_challenge()
    assert t.squeeze_bytes(20) == ref.squeeze_bytes(20)
    assert t.ch.state == ref.ch.state
    assert _canonical(_exposed(t.ch))
