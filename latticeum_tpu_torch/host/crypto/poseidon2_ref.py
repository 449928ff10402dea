"""Host-side (Python int) Poseidon2 over Goldilocks: permutations, sponges,
compression, and the duplex challenger.

Bit-exact mirror of the reference's Plonky3-based construction:
  * width-16 "wide" permutation with recorded intermediate round states
    (latticeum/crates/zkvm/src/poseidon2.rs:100-172),
  * width-8 permutation (Plonky3 ``Poseidon2Goldilocks<8>`` built with the
    reference's constants, poseidon2.rs:38 + commitments.rs:54-57),
  * padding-free sponge ``hash_iter`` (poseidon2.rs:206-235, identical to
    Plonky3's PaddingFreeSponge loop),
  * truncated-permutation 2-to-1 compression (poseidon2.rs:41-42),
  * DuplexChallenger width 16 / rate 12 (fiat_shamir.rs:20-21).

Structure per round (8 full = 4+4, 22 partial, s-box x^7):
  external: state = M_E @ state once up front, then per round
            state = M_E @ (state + rc)^7
  internal: state[0] = (state[0] + rc)^7; state = (Diag(d) + J) @ state

The hot batched variants live in poseidon2.py (JAX); this module is the
oracle and the host-side transcript engine.
"""

from __future__ import annotations

from ..utils import tracing
from . import consts
from .native import PERMS

P = 18446744069414584321


def _sbox(x: int) -> int:
    x2 = x * x % P
    x3 = x2 * x % P
    x4 = x2 * x2 % P
    return x4 * x3 % P


def _m4_chunk(c):
    """Apply M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] to a 4-vector."""
    c0, c1, c2, c3 = c
    return [
        (2 * c0 + 3 * c1 + c2 + c3) % P,
        (c0 + 2 * c1 + 3 * c2 + c3) % P,
        (c0 + c1 + 2 * c2 + 3 * c3) % P,
        (3 * c0 + c1 + c2 + 2 * c3) % P,
    ]


def mds_light(state):
    """External linear layer for width 8 or 16 (poseidon2.rs:243-268)."""
    w = len(state)
    assert w % 4 == 0
    s = []
    for i in range(0, w, 4):
        s.extend(_m4_chunk(state[i:i + 4]))
    sums = [sum(s[j + k] for j in range(0, w, 4)) % P for k in range(4)]
    return [(s[i] + sums[i % 4]) % P for i in range(w)]


def _matmul_internal(state, diag):
    tot = sum(state) % P
    return [(x * d + tot) % P for x, d in zip(state, diag)]


def _perm_generic(state, ext_init, ext_term, internal, diag,
                  record: bool = False):
    state = [x % P for x in state]
    inter = {"after_initial_mds": None, "after_ext_init": [],
             "after_internal": [], "after_ext_term": []}
    state = mds_light(state)
    if record:
        inter["after_initial_mds"] = list(state)
    for rc in ext_init:
        state = mds_light([_sbox((x + c) % P) for x, c in zip(state, rc)])
        if record:
            inter["after_ext_init"].append(list(state))
    for rc in internal:
        state = [_sbox((state[0] + rc) % P)] + state[1:]
        state = _matmul_internal(state, diag)
        if record:
            inter["after_internal"].append(list(state))
    for rc in ext_term:
        state = mds_light([_sbox((x + c) % P) for x, c in zip(state, rc)])
        if record:
            inter["after_ext_term"].append(list(state))
    return (state, inter) if record else state


def perm16(state, record: bool = False):
    return _perm_generic(state, consts.W16_EXTERNAL_INITIAL,
                         consts.W16_EXTERNAL_TERMINAL, consts.INTERNAL_22,
                         consts.DIAG_16, record)


def perm8(state):
    return _perm_generic(state, consts.W8_EXTERNAL_INITIAL,
                         consts.W8_EXTERNAL_TERMINAL, consts.INTERNAL_22,
                         consts.DIAG_8)


def _hash_iter(values, width, rate, perm, out=4, record=False):
    """Padding-free sponge (poseidon2.rs:206-235)."""
    state = [0] * width
    it = iter(values)
    states = []
    done = False
    while not done:
        i = 0
        while i < rate:
            try:
                state[i] = next(it) % P
            except StopIteration:
                done = True
                break
            i += 1
        if done and i == 0:
            break
        if record:
            state, inter = perm(state, True)
            states.append(inter)
        else:
            state = perm(state)
    return (state[:out], states) if record else state[:out]


def hash_wide(values, record: bool = False):
    """Width-16 rate-12 sponge -> 4-element digest (+ intermediates)."""
    return _hash_iter(values, 16, 12, perm16, record=record)


def hash_narrow(values):
    """Width-8 rate-4 sponge -> 4-element digest."""
    return _hash_iter(values, 8, 4, lambda s, r=False: perm8(s))


def compress8(left, right):
    """TruncatedPermutation<perm8, 2, 4, 8>: perm([l||r])[:4]."""
    state = list(left) + list(right)
    assert len(state) == 8
    return perm8(state)[:4]


class DuplexChallenger:
    """Plonky3 DuplexChallenger<Goldilocks, perm16, 16, 12>.

    observe() buffers up to RATE inputs and duplexes when full; sample()
    duplexes if there is pending input (or no output) and pops from the END
    of the output buffer (state[11] first).
    With the tracer on, each duplex counts one permutation (PERMS).
    """

    WIDTH = 16
    RATE = 12

    def __init__(self):
        self.state = [0] * self.WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def _duplex(self):
        assert len(self.input_buffer) <= self.RATE
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        if tracing.active():
            tracing.add(PERMS)
        self.state = perm16(self.state)
        self.output_buffer = list(self.state[: self.RATE])

    def observe(self, value: int):
        self.output_buffer.clear()
        self.input_buffer.append(value % P)
        if len(self.input_buffer) == self.RATE:
            self._duplex()

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def squeeze_bytes(self, n: int) -> bytes:
        """fiat_shamir.rs:88-102: little-endian bytes of canonical samples."""
        out = bytearray()
        while len(out) < n:
            val = self.sample()
            take = min(n - len(out), 8)
            out.extend(val.to_bytes(8, "little")[:take])
        return bytes(out)
