"""Bit-exact replication of the reference's RNG chain for the Ajtai matrix.

The reference seeds `ark_std::test_rng()` and draws exactly one random ring
element for the whole commitment matrix
(`AjtaiCommitmentScheme::rand`, commitment_scheme.rs:29-33: the nested
`vec![vec![R::rand(rng); n]; kappa]` evaluates `R::rand` ONCE and clones it
across all n columns AND all kappa rows — the entire matrix is one ring
element).  Reproducing that element here unlocks bit-exact accumulator /
digest parity with the Rust reference (BASELINE.md target #1).

Chain replicated:
  * `ark_std::test_rng()` = rand 0.8 `StdRng::from_seed(ARK_SEED)`
    = ChaCha12Rng (rand_chacha 0.3) with the pinned ark-std seed.
  * `GoldilocksRingNTT::rand` (ntt_form.rs:205-211) = 8 sequential
    `Fq3::rand` draws = 24 `Fq::rand` draws (c0, c1, c2 per slot).
  * `Fq::rand` (ark-ff UniformRand for Fp64): draw a u64 limb via
    `rng.gen::<u64>()`, REPR_SHAVE_BITS = 0 for the 64-bit Goldilocks
    modulus, REJECT if >= p; the accepted limb is the MONTGOMERY
    representation, so the canonical value is raw * 2^-64 mod p.
"""

from __future__ import annotations

P = 18446744069414584321  # Goldilocks

# ark-std 0.4 test_rng seed (ark-std/src/rand_helper.rs)
ARK_TEST_SEED = bytes([
    1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
])

# 2^-64 mod p: canonical value of a Montgomery-represented raw limb
INV_2_64 = pow(1 << 64, P - 2, P)

_M32 = 0xFFFFFFFF


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & _M32
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & _M32


def chacha_block(key_words, counter, nonce_words, rounds):
    """One ChaCha block (djb variant: 64-bit counter in words 12-13),
    little-endian u32 words; returns the 16 output words."""
    state = ([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
             + list(key_words)
             + [counter & _M32, (counter >> 32) & _M32]
             + list(nonce_words))
    s = list(state)
    for _ in range(rounds // 2):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return [(x + y) & _M32 for x, y in zip(s, state)]


class ChaChaRng:
    """rand_chacha-compatible ChaChaXRng: sequential u32 keystream with a
    64-bit block counter starting at 0, nonce 0 (`from_seed`)."""

    def __init__(self, seed: bytes, rounds: int = 12):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[i * 4:(i + 1) * 4], "little")
                    for i in range(8)]
        self.rounds = rounds
        self.counter = 0
        self.buf: list[int] = []

    def _refill(self):
        self.buf = chacha_block(self.key, self.counter, [0, 0], self.rounds)
        self.counter += 1

    def next_u32(self) -> int:
        if not self.buf:
            self._refill()
        return self.buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)


def ark_test_rng() -> ChaChaRng:
    """`ark_std::test_rng()`: StdRng (ChaCha12) with the pinned seed."""
    return ChaChaRng(ARK_TEST_SEED, rounds=12)


def fq_rand(rng: ChaChaRng) -> int:
    """ark-ff `Fp64::rand`: rejection-sample a raw limb < p; the limb is the
    Montgomery form, canonical value = raw * 2^-64 mod p."""
    while True:
        raw = rng.next_u64()
        if raw < P:
            return (raw * INV_2_64) % P


def ring_ntt_rand(rng: ChaChaRng) -> list[int]:
    """`GoldilocksRingNTT::rand`: 8 slots x Fq3 (c0, c1, c2) = 24 canonical
    Fq values in the repo's slot-major NTT coordinate order."""
    return [fq_rand(rng) for _ in range(24)]


def reference_ajtai_ring() -> list[int]:
    """THE ring element of the reference's Ajtai matrix (main.rs:81-83):
    every cell of the kappa x n matrix equals this value."""
    return ring_ntt_rand(ark_test_rng())
