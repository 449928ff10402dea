"""Fiat-Shamir transcript: Poseidon2 (width 16, rate 12) duplex challenger
over Goldilocks, absorbing RqNTT ring elements.

Bit-exact mirror of the reference's Poseidon2Transcript
(latticeum/crates/zkvm/src/fiat_shamir.rs:20-114):
  * absorb: every base-field coefficient of the NTT form, slot-major
    (8 slots x 3 Fq3 coords);
  * get_challenge: sample c0, c1, c2 then observe them back -> Fq3;
  * squeeze_bytes: little-endian canonical u64 bytes of samples;
  * get_short_challenge: 18 bytes -> 24 coefficients in [-32, 32)
    (cyclotomic-rings/src/rings/goldilocks.rs:36-69).

Host-side ints; heavy math stays on device, only protocol-level scalars pass
through here.
"""

from __future__ import annotations

from ..field import host as H
from . import poseidon2_ref as p2

P = p2.P
MAX_COEFF = 32
SHORT_CHALLENGE_BYTES = 18


def decode_short_challenge(bs: bytes):
    """18 bytes -> 24 balanced coefficients (as canonical field ints)."""
    assert len(bs) == SHORT_CHALLENGE_BYTES
    coeffs = []
    for i in range(6):
        b0, b1, b2 = bs[3 * i], bs[3 * i + 1], bs[3 * i + 2]
        x0 = (b0 & 0b0011_1111) - MAX_COEFF
        x1 = (((b0 & 0b1100_0000) >> 6) | ((b1 & 0b0000_1111) << 2)) - MAX_COEFF
        x2 = (((b1 & 0b1111_0000) >> 4) | ((b2 & 0b0000_0011) << 4)) - MAX_COEFF
        x3 = ((b2 & 0b1111_1100) >> 2) - MAX_COEFF
        coeffs.extend([x0 % P, x1 % P, x2 % P, x3 % P])
    return coeffs


class Transcript:
    def __init__(self, record_samples: bool = False):
        self.ch = p2.DuplexChallenger()
        self.absorptions: list[list[list[int]]] = []
        # record_samples=True captures every challenger sample in order —
        # a ReplayTranscript built from the list re-derives the exact same
        # challenge sequence without re-hashing (the verifier-vars
        # collector replays the prover's own deterministic transcript, so
        # re-absorbing ~250k values per fold was pure duplicated work)
        self.samples: list[int] | None = [] if record_samples else None

    # -- absorb ------------------------------------------------------------
    def absorb_ring(self, ntt24):
        """Absorb one RqNTT element (24 ints, slot-major)."""
        if hasattr(self.ch, "observe_many"):
            self.ch.observe_many([v % P for v in ntt24])
        else:
            for v in ntt24:
                self.ch.observe(v % P)

    def absorb_slice(self, rings):
        self.absorptions.append([list(r) for r in rings])
        if hasattr(self.ch, "observe_many"):
            self.ch.observe_many([v % P for r in rings for v in r])
        else:
            for r in rings:
                self.absorb_ring(r)

    def absorb_u64(self, c: int):
        """Absorb R::from(c) — scalar embedded in every slot."""
        self.absorb_ring(H.ntt_from_u64(c))

    def absorb_fq3(self, x):
        """Absorb an Fq3 embedded via from_scalar (all slots equal)."""
        self.absorb_ring(H.ntt_from_fq3(x))

    # -- device Fiat-Shamir sync (zkvm/accel_dev_fs.py) --------------------
    def export_for_device(self) -> tuple[list[int], list[int]]:
        """-> (state16, input_buffer) for the device challenger.

        The output buffer is dropped: valid only when the next transcript
        action is an observe (it stale-clears the output buffer), which
        holds at every sum-check phase boundary."""
        ch = self.ch
        if hasattr(ch, "st"):                       # NativeChallenger
            st = ch.st
            return ([int(v) for v in st[:16]],
                    [int(st[18 + i]) for i in range(int(st[16]))])
        return list(ch.state), list(ch.input_buffer)

    def import_from_device(self, state16, input_buffer):
        """Resync the host challenger from the device run's final state."""
        import numpy as np
        ch = self.ch
        if hasattr(ch, "st"):
            ch.st[:16] = np.array([int(v) % P for v in state16],
                                  dtype=np.uint64)
            ch.st[16] = len(input_buffer)
            ch.st[17] = 0
            for i, v in enumerate(input_buffer):
                ch.st[18 + i] = int(v) % P
        else:
            ch.state = [int(v) % P for v in state16]
            ch.input_buffer = [int(v) % P for v in input_buffer]
            ch.output_buffer = []

    # -- sample ------------------------------------------------------------
    def _sample(self) -> int:
        v = self.ch.sample()
        if self.samples is not None:
            self.samples.append(v)
        return v

    def get_challenge(self):
        """-> Fq3 (c0, c1, c2); samples then re-observes (fiat_shamir.rs:69-86)."""
        c0 = self._sample()
        c1 = self._sample()
        c2 = self._sample()
        self.ch.observe(c0)
        self.ch.observe(c1)
        self.ch.observe(c2)
        return (c0, c1, c2)

    def squeeze_bytes(self, n: int) -> bytes:
        """fiat_shamir.rs:88-102: little-endian bytes of canonical samples."""
        out = bytearray()
        while len(out) < n:
            val = self._sample()
            out.extend(val.to_bytes(8, "little")[:min(n - len(out), 8)])
        return bytes(out)

    def get_short_challenge(self):
        """-> 24 coefficient-form ints in balanced range [-32, 32)."""
        return decode_short_challenge(self.squeeze_bytes(SHORT_CHALLENGE_BYTES))


class ReplayTranscript(Transcript):
    """Transcript that re-derives challenges from a RECORDED sample stream
    instead of re-hashing (absorbs become bookkeeping-only no-ops).

    The verifier-vars collector (zkvm/collect.py) replays the exact
    absorb/sample sequence of the prover's fold transcript; with the
    prover's transcript created as Transcript(record_samples=True), the
    replay is deterministic bit-for-bit — this class skips the ~250k
    re-absorbed values (≈0.25 s/step of duplicated Poseidon2 hashing)."""

    def __init__(self, samples):
        self.ch = None
        self.absorptions = []
        self.samples = None
        self._replay = samples
        self._pos = 0

    # absorbs: keep only the absorptions bookkeeping
    def absorb_ring(self, ntt24):
        pass

    def absorb_slice(self, rings):
        self.absorptions.append([list(r) for r in rings])

    def absorb_u64(self, c):
        pass

    def absorb_fq3(self, x):
        pass

    def _sample(self) -> int:
        v = self._replay[self._pos]
        self._pos += 1
        return v

    def get_challenge(self):
        return (self._sample(), self._sample(), self._sample())
