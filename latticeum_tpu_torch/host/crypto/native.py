"""ctypes bindings for the native Poseidon2 core (host/native/poseidon2.cpp).

Builds the shared library on first use (g++ -O3) into the port's ``_build/``
(ignored by git) under a name that carries the hash of the source and the
flags, so an edited source is rebuilt and no tracked file is written; falls
back to the pure Python oracle when a toolchain is unavailable.  Constants
are injected from crypto/consts.py so there is a single source of truth.
With the tracer on, the challenger's calls into the core are its timer
TIMER and their permutations its counter PERMS.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..utils import tracing
from . import consts

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "native", "poseidon2.cpp")
_BUILD_DIR = os.path.join(_HERE, "..", "..", "_build")
_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
TIMER = "transcript.native_s"       # the tracer's timer of the core's calls
PERMS = "transcript.perms"          # the tracer's count of permutations


def _lib_path():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libposeidon2_{h.hexdigest()[:16]}.so")


def _build(out):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, out)


def _arr(vals):
    return np.array(vals, dtype=np.uint64)


def load():
    """Load (building if needed) the native library; returns None on failure."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except Exception:
        return None
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.p2_init.argtypes = [u64p] * 7
    lib.p2_perm8.argtypes = [u64p]
    lib.p2_perm16.argtypes = [u64p]
    lib.p2_hash_narrow.argtypes = [u64p, ctypes.c_uint64, u64p]
    lib.p2_hash_wide.argtypes = [u64p, ctypes.c_uint64, u64p]
    lib.p2_hash_rows_narrow.argtypes = [u64p, ctypes.c_uint64,
                                        ctypes.c_uint64, u64p]
    lib.p2_compress_level.argtypes = [u64p, ctypes.c_uint64, u64p]
    lib.p2_observe_many.argtypes = [u64p, u64p, ctypes.c_uint64]
    lib.p2_sample.argtypes = [u64p]
    lib.p2_sample.restype = ctypes.c_uint64
    lib.p2_init(
        _arr(consts.W8_EXTERNAL_INITIAL).ravel(),
        _arr(consts.W8_EXTERNAL_TERMINAL).ravel(),
        _arr(consts.W16_EXTERNAL_INITIAL).ravel(),
        _arr(consts.W16_EXTERNAL_TERMINAL).ravel(),
        _arr(consts.INTERNAL_22),
        _arr(consts.DIAG_8),
        _arr(consts.DIAG_16),
    )
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def perm8(state):
    s = _arr(state)
    load().p2_perm8(s)
    return [int(v) for v in s]


def perm16(state):
    s = _arr(state)
    load().p2_perm16(s)
    return [int(v) for v in s]


def hash_narrow(vals):
    out = np.zeros(4, dtype=np.uint64)
    load().p2_hash_narrow(_arr(vals), len(vals), out)
    return [int(v) for v in out]


def hash_wide(vals):
    out = np.zeros(4, dtype=np.uint64)
    load().p2_hash_wide(_arr(vals), len(vals), out)
    return [int(v) for v in out]


def hash_rows_narrow(rows: np.ndarray):
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    count, row_len = rows.shape
    out = np.zeros((count, 4), dtype=np.uint64)
    load().p2_hash_rows_narrow(rows, count, row_len, out)
    return out


def compress_level(digests: np.ndarray):
    digests = np.ascontiguousarray(digests, dtype=np.uint64)
    pairs = digests.shape[0] // 2
    out = np.zeros((pairs, 4), dtype=np.uint64)
    load().p2_compress_level(digests.reshape(-1), pairs, out)
    return out


class NativeChallenger:
    """Drop-in replacement for poseidon2_ref.DuplexChallenger."""

    def __init__(self):
        self.st = np.zeros(42, dtype=np.uint64)
        self._lib = load()

    def _observe(self, vals):
        if not tracing.active():
            self._lib.p2_observe_many(self.st, vals, len(vals))
            return
        # a permutation each time the input buffer (st[16]) reaches 12
        tracing.add(PERMS, (int(self.st[16]) + len(vals)) // 12)
        with tracing.timer(TIMER):
            self._lib.p2_observe_many(self.st, vals, len(vals))

    def observe(self, value: int):
        self._observe(_arr([value]))

    def observe_many(self, values):
        self._observe(_arr([v for v in values]))

    def sample(self) -> int:
        if not tracing.active():
            return int(self._lib.p2_sample(self.st))
        # a permutation where input is pending or the output buffer is empty
        tracing.add(PERMS, int(self.st[16] > 0 or self.st[17] == 0))
        with tracing.timer(TIMER):
            return int(self._lib.p2_sample(self.st))

    def squeeze_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            take = min(n - len(out), 8)
            out.extend(int(self.sample()).to_bytes(8, "little")[:take])
        return bytes(out)

    @property
    def state(self):
        return [int(v) for v in self.st[:16]]
