"""Small synthetic CCS fixtures mirroring the reference's test instances
(latticefold/src/arith/r1cs.rs:128-151,227-235): the x^3 + x + 5 = y R1CS
converted to CCS and padded."""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl, host as H
from .structs import CCS, SparseRingMatrix

P = H.P

# test decomposition params (decomposition_parameters.rs:51-59)
TEST_B, TEST_L, TEST_B_SMALL, TEST_K = 1024, 2, 2, 10

A_ROWS = [[1, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0],
          [1, 0, 0, 0, 1, 0], [0, 5, 0, 0, 0, 1]]
B_ROWS = [[1, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0],
          [0, 1, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0]]
C_ROWS = [[0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 1, 0],
          [0, 0, 0, 0, 0, 1], [0, 0, 1, 0, 0, 0]]


def _sparse_from_dense(rows, nrows, ncols):
    entries = []
    for r, row in enumerate(rows):
        for c, v in enumerate(row):
            if v:
                entries.append((r, c, H.ntt_from_u64(v)))
    return SparseRingMatrix.from_host(nrows, ncols, entries)


def get_test_ccs(L: int = TEST_L) -> CCS:
    """CCS::from_r1cs_padded of the test R1CS: m -> max((n-l-1)*L, m) pow2."""
    n, l = 6, 1
    m = max((n - l - 1) * L, 4)
    m = 1 << (m - 1).bit_length()
    M = [_sparse_from_dense(R, m, n) for R in (A_ROWS, B_ROWS, C_ROWS)]
    return CCS(m=m, n=n, l=l, t=3, q=2, d=2, M=M,
               S=[[0, 1], [2]],
               c=[H.ntt_from_u64(1), H.ntt_neg(H.ntt_from_u64(1))])


def get_dummy_ccs(x_len: int, wit_len: int, L: int = 1) -> CCS:
    """Arbitrary-size dummy CCS for benchmarking, mirroring the reference's
    `get_test_dummy_r1cs` (latticefold/src/arith/r1cs.rs:155-201): A = B =
    identity, C = squaring(z), so (Az)∘(Bz) = Cz holds for ANY z with
    C[i][i] = z_i.  Row count padded like CCS::from_r1cs_padded
    (benches/utils.rs:56-67)."""
    n = x_len + wit_len + 1
    rows = wit_len if (L == 1 and wit_len & (wit_len - 1) == 0) \
        else wit_len * L
    m = max((n - x_len - 1) * L, rows)
    m = 1 << (m - 1).bit_length()
    z = get_dummy_z(x_len, wit_len)
    ident = [(i, i, H.ntt_from_u64(1)) for i in range(min(m, n))]
    squar = [(i, i, list(z[i])) for i in range(min(m, n))]
    A = SparseRingMatrix.from_host(m, n, ident)
    C = SparseRingMatrix.from_host(m, n, squar)
    return CCS(m=m, n=n, l=x_len, t=3, q=2, d=2, M=[A, A, C],
               S=[[0, 1], [2]],
               c=[H.ntt_from_u64(1), H.ntt_neg(H.ntt_from_u64(1))])


def get_dummy_z(x_len: int, wit_len: int):
    """Deterministic z = [x..., 1, w...] of small scalars (the analog of
    benches/utils.rs get_test_dummy_z_split with rand)."""
    rng = np.random.default_rng(7)
    vals = ([int(v) for v in rng.integers(1, 1 << 16, x_len)] + [1]
            + [int(v) for v in rng.integers(1, 1 << 16, wit_len)])
    return [H.ntt_from_u64(v) for v in vals]


def get_test_z(inp: int):
    """z = [io, 1, w...] as host scalar rings (r1cs.rs:227-235)."""
    return [H.ntt_from_u64(v) for v in [
        inp, 1, inp ** 3 + inp + 5, inp ** 2, inp ** 3, inp ** 3 + inp]]


def z_to_device(z_host):
    return gl.from_int(np.array(z_host, dtype=object))
