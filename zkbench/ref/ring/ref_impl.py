"""Host-side (pure Python int) reference implementation of the Goldilocks
cyclotomic ring R_q = F_q[X]/(X^24 - X^12 + 1) and its CRT.

This mirrors the algorithm of the Rust reference bit-exactly
(latticeum/crates/stark-rings/crates/ring/src/cyclotomic_ring/models/
goldilocks/ntt.rs:135-437) and serves two purposes:
  1. an exact oracle for tests,
  2. the generator of the dense 24x24 CRT/ICRT matrices used by the
     TPU path (the CRT is F_q-linear, so running the butterfly network on
     basis vectors yields exact matrices; a batched matvec mod p is then
     mathematically identical and MXU-friendly).
"""

from __future__ import annotations

P = 18446744069414584321
D = 24  # ring degree                                    (ntt.rs:9)
N = 8   # number of CRT slots                            (ntt.rs:11)
TAU = 3  # extension degree of each slot (D / N)

# ROOTS_OF_UNITY_24[i] = g^i with g = 2^40 a primitive 24th root of unity
# (values pinned by the table at ntt.rs:15-40 and its order test
# ntt.rs:463-467).
ROOT = 1 << 40
ROOTS = [pow(ROOT, i, P) for i in range(24)]

# ntt.rs:43 comments "2 * ROOT_OF_UNITY_24[4] - 1" but the pinned value is
# its modular INVERSE: KAPPA = (2*zeta - 1)^-1 mod p.
KAPPA = pow((2 * ROOTS[4] - 1) % P, P - 2, P)
EIGHT_INV = pow(8, P - 2, P)        # ntt.rs:45
FOUR_INV = pow(4, P - 2, P)         # ntt.rs:47
NONRESIDUE = ROOTS[1]               # 2^40


def _sanity():
    assert ROOTS[4] == 18446744065119617026
    assert KAPPA == 12297829382473034411
    assert EIGHT_INV == 16140901060737761281
    assert FOUR_INV == 13835058052060938241


_sanity()


def reduce_coeffs(c: list[int]) -> list[int]:
    """Reduce arbitrary-length coefficient list mod X^24 - X^12 + 1.

    (goldilocks/mod.rs:75-98)
    """
    c = [x % P for x in c]
    get = lambda i: c[i] if i < len(c) else 0
    out = [0] * D
    for i in range(D // 2):
        out[i] = (get(i) - get(D + i) - get(D + D // 2 + i)) % P
    for i in range(D // 2, D):
        out[i] = (get(i) + get(D // 2 + i)) % P
    return out


def poly_mul(a: list[int], b: list[int]) -> list[int]:
    full = [0] * (2 * D - 1)
    for i in range(D):
        for j in range(D):
            full[i + j] = (full[i + j] + a[i] * b[j]) % P
    return reduce_coeffs(full)


def rot(c: list[int]) -> list[int]:
    """Multiply by X (goldilocks/mod.rs:138-149)."""
    last = c[D - 1]
    out = [(-last) % P] + c[: D - 1]
    out[12] = (out[12] + last) % P
    return out


def crt(c: list[int]) -> list[int]:
    """In-place CRT network (ntt.rs:135-228), homogenized Fq3 layout."""
    c = [x % P for x in c]
    assert len(c) == D
    # Stage 1: split X^24-X^12+1 = (X^12 - z)(X^12 - z^5), z = ROOTS[4]
    for i in range(D // 2):
        a, b = c[i], c[D // 2 + i]
        zb = ROOTS[4] * b % P
        c[i] = (a + zb) % P
        c[D // 2 + i] = (a + b - zb) % P
    # Stage 2: halve each with sigma = ROOTS[2] / ROOTS[10]
    for i in range(D // 4):
        a, b = c[i], c[D // 4 + i]
        sb = ROOTS[2] * b % P
        c[i], c[D // 4 + i] = (a + sb) % P, (a - sb) % P
        a, b = c[D // 2 + i], c[3 * D // 4 + i]
        sb = ROOTS[10] * b % P
        c[D // 2 + i], c[3 * D // 4 + i] = (a + sb) % P, (a - sb) % P
    # Stage 3: final halvings with roots 1,7,5,11
    for base, r in ((0, 1), (D // 4, 7), (D // 2, 5), (3 * D // 4, 11)):
        for i in range(D // 8):
            a, b = c[base + i], c[base + D // 8 + i]
            sb = ROOTS[r] * b % P
            c[base + i], c[base + D // 8 + i] = (a + sb) % P, (a - sb) % P
    _homogenize(c)
    return c


def icrt(c: list[int]) -> list[int]:
    """Inverse CRT (ntt.rs:240-319)."""
    c = [x % P for x in c]
    assert len(c) == D
    _dehomogenize(c)
    for base, r in ((0, 23), (D // 4, 17), (D // 2, 19), (3 * D // 4, 13)):
        for i in range(D // 8):
            a, b = c[base + i], c[base + D // 8 + i]
            c[base + i] = (a + b) % P
            c[base + D // 8 + i] = ROOTS[r] * (a - b) % P
    for base, r in ((0, 22), (D // 2, 14)):
        for i in range(D // 4):
            a, b = c[base + i], c[base + D // 4 + i]
            c[base + i] = (a + b) % P
            c[base + D // 4 + i] = ROOTS[r] * (a - b) % P
    for i in range(D // 2):
        a, b = c[i], c[D // 2 + i]
        kd = KAPPA * (a - b) % P
        c[i] = EIGHT_INV * (a + b - kd) % P
        c[D // 2 + i] = FOUR_INV * kd % P
    return c


# Per-slot isomorphisms into Fq[X]/(X^3 - NONRESIDUE)  (ntt.rs:326-437).
# Entry (i): slot i occupies c[3i:3i+3]; each map scales/permutes (c1, c2).
def _homogenize(c):
    c[4] = (-c[4]) % P                                   # slot 1 (nu^13)
    c[7] = c[7] * ROOTS[2] % P                           # slot 2 (nu^7)
    c[8] = c[8] * ROOTS[4] % P
    c[10] = c[10] * ROOTS[6] % P                         # slot 3 (nu^19)
    c[11] = c[11] * ROOTS[12] % P
    for base, r1, r2 in ((12, 3, 1), (15, 11, 5), (18, 7, 3), (21, 15, 7)):
        c1 = c[base + 1]
        c[base + 1] = c[base + 2] * ROOTS[r1] % P        # slots 4-7
        c[base + 2] = c1 * ROOTS[r2] % P


def _dehomogenize(c):
    c[4] = (-c[4]) % P
    c[7] = c[7] * ROOTS[22] % P
    c[8] = c[8] * ROOTS[20] % P
    c[10] = c[10] * ROOTS[18] % P
    c[11] = c[11] * ROOTS[12] % P
    for base, r1, r2 in ((12, 23, 21), (15, 19, 13), (18, 21, 17), (21, 17, 9)):
        c1 = c[base + 1]
        c[base + 1] = c[base + 2] * ROOTS[r1] % P
        c[base + 2] = c1 * ROOTS[r2] % P


def ntt_mul(a: list[int], b: list[int]) -> list[int]:
    """Slot-wise Fq3 multiplication of two NTT-form vectors (24 Fq each)."""
    out = [0] * D
    for s in range(N):
        a0, a1, a2 = a[3 * s], a[3 * s + 1], a[3 * s + 2]
        b0, b1, b2 = b[3 * s], b[3 * s + 1], b[3 * s + 2]
        t = [0] * 5
        for i, ai in enumerate((a0, a1, a2)):
            for j, bj in enumerate((b0, b1, b2)):
                t[i + j] = (t[i + j] + ai * bj) % P
        out[3 * s] = (t[0] + NONRESIDUE * t[3]) % P
        out[3 * s + 1] = (t[1] + NONRESIDUE * t[4]) % P
        out[3 * s + 2] = t[2]
    return out


def crt_matrix() -> list[list[int]]:
    """24x24 matrix M with crt(x) == M @ x (mod p)."""
    cols = [crt([1 if j == i else 0 for j in range(D)]) for i in range(D)]
    return [[cols[j][i] for j in range(D)] for i in range(D)]


def icrt_matrix() -> list[list[int]]:
    cols = [icrt([1 if j == i else 0 for j in range(D)]) for i in range(D)]
    return [[cols[j][i] for j in range(D)] for i in range(D)]
