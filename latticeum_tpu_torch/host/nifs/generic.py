"""Ring-GENERIC LatticeFold NIFS over `ring.models.CyclotomicModel`.

The production pipeline (nifs/*.py + zkvm/accel*) is specialized to the
Goldilocks ring (D=24, 8 Fq3 slots) for TPU-kernel reasons.  This module is
the parity answer to the reference's ring-generic latticefold
(`latticefold/src/nifs/tests.rs:119-203`, generic over `SuitableRing`): the
complete NIFS — linearization, decomposition, folding, composition, and
their verifiers — parameterized by a CyclotomicModel (D, N slots, slot
degree d), at host scale for the toy CCS.

Representation: a ring element is a tuple of N slot tuples (each d ints) in
the model's NORMALIZED CRT domain: every slot is an element of the single
common extension field F = Fq[Y]/(Y^d - W) via the per-slot homogenization
isomorphisms (models.py crt_h/icrt_h — the reference's models/<ring>/ntt.rs
homogenize_fq9/fq3 analogs, with the isomorphism constants COMPUTED by
d-th-root finding instead of transcribed from Sage; the crt_h/icrt_h
ring-isomorphism property is pinned by
tests/test_ring_models.py::test_crt_h_ring_isomorphism and exercised
end-to-end by tests/test_generic_nifs.py::
test_babybear_homogenized_ring_ops).  Sum-check/folding
challenges are F elements (d == 1 models keep plain Fq ints); the diagonal
embedding c -> (c, ..., c) is the canonical Fq^d-algebra map in the
normalized domain, exactly as the reference embeds BaseRing challenges.

Fiat-Shamir here is a SHA-256 chain — the generic layer tests protocol
math, not transcript parity (the production transcript is Poseidon2,
crypto/transcript.py, and is ring-specific by construction in the
reference too: each ring carries its own challenge set).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


# -- ring helpers over a CyclotomicModel -------------------------------------

class GRing:
    """Slot-domain ring ops for a CyclotomicModel (host ints)."""

    def __init__(self, model):
        self.m = model
        self.p = model.p
        self.N = model.N
        self.d = model.d
        self.D = model.D
        assert model.has_hom, \
            f"{model.name}: no p-1 factorization for homogenization"
        self.F = model.F

    # construction
    def zero(self):
        return tuple(tuple(0 for _ in range(self.d)) for _ in range(self.N))

    def from_u64(self, c):
        c = c % self.p
        return tuple(tuple([c] + [0] * (self.d - 1)) for _ in range(self.N))

    def from_coeffs(self, coeffs):
        return tuple(tuple(s) for s in self.m.crt_h(list(coeffs)))

    def to_coeffs(self, x):
        return self.m.icrt_h([list(s) for s in x])

    def scalar(self, c):
        """Slot-field element -> ring: the diagonal embedding (sound in the
        normalized domain — every slot is the same field F)."""
        t = self.F.of(c)
        return tuple(t for _ in range(self.N))

    # arithmetic
    def add(self, a, b):
        return tuple(tuple((x + y) % self.p for x, y in zip(sa, sb))
                     for sa, sb in zip(a, b))

    def sub(self, a, b):
        return tuple(tuple((x - y) % self.p for x, y in zip(sa, sb))
                     for sa, sb in zip(a, b))

    def neg(self, a):
        return tuple(tuple((-x) % self.p for x in s) for s in a)

    def mul(self, a, b):
        return tuple(tuple(s) for s in self.m.slot_mul_h(
            [list(s) for s in a], [list(s) for s in b]))

    def ssum(self, elems):
        acc = self.zero()
        for e in elems:
            acc = self.add(acc, e)
        return acc

    def rot_coeffs(self, coeffs):
        """coeffs(X * f) — multiply by X in the coefficient domain."""
        return self.m.reduce([0] + list(coeffs))


# -- transcript ----------------------------------------------------------------

class ShaTranscript:
    """Deterministic SHA-256 challenger (generic-layer stand-in)."""

    def __init__(self, ring: GRing):
        self.r = ring
        self.state = hashlib.sha256(b"latticeum-generic").digest()

    def absorb(self, x):
        h = hashlib.sha256(self.state)
        h.update(repr(x).encode())
        self.state = h.digest()

    def absorb_ring(self, x):
        self.absorb(tuple(tuple(s) for s in x))

    def absorb_rings(self, xs):
        for x in xs:
            self.absorb_ring(x)

    def _squeeze_int(self, nbytes=48):
        out = b""
        while len(out) < nbytes:
            self.state = hashlib.sha256(self.state + b"sq").digest()
            out += self.state
        return int.from_bytes(out[:nbytes], "big")

    def challenge_scalar(self):
        """Slot-FIELD challenge: an Fq int when d == 1, else a d-tuple."""
        if self.r.d == 1:
            return self._squeeze_int() % self.r.p
        return tuple(self._squeeze_int() % self.r.p
                     for _ in range(self.r.d))

    def rand_fq(self):
        """A plain base-field scalar (matrix sampling etc.)."""
        return self._squeeze_int() % self.r.p

    def short_challenge_coeffs(self, bound=2):
        """D small balanced coefficients in [-bound, bound)."""
        v = self._squeeze_int(self.r.D * 2)
        out = []
        for _ in range(self.r.D):
            out.append(v % (2 * bound) - bound)
            v //= 2 * bound
        return out


# -- MLEs + sum-check ----------------------------------------------------------

def fix_variable(ring, mle, ch_ring):
    """Fix the lowest variable at a challenge (adjacent-pair convention)."""
    out = []
    for i in range(0, len(mle), 2):
        step = ring.sub(mle[i + 1], mle[i])
        out.append(ring.add(mle[i], ring.mul(step, ch_ring)))
    return out


def build_eq_table(ring, point_rings):
    """eq(beta, x) over x in {0,1}^nv, index bit j = x_j (LSB-first)."""
    table = [ring.from_u64(1)]
    one = ring.from_u64(1)
    for b in reversed(point_rings):
        lo = [ring.mul(t, ring.sub(one, b)) for t in table]
        hi = [ring.mul(t, b) for t in table]
        table = _interleave(lo, hi)
    return table


def _interleave(lo, hi):
    out = []
    for a, b in zip(lo, hi):
        out.append(a)
        out.append(b)
    return out


def evaluate_mle(ring, mle, point_rings):
    cur = list(mle)
    for c in point_rings:
        cur = fix_variable(ring, cur, c)
    return cur[0]


def interpolate_uni(ring, evals, r_scalar):
    """Lagrange over nodes 0..deg at the slot-field challenge."""
    F = ring.F
    p = ring.p
    n = len(evals)
    res = ring.zero()
    rf = F.of(r_scalar)
    for i in range(n):
        num, den = F.one(), 1
        for j in range(n):
            if j != i:
                num = F.mul(num, F.sub(rf, j))
                den = den * (i - j) % p
        w = F.mul(num, pow(den, p - 2, p))
        res = ring.add(res, ring.mul(evals[i], ring.scalar(w)))
    return res


def sumcheck_prove(ring, transcript, mles, nv, degree, comb):
    transcript.absorb(("sc", nv, degree))
    proof, chals = [], []
    cur = [list(m) for m in mles]
    for _ in range(nv):
        evals = []
        for t in range(degree + 1):
            tot = ring.zero()
            tr = ring.from_u64(t)
            for i in range(0, len(cur[0]), 2):
                vals = []
                for m in cur:
                    step = ring.sub(m[i + 1], m[i])
                    vals.append(ring.add(m[i], ring.mul(step, tr)))
                tot = ring.add(tot, comb(vals))
            evals.append(tot)
        transcript.absorb_rings(evals)
        proof.append(evals)
        c = transcript.challenge_scalar()
        chals.append(c)
        cr = ring.scalar(c)
        cur = [fix_variable(ring, m, cr) for m in cur]
    return proof, chals, [m[0] for m in cur]


def sumcheck_verify(ring, transcript, nv, degree, claim, proof):
    transcript.absorb(("sc", nv, degree))
    chals = []
    for evals in proof:
        transcript.absorb_rings(evals)
        chals.append(transcript.challenge_scalar())
    expected = claim
    for evals, c in zip(proof, chals):
        p01 = ring.add(evals[0], evals[1])
        if p01 != expected:
            raise ValueError("sum-check round failed")
        expected = interpolate_uni(ring, evals, c)
    return chals, expected


# -- CCS / witness --------------------------------------------------------------

@dataclass
class GCCS:
    m: int
    n: int
    l: int
    t: int
    M: list          # t dense matrices (m x n) of ring elements (sparse ok)
    S: list
    c: list          # ring constants

    def matvec(self, ring, j, z):
        out = []
        for row in self.M[j]:
            acc = ring.zero()
            for col, v in row:
                acc = ring.add(acc, ring.mul(v, z[col]))
            out.append(acc)
        return out

    def check_relation(self, ring, z):
        mz = [self.matvec(ring, j, z) for j in range(self.t)]
        for r in range(self.m):
            acc = ring.zero()
            for i, S_i in enumerate(self.S):
                prod = self.c[i]
                for j in S_i:
                    prod = ring.mul(prod, mz[j][r])
                acc = ring.add(acc, prod)
            if acc != ring.zero():
                raise AssertionError(f"CCS relation failed at row {r}")


def toy_ccs(ring, L):
    """The x^3 + x + 5 = y R1CS -> CCS (arith/r1cs.rs), padded like
    CCS::from_r1cs_padded: m = next_pow2(max((n-l-1)*L, 4))."""
    n, l = 6, 1
    m = 1 << (max((n - l - 1) * L, 4) - 1).bit_length()
    one = ring.from_u64(1)

    def rows(entries):
        out = [[] for _ in range(m)]
        for (r, c, v) in entries:
            out[r].append((c, ring.from_u64(v)))
        return out

    # z = [x, 1, y=x^3+x+5, x^2, x^3, x^3+x]
    # rows: x*x=x^2; x^2*x=x^3; (x^3+x)*1=z5; (z5+5)*1=y
    A = rows([(0, 0, 1), (1, 3, 1), (2, 4, 1), (2, 0, 1)])
    B = rows([(0, 0, 1), (1, 0, 1), (2, 1, 1), (3, 1, 1)])
    C = rows([(0, 3, 1), (1, 4, 1), (2, 5, 1), (3, 2, 1)])
    A[3] = [(5, one), (1, ring.from_u64(5))]
    return GCCS(m=m, n=n, l=l, t=3, M=[A, B, C], S=[[0, 1], [2]],
                c=[one, ring.neg(one)])


def toy_z(ring, x):
    vals = [x, 1, x ** 3 + x + 5, x ** 2, x ** 3, x ** 3 + x]
    return [ring.from_u64(v) for v in vals]


def build_fhat(ring, f_coeffs_list, tau):
    """get_fhat (arith.rs:273-297): chunk each coeff-form f_i into tau
    chunks of N coefficients; chunk j's N values become slot SCALARS of
    f_hat[j][i]."""
    N, d = ring.N, ring.d
    out = []
    for j in range(tau):
        row = []
        for coeffs in f_coeffs_list:
            chunk = coeffs[j * N:(j + 1) * N]
            row.append(tuple(tuple([v % ring.p] + [0] * (d - 1))
                             for v in chunk))
        out.append(row)
    return out


def decompose_balanced_coeffs(ring, coeffs, b, L):
    """Balanced base-b split of a coefficient vector into L parts.

    The production signed-magnitude carry rule (ring/decompose.py,
    balanced_decomposition/mod.rs:62-103): digits in [-b/2, b/2], carry
    fires when |r| > b/2 — required for b = 2, where the naive mod rule
    cannot represent negatives."""
    p = ring.p
    half_q = (p - 1) // 2
    digs = [[0] * ring.D for _ in range(L)]
    for i, v in enumerate(coeffs):
        x = int(v) % p
        if x > half_q:
            x -= p
        sign = -1 if x < 0 else 1
        mag = -x if x < 0 else x
        for k in range(L):
            r = mag % b
            if r <= b // 2:
                d = sign * r
                mag //= b
            else:
                d = sign * (r - b)
                mag = mag // b + 1
            digs[k][i] = d % p
    return digs


@dataclass
class GWitness:
    f_coeffs: list       # per-index coefficient vectors (gadget domain)
    f: list              # ring elements (CRT of f_coeffs)
    f_hat: list          # tau x len(f) rings
    w_ccs: list


def witness_from_w(ring, w_ccs, B, L, tau):
    f_coeffs = []
    for w in w_ccs:
        parts = decompose_balanced_coeffs(ring, ring.to_coeffs(w), B, L)
        f_coeffs.extend(parts)
    f = [ring.from_coeffs(c) for c in f_coeffs]
    return GWitness(f_coeffs=f_coeffs, f=f,
                    f_hat=build_fhat(ring, f_coeffs, tau), w_ccs=list(w_ccs))


class GAjtai:
    def __init__(self, ring, kappa, n, seed=0):
        self.ring = ring
        self.kappa = kappa
        self.n = n
        t = ShaTranscript(ring)
        t.absorb(("ajtai", seed))
        self.rows = []
        for _ in range(kappa):
            row = []
            for _ in range(n):
                coeffs = [t.rand_fq() for _ in range(ring.D)]
                row.append(ring.from_coeffs(coeffs))
            self.rows.append(row)

    def commit(self, f):
        assert len(f) == self.n
        return [self.ring.ssum([self.ring.mul(a, x)
                                for a, x in zip(row, f)])
                for row in self.rows]


# -- instances -------------------------------------------------------------------

@dataclass
class GCCCS:
    cm: list
    x_ccs: list


@dataclass
class GLCCCS:
    r: list      # scalar challenges
    v: list
    cm: list
    u: list
    x_w: list
    h: object


# -- linearization ----------------------------------------------------------------

def lin_prove(ring, ccs, cm_i: GCCCS, wit: GWitness, transcript):
    transcript.absorb(("lin",))
    nv = ccs.m.bit_length() - 1
    beta = [transcript.challenge_scalar() for _ in range(nv)]
    z = list(cm_i.x_ccs) + [ring.from_u64(1)] + list(wit.w_ccs)
    mz = [ccs.matvec(ring, j, z) for j in range(ccs.t)]
    eq = build_eq_table(ring, [ring.scalar(b) for b in beta])
    mles = mz + [eq]

    def comb(vals):
        acc = ring.zero()
        for i, S_i in enumerate(ccs.S):
            prod = ccs.c[i]
            for j in S_i:
                prod = ring.mul(prod, vals[j])
            acc = ring.add(acc, prod)
        return ring.mul(acc, vals[-1])

    degree = max(len(s) for s in ccs.S) + 1
    proof_sc, chals, finals = sumcheck_prove(ring, transcript, mles, nv,
                                             degree, comb)
    point = [ring.scalar(c) for c in chals]
    v = [evaluate_mle(ring, fh, point) for fh in wit.f_hat]
    u = finals[:ccs.t]
    transcript.absorb_rings(v)
    transcript.absorb_rings(u)
    lcccs = GLCCCS(r=chals, v=v, cm=list(cm_i.cm), u=u,
                   x_w=list(cm_i.x_ccs), h=ring.from_u64(1))
    return lcccs, {"sumcheck": proof_sc, "v": v, "u": u}


def lin_verify(ring, ccs, cm_i: GCCCS, proof, transcript):
    transcript.absorb(("lin",))
    nv = ccs.m.bit_length() - 1
    beta = [transcript.challenge_scalar() for _ in range(nv)]
    chals, expected = sumcheck_verify(ring, transcript, nv,
                                      max(len(s) for s in ccs.S) + 1,
                                      ring.zero(), proof["sumcheck"])
    # eq(beta, r) * sum_i c_i prod u_j == expected
    F = ring.F
    e = F.one()
    for b, r in zip(beta, chals):
        # eq factor: b*r + (1-b)(1-r) = 1 - b - r + 2br
        br = F.mul(b, r)
        e = F.mul(e, F.add(F.sub(F.sub(F.one(), F.of(b)), F.of(r)),
                           F.add(br, br)))
    acc = ring.zero()
    for i, S_i in enumerate(ccs.S):
        prod = ccs.c[i]
        for j in S_i:
            prod = ring.mul(prod, proof["u"][j])
        acc = ring.add(acc, prod)
    if ring.mul(acc, ring.scalar(e)) != expected:
        raise ValueError("linearization evaluation claim failed")
    transcript.absorb_rings(proof["v"])
    transcript.absorb_rings(proof["u"])
    return GLCCCS(r=chals, v=proof["v"], cm=list(cm_i.cm), u=proof["u"],
                  x_w=list(cm_i.x_ccs), h=ring.from_u64(1))


# -- decomposition ------------------------------------------------------------------

def dec_prove(ring, ccs, scheme, cm_i: GLCCCS, wit: GWitness, params,
              transcript):
    b_small, K, B, L, tau = (params["b_small"], params["K"], params["B"],
                             params["L"], params["tau"])
    # split every f coefficient vector into K balanced b_small parts
    parts_coeffs = [[] for _ in range(K)]
    for coeffs in wit.f_coeffs:
        digs = decompose_balanced_coeffs(ring, coeffs, b_small, K)
        for k in range(K):
            parts_coeffs[k].append(digs[k])
    wit_s, y_s, z_s, x_s = [], [], [], []
    point = [ring.scalar(c) for c in cm_i.r]
    u_s, v_s = [], []
    n_w = len(wit.f_coeffs) // L
    for k in range(K):
        f_k = [ring.from_coeffs(c) for c in parts_coeffs[k]]
        # recompose each part's w (gadget recompose base B over L digits)
        w_k = []
        for i in range(n_w):
            acc = ring.zero()
            for j in range(L):
                w = pow(B, j, ring.p)
                acc = ring.add(acc, ring.mul(f_k[i * L + j],
                                             ring.from_u64(w)))
            w_k.append(acc)
        fh_k = build_fhat(ring, parts_coeffs[k], tau)
        wk = GWitness(f_coeffs=parts_coeffs[k], f=f_k, f_hat=fh_k,
                      w_ccs=w_k)
        wit_s.append(wk)
        y_s.append(scheme.commit(f_k))
    # split the statement x_w || h into K parts that recompose back
    # (decomposition/utils.rs:12-41: gadget-decompose base B into L digits,
    # split each digit base b_small into K parts, recompose per part)
    p = ring.p
    xh = list(cm_i.x_w) + [cm_i.h]
    xh_parts = [[] for _ in range(K)]
    for x in xh:
        big = decompose_balanced_coeffs(ring, ring.to_coeffs(x), B, L)
        kparts = [decompose_balanced_coeffs(ring, d, b_small, K)
                  for d in big]
        for k in range(K):
            rec = [0] * ring.D
            for j in range(L):
                w = pow(B, j, p)
                rec = [(r + c * w) % p
                       for r, c in zip(rec, kparts[j][k])]
            xh_parts[k].append(ring.from_coeffs(rec))
    for k in range(K):
        x_s.append(xh_parts[k])
        z_k = xh_parts[k][:-1] + [xh_parts[k][-1]] + wit_s[k].w_ccs
        z_s.append(z_k)
        mzs = [evaluate_mle(ring, ccs.matvec(ring, j, z_k), point)
               for j in range(ccs.t)]
        u_s.append(mzs)
        v_s.append([evaluate_mle(ring, fh, point)
                    for fh in wit_s[k].f_hat])
    lcccs_s = []
    for k in range(K):
        transcript.absorb_rings(x_s[k])
        transcript.absorb_rings(y_s[k])
        transcript.absorb_rings(u_s[k])
        transcript.absorb_rings(v_s[k])
        lcccs_s.append(GLCCCS(r=list(cm_i.r), v=v_s[k], cm=y_s[k],
                              u=u_s[k], x_w=x_s[k][:-1], h=x_s[k][-1]))
    proof = {"y_s": y_s, "u_s": u_s, "v_s": v_s, "x_s": x_s}
    return z_s, lcccs_s, wit_s, proof


def dec_verify(ring, cm_i: GLCCCS, proof, params, transcript):
    b_small, K = params["b_small"], params["K"]
    for k in range(K):
        transcript.absorb_rings(proof["x_s"][k])
        transcript.absorb_rings(proof["y_s"][k])
        transcript.absorb_rings(proof["u_s"][k])
        transcript.absorb_rings(proof["v_s"][k])

    def recompose(vec_s):
        acc = None
        for k in range(K):
            w = ring.from_u64(pow(b_small, k, ring.p))
            term = [ring.mul(v, w) for v in vec_s[k]]
            acc = term if acc is None else [ring.add(a, t)
                                            for a, t in zip(acc, term)]
        return acc

    if recompose(proof["y_s"]) != cm_i.cm:
        raise ValueError("decomposition cm recomposition failed")
    if recompose(proof["v_s"]) != cm_i.v:
        raise ValueError("decomposition v recomposition failed")
    if recompose(proof["u_s"]) != cm_i.u:
        raise ValueError("decomposition u recomposition failed")
    if recompose(proof["x_s"]) != list(cm_i.x_w) + [cm_i.h]:
        raise ValueError("decomposition x recomposition failed")
    return [GLCCCS(r=list(cm_i.r), v=proof["v_s"][k], cm=proof["y_s"][k],
                   u=proof["u_s"][k], x_w=proof["x_s"][k][:-1],
                   h=proof["x_s"][k][-1]) for k in range(K)]


# -- folding ---------------------------------------------------------------------

def _squeeze_fold_challenges(ring, transcript, nv, K):
    transcript.absorb(("fold",))
    alpha = [transcript.challenge_scalar() for _ in range(2 * K)]
    zeta = [transcript.challenge_scalar() for _ in range(2 * K)]
    mu = [transcript.challenge_scalar() for _ in range(2 * K - 1)] + [1]
    beta = [transcript.challenge_scalar() for _ in range(nv)]
    return alpha, beta, zeta, mu


def _claims(ring, alpha, zeta, cm_i_s):
    g1, g3 = ring.zero(), ring.zero()
    F = ring.F
    for i, cm in enumerate(cm_i_s):
        pw = F.of(alpha[i])
        for v in cm.v:
            g1 = ring.add(g1, ring.mul(v, ring.scalar(pw)))
            pw = F.mul(pw, alpha[i])
        pw = F.of(zeta[i])
        for u in cm.u:
            g3 = ring.add(g3, ring.mul(u, ring.scalar(pw)))
            pw = F.mul(pw, zeta[i])
    return g1, g3


def rot_sum(ring, rho_coeffs, b_slot_scalars):
    """RotSum (rotation.rs:45-61) generically: D slot-FIELD coefficients of
    sum_i b_i * coeffs(X^i rho) — rho's base-prime coefficients lift into
    the slot field and scale the field values b_i."""
    F = ring.F
    acc = [F.zero()] * ring.D
    cur = list(rho_coeffs)
    for b in b_slot_scalars:
        bf = F.of(b)
        acc = [F.add(a, F.mul(F.of(c), bf)) for a, c in zip(acc, cur)]
        cur = ring.rot_coeffs(cur)
    return acc


def fold_prove(ring, ccs, cm_i_s, wit_s, z_s, params, transcript):
    b_small, K, tau = params["b_small"], params["K"], params["tau"]
    nv = ccs.m.bit_length() - 1
    alpha, beta, zeta, mu = _squeeze_fold_challenges(ring, transcript, nv, K)
    p = ring.p
    # g MLEs: eq_r1, comb1, eq_r2, comb2, eq_beta, f_hats
    r1 = [ring.scalar(c) for c in cm_i_s[0].r]
    r2 = [ring.scalar(c) for c in cm_i_s[K].r]
    eq_r1 = build_eq_table(ring, r1)
    eq_r2 = build_eq_table(ring, r2)
    eq_b = build_eq_table(ring, [ring.scalar(b) for b in beta])

    F = ring.F

    def combined_half(lo, hi):
        acc = [ring.zero() for _ in range(ccs.m)]
        for i in range(lo, hi):
            pw = F.of(alpha[i])
            for fh in wit_s[i].f_hat:
                pr = ring.scalar(pw)
                for r in range(ccs.m):
                    acc[r] = ring.add(acc[r], ring.mul(fh[r], pr))
                pw = F.mul(pw, alpha[i])
            pw = F.of(zeta[i])
            for j in range(ccs.t):
                mz = ccs.matvec(ring, j, z_s[i])
                pr = ring.scalar(pw)
                for r in range(ccs.m):
                    acc[r] = ring.add(acc[r], ring.mul(mz[r], pr))
                pw = F.mul(pw, zeta[i])
        return acc

    c1 = combined_half(0, K)
    c2 = combined_half(K, 2 * K)
    fhats = [fh for w in wit_s for fh in w.f_hat]
    mles = [eq_r1, c1, eq_r2, c2, eq_b] + fhats

    def comb(vals):
        res = ring.add(ring.mul(vals[0], vals[1]),
                       ring.mul(vals[2], vals[3]))
        eqb = vals[4]
        for i in range(2 * K):
            inter = ring.zero()
            pw = F.of(mu[i])
            for dd in range(tau):
                f = vals[5 + i * tau + dd]
                ev = eqb
                for b in range(1, b_small):
                    bb = ring.from_u64(b * b)
                    ev = ring.mul(ev, ring.sub(ring.mul(f, f), bb))
                ev = ring.mul(ev, f)
                inter = ring.add(inter, ring.mul(ev, ring.scalar(pw)))
                pw = F.mul(pw, mu[i])
            res = ring.add(res, inter)
        return res

    proof_sc, chals, finals = sumcheck_prove(ring, transcript, mles, nv,
                                             2 * b_small, comb)
    point = [ring.scalar(c) for c in chals]
    theta_s = [[evaluate_mle(ring, fh, point) for fh in w.f_hat]
               for w in wit_s]
    eta_s = [[evaluate_mle(ring, ccs.matvec(ring, j, z), point)
              for j in range(ccs.t)] for z in z_s]
    for th in theta_s:
        transcript.absorb_rings(th)
    for et in eta_s:
        transcript.absorb_rings(et)
    rho_coeffs = [transcript.short_challenge_coeffs()
                  for _ in range(2 * K - 1)] + [[1] + [0] * (ring.D - 1)]
    rho = [ring.from_coeffs([c % p for c in rc]) for rc in rho_coeffs]
    folded = _fold_outputs(ring, ccs, rho_coeffs, rho, theta_s, cm_i_s,
                           eta_s, chals, tau)
    f0 = None
    for rh, w in zip(rho, wit_s):
        term = [ring.mul(rh, x) for x in w.f]
        f0 = term if f0 is None else [ring.add(a, b)
                                      for a, b in zip(f0, term)]
    f0_coeffs = [ring.to_coeffs(x) for x in f0]
    w0 = GWitness(f_coeffs=f0_coeffs, f=f0,
                  f_hat=build_fhat(ring, f0_coeffs, tau), w_ccs=None)
    return folded, w0, {"sumcheck": proof_sc, "theta_s": theta_s,
                        "eta_s": eta_s}


def _fold_outputs(ring, ccs, rho_coeffs, rho, theta_s, cm_i_s, eta_s,
                  chals, tau):
    p = ring.p
    F = ring.F
    # v_0 = rot_lin_combination over flattened thetas: each theta ring
    # element flattens into its N slot-FIELD values (rotation.rs:84-104:
    # flatten_to_coeffs yields tau*N BaseRing elements = D), rot_sum
    # accumulates D field values, regrouped into tau ring elements
    acc = [F.zero()] * ring.D
    for rc, thetas in zip(rho_coeffs, theta_s):
        flat = []
        for th in thetas:
            for s in th:
                flat.append(tuple(s))
        assert len(flat) == tau * ring.N == ring.D  # tau = d
        rs = rot_sum(ring, [c % p for c in rc], flat)
        acc = [F.add(a, x) for a, x in zip(acc, rs)]
    v_0 = [tuple(tuple(F.of(acc[j * ring.N + s])) for s in range(ring.N))
           for j in range(tau)]
    kappa = len(cm_i_s[0].cm)
    cm_0 = [ring.ssum([ring.mul(cm_i_s[i].cm[k], rho[i])
                       for i in range(len(rho))]) for k in range(kappa)]
    u_0 = [ring.ssum([ring.mul(eta_s[i][j], rho[i])
                      for i in range(len(rho))]) for j in range(ccs.t)]
    xh = [list(cm.x_w) + [cm.h] for cm in cm_i_s]
    x_0 = [ring.ssum([ring.mul(xh[i][j], rho[i])
                      for i in range(len(rho))])
           for j in range(ccs.l + 1)]
    return GLCCCS(r=list(chals), v=v_0, cm=cm_0, u=u_0, x_w=x_0[:-1],
                  h=x_0[-1])


def fold_verify(ring, ccs, cm_i_s, proof, params, transcript):
    b_small, K, tau = params["b_small"], params["K"], params["tau"]
    nv = ccs.m.bit_length() - 1
    alpha, beta, zeta, mu = _squeeze_fold_challenges(ring, transcript, nv, K)
    p = ring.p
    g1, g3 = _claims(ring, alpha, zeta, cm_i_s)
    claim = ring.add(g1, g3)
    chals, expected = sumcheck_verify(ring, transcript, nv, 2 * b_small,
                                      claim, proof["sumcheck"])

    F = ring.F

    def eq_eval(xs, ys):
        e = F.one()
        for x, y in zip(xs, ys):
            xy = F.mul(x, y)
            e = F.mul(e, F.add(F.sub(F.sub(F.one(), F.of(x)), F.of(y)),
                               F.add(xy, xy)))
        return e

    e_ast = eq_eval(beta, chals)
    e_s = [eq_eval(cm.r, chals) for cm in cm_i_s]
    should = ring.zero()
    for i in range(2 * K):
        s1 = ring.zero()
        pw = F.of(alpha[i])
        for th in proof["theta_s"][i]:
            s1 = ring.add(s1, ring.mul(th, ring.scalar(F.mul(pw, e_s[i]))))
            pw = F.mul(pw, alpha[i])
        s2 = ring.zero()
        pw = F.of(mu[i])
        for th in proof["theta_s"][i]:
            prod = th
            for b in range(1, b_small):
                jb = ring.from_u64(b)
                prod = ring.mul(prod, ring.mul(ring.sub(th, jb),
                                               ring.add(th, jb)))
            s2 = ring.add(s2, ring.mul(prod, ring.scalar(pw)))
            pw = F.mul(pw, mu[i])
        s2 = ring.mul(s2, ring.scalar(e_ast))
        s3 = ring.zero()
        pw = F.of(zeta[i])
        for et in proof["eta_s"][i]:
            s3 = ring.add(s3, ring.mul(et, ring.scalar(F.mul(pw, e_s[i]))))
            pw = F.mul(pw, zeta[i])
        should = ring.add(should, ring.add(ring.add(s1, s2), s3))
    if should != expected:
        raise ValueError("folding evaluation claim failed")
    for th in proof["theta_s"]:
        transcript.absorb_rings(th)
    for et in proof["eta_s"]:
        transcript.absorb_rings(et)
    rho_coeffs = [transcript.short_challenge_coeffs()
                  for _ in range(2 * K - 1)] + [[1] + [0] * (ring.D - 1)]
    rho = [ring.from_coeffs([c % p for c in rc]) for rc in rho_coeffs]
    return _fold_outputs(ring, ccs, rho_coeffs, rho, proof["theta_s"],
                         cm_i_s, proof["eta_s"], chals, tau)


# -- composition -------------------------------------------------------------------

def nifs_prove(ring, ccs, scheme, acc, w_acc, cm_i, w_i, params, transcript):
    linearized, lin_proof = lin_prove(ring, ccs, cm_i, w_i, transcript)
    z_l, lc_l, ws_l, dp_l = dec_prove(ring, ccs, scheme, acc, w_acc,
                                      params, transcript)
    z_r, lc_r, ws_r, dp_r = dec_prove(ring, ccs, scheme, linearized, w_i,
                                      params, transcript)
    folded, w0, fp = fold_prove(ring, ccs, lc_l + lc_r, ws_l + ws_r,
                                z_l + z_r, params, transcript)
    return folded, w0, {"linearization": lin_proof, "dec_l": dp_l,
                        "dec_r": dp_r, "folding": fp}


def nifs_verify(ring, ccs, acc, cm_i, proof, params, transcript):
    linearized = lin_verify(ring, ccs, cm_i, proof["linearization"],
                            transcript)
    lc_l = dec_verify(ring, acc, proof["dec_l"], params, transcript)
    lc_r = dec_verify(ring, linearized, proof["dec_r"], params, transcript)
    return fold_verify(ring, ccs, lc_l + lc_r, proof["folding"], params,
                       transcript)
