"""The reference's other cyclotomic ring models: BabyBear, Frog, StarkPrime
(+ Goldilocks for cross-checking) — host reference implementations.

Mirrors `stark-rings/crates/ring/src/cyclotomic_ring/models/{babybear,
frog_ring,stark_prime,goldilocks}`: each ring Fq[X]/Phi(X) splits into N
slots Fq[X]/(X^d - r_i); CRT folds the coefficient vector with powers of
the slot root, slot multiplication is negacyclic-style convolution mod
(X^d - r_i), and ICRT is the precomputed inverse of the CRT matrix.

Two slot domains are provided: the RAW domain (crt/icrt/slot_mul — slot i
is a residue mod its own X^d - r_i) and the NORMALIZED domain
(crt_h/icrt_h/slot_mul_h — every slot mapped into the single common
extension field F = Fq[Y]/(Y^d - W) via per-slot isomorphisms, the
reference's homogenize_fq9/fq3 analogs, with the isomorphism constants
COMPUTED by Pohlig-Hellman d-th-root extraction instead of transcribed
from Sage; pinned by tests/test_ring_models.py::test_crt_h_ring_isomorphism).
Frog has no computed homogenization (p-1 contains a ~3.2e14 prime factor;
needs AMM-style root extraction) — `has_hom` is False there, matching the
reference's own NIFS test matrix which skips Frog (nifs/tests.rs:119-203).
Root-of-unity tables are copied constants (ntt.rs of each model) and
pinned by algebraic identity tests.

The production TPU ring remains Goldilocks (ring/rq.py); these models serve
the cross-ring test/bench coverage the reference's latticefold suite has.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# -- model constants (from the reference's ntt.rs tables) --------------------

GOLDILOCKS_P = 18446744069414584321
BABYBEAR_P = 2013265921
FROG_P = 15912092521325583641
STARK_P = int("36185027886661312136973227830950701056231072153315966999730"
              "92056135872020481")

# babybear/ntt.rs:16-41 (24th roots of unity; index = power)
BABYBEAR_ROOTS_24 = [
    1, 503591070, 782862608, 1592366214, 1314723124, 715314264,
    1728404513, 1398021245, 1314723123, 211723194, 945541905, 1818920952,
    2013265920, 1509674851, 1230403313, 420899707, 698542797, 1297951657,
    284861408, 615244676, 698542798, 1801542727, 1067724016, 194344969,
]
# (the reference table's "power = 17/18" comments are swapped; the VALUES
# are in true power order — pinned by the g^i identity test)

# frog_ring/ntt.rs:15-25 (8th roots of unity)
FROG_ROOTS_8 = [
    1, 2755067726615789629, 13238044465818905414, 8043592722274778300,
    15912092521325583640, 13157024794709794012, 2674048055506678227,
    7868499799050805341,
]

# stark_prime/ntt.rs:15-47 (32nd roots of unity)
STARK_ROOTS_32 = [
    1,
    int("34094438670356410442450573487565446405494074215412899510539070013"
        "22227935403"),
    int("26790266028978681123496040248916258759689507673524851250587916969"
        "35099163961"),
    int("12476625758732115706594770426544082086613479621787670326843204896"
        "84194658007"),
    int("28046902174754620621433613396249396409846496679665114184463635960"
        "75299761851"),
    int("93604627967583403095463039848095407381358761825629141330559391637"
        "5183853324"),
    int("20018235416501333678500397115203031959003915510248567384130230248"
        "350883666"),
    int("15177350799973765366272641609408402852577718043022768927208840168"
        "87753722993"),
    int("27792657774907454869078126471640387508084196777108900771239255633"
        "01162072035"),
    int("15009638338787968385260424084956658680072671937361424099709693813"
        "86334285397"),
    int("26259739002277974619319957961450474393353522966238101847441443406"
        "54095677649"),
    int("18393200718066323120096657968734695108983894650438334057236362469"
        "14115759733"),
    int("16839347444553602479642255724006749380230972765803184753170016470"
        "84465960397"),
    int("29506427938286880065778374250018106062988597095161756141054086352"
        "29182523157"),
    int("10107673189808751487216249744976471056016821686927580695014643348"
        "11644188044"),
    int("19474421998072351560097952702085659479557004330169804564369866022"
        "71286759616"),
    int("36185027886661312136973227830950701056231072153315966999730920561"
        "35872020480"),
    int("20905892163049016945226543433852546507369979379030674891918505481"
        "3644085078"),
    int("93947618576826310134771875820344422965415644797911157491430035920"
        "0772856520"),
    int("23708402127929196430378457404406618969617592531528296672887715664"
        "51677362474"),
    int("81381257119066915155396144347013046463845754736508528152672846006"
        "0572258630"),
    int("26824565089902971827426923846141160318095195970753052866674981397"
        "60688167157"),
    int("35984845532496298800188223859798670736641032998213481325889618258"
        "87521136815"),
    int("21007677086687546770700586221542298203653354110293198072522080392"
        "48118297488"),
    int("83923701117538572678951013593103135481468753762070662284916649283"
        "4709948446"),
    int("21175389547873343751712803745994042376158400215954542900021226747"
        "49537735084"),
    int("99252888843833375176532698695002266628775491870778651522894771548"
        "1776342832"),
    int("17791827168594989016876569862216005947247177502877632942494558092"
        "21756260748"),
    int("19345680442107709657330972106943951676000099387512782246560904090"
        "51406060084"),
    int("66785999483744320711948535809325949932424750581542108586768342090"
        "6689497324"),
    int("26077354696852560649756978085974230000214250466388386304716277213"
        "24227832437"),
    int("16710605888588960576875275128865041576674067823146162435361054538"
        "64585260865"),
]


@dataclass
class CyclotomicModel:
    """Fq[X]/Phi(X) with Phi = X^D - mid*X^(D/2) + const_term."""
    name: str
    p: int
    D: int
    N: int
    mid: int            # 1 for X^D - X^(D/2) + 1, 0 for X^D + 1
    slot_roots: list    # N ints: slot i modulus is X^d - slot_roots[i]
    _icrt_matrix: object = field(default=None, repr=False)

    @property
    def d(self):
        return self.D // self.N

    # -- coefficient-domain -------------------------------------------------
    def reduce(self, coeffs):
        """Reduce a (possibly long) coefficient list mod Phi
        (models/<ring>/mod.rs reduce_in_place analogs)."""
        c = [int(v) % self.p for v in coeffs]
        D, half = self.D, self.D // 2
        while len(c) > D:
            for i in range(len(c) - 1, D - 1, -1):
                v = c[i]
                if v:
                    if self.mid:
                        c[i - half] = (c[i - half] + self.mid * v) % self.p
                    c[i - D] = (c[i - D] - v) % self.p
                c.pop()
        return c + [0] * (D - len(c))

    def poly_mul(self, a, b):
        """Schoolbook coeff-domain multiply + cyclotomic reduction."""
        out = [0] * (2 * self.D - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    out[i + j] = (out[i + j] + ai * bj) % self.p
        return self.reduce(out)

    # -- CRT / NTT domain ----------------------------------------------------
    def crt(self, coeffs):
        """Coeff vector (D,) -> N slots of d coefficients each:
        slot_i = f mod (X^d - r_i) = sum_j r_i^j f[jd:(j+1)d]."""
        assert len(coeffs) == self.D
        d, slots = self.d, []
        for r in self.slot_roots:
            acc = [0] * d
            rj = 1
            for j in range(self.N):
                blk = coeffs[j * d:(j + 1) * d]
                for t in range(d):
                    acc[t] = (acc[t] + rj * blk[t]) % self.p
                rj = rj * r % self.p
            slots.append(acc)
        return slots

    def icrt(self, slots):
        """Inverse of crt via the precomputed inverse CRT matrix."""
        M = self._icrt()
        flat = [v for s in slots for v in s]
        return [sum(M[i][j] * flat[j] for j in range(self.D)) % self.p
                for i in range(self.D)]

    def _icrt(self):
        if self._icrt_matrix is None:
            # CRT of the monomial basis -> D x D matrix; invert mod p
            cols = []
            for k in range(self.D):
                e = [0] * self.D
                e[k] = 1
                cols.append([v for s in self.crt(e) for v in s])
            A = [[cols[j][i] for j in range(self.D)] for i in range(self.D)]
            self._icrt_matrix = _invert_mod(A, self.p)
        return self._icrt_matrix

    def slot_mul(self, s_a, s_b):
        """Slotwise product: per-slot negacyclic-style conv mod X^d - r_i."""
        out = []
        for (a, b, r) in zip(s_a, s_b, self.slot_roots):
            d = self.d
            conv = [0] * (2 * d - 1)
            for i, ai in enumerate(a):
                if ai:
                    for j, bj in enumerate(b):
                        conv[i + j] = (conv[i + j] + ai * bj) % self.p
            res = list(conv[:d])
            for i in range(d, 2 * d - 1):
                res[i - d] = (res[i - d] + r * conv[i]) % self.p
            out.append(res)
        return out

    def ntt_mul(self, a_coeffs, b_coeffs):
        """Coeff-in, coeff-out product via the CRT domain (must equal
        poly_mul — the property pinning the whole factorization)."""
        return self.icrt(self.slot_mul(self.crt(a_coeffs),
                                       self.crt(b_coeffs)))

    # -- normalized (homogenized) slot domain --------------------------------
    @property
    def has_hom(self):
        return self.p in PM1_FACTORS or self.d == 1

    def _hom(self):
        if not hasattr(self, "_hom_cache"):
            self._hom_cache = _hom_setup(self)
        return self._hom_cache

    @property
    def F(self):
        """The common slot field Fq[Y]/(Y^d - W), W = slot_roots[0]."""
        if self.d == 1:
            return SlotField(self.p, 1, self.slot_roots[0])
        return self._hom()[0]

    def crt_h(self, coeffs):
        """CRT + per-slot homogenization: N slots, each an F element
        (the reference's serial_*_crt_in_place incl. homogenize)."""
        if self.d == 1:
            return self.crt(coeffs)
        _, homs, _ = self._hom()
        return [list(_matvec_mod(homs[i], s, self.p))
                for i, s in enumerate(self.crt(coeffs))]

    def icrt_h(self, slots):
        if self.d == 1:
            return self.icrt(slots)
        _, _, dehoms = self._hom()
        raw = [list(_matvec_mod(dehoms[i], s, self.p))
               for i, s in enumerate(slots)]
        return self.icrt(raw)

    def slot_mul_h(self, s_a, s_b):
        """Slotwise product in the NORMALIZED domain: every slot multiplies
        in the same field F (crt_h is a ring isomorphism, so this equals
        poly_mul through crt_h/icrt_h — property-pinned)."""
        if self.d == 1:
            return self.slot_mul(s_a, s_b)
        F = self.F
        return [list(F.mul(a, b)) for a, b in zip(s_a, s_b)]

    # -- sampling / decomposition --------------------------------------------
    def challenge_byte_size(self):
        """FromRandomBytes byte size: D coefficients x field bytes
        (models/<ring>/mod.rs FromRandomBytes impls)."""
        return self.D * (32 if self.p >> 64 else 8)

    def rand(self, rng):
        return [int(rng.integers(0, 1 << 62)) % self.p
                for _ in range(self.D)]

    def decompose_balanced(self, coeffs, b: int, L: int):
        """Balanced base-b digits of each coefficient (digits in
        [-b/2, b/2]), least-significant first — decomposition.rs analog."""
        half = self.p // 2
        digs = [[0] * self.D for _ in range(L)]
        for i, v in enumerate(coeffs):
            x = int(v)
            if x > half:
                x -= self.p          # balanced lift
            for k in range(L):
                r = x % b
                if r > b // 2:
                    r -= b
                digs[k][i] = r % self.p
                x = (x - r) // b
        return digs

    def recompose(self, digs, b: int):
        out = [0] * self.D
        for k, dig in enumerate(digs):
            w = pow(b, k, self.p)
            for i in range(self.D):
                out[i] = (out[i] + dig[i] * w) % self.p
        return out


# -- slot-field normalization (homogenize analogs) ---------------------------
#
# The reference's CRT ends with per-slot isomorphisms into ONE extension
# field Fq[Y]/(Y^d - W) (models/babybear/ntt.rs:326-437 homogenize_fq9,
# goldilocks/ntt.rs homogenize_fq3): slot i's residue ring Fq[X]/(X^d - r_i)
# maps by X -> rho_i where rho_i is a root of X^d - r_i in the common field.
# The reference bakes Sage-derived constants; here the rho_i are computed
# (d-th roots via Pohlig-Hellman discrete logs — the model fields' p-1 are
# smooth) and the isomorphism property is pinned by tests instead.

class SlotField:
    """Fq[Y]/(Y^d - W): the common (normalized) slot extension field."""

    def __init__(self, p: int, d: int, W: int):
        self.p, self.d, self.W = p, d, W % p

    def zero(self):
        return (0,) * self.d

    def one(self):
        return (1,) + (0,) * (self.d - 1)

    def of(self, x):
        """int or d-tuple -> canonical d-tuple."""
        if isinstance(x, (int,)):
            return (x % self.p,) + (0,) * (self.d - 1)
        t = tuple(int(v) % self.p for v in x)
        assert len(t) == self.d
        return t

    def add(self, a, b):
        a, b = self.of(a), self.of(b)
        return tuple((x + y) % self.p for x, y in zip(a, b))

    def sub(self, a, b):
        a, b = self.of(a), self.of(b)
        return tuple((x - y) % self.p for x, y in zip(a, b))

    def mul(self, a, b):
        a, b = self.of(a), self.of(b)
        p, d, W = self.p, self.d, self.W
        conv = [0] * (2 * d - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    conv[i + j] = (conv[i + j] + ai * bj) % p
        res = list(conv[:d])
        for i in range(d, 2 * d - 1):
            res[i - d] = (res[i - d] + W * conv[i]) % p
        return tuple(res)

    def pow(self, a, e: int):
        r = self.one()
        b = self.of(a)
        e = int(e)
        while e:
            if e & 1:
                r = self.mul(r, b)
            b = self.mul(b, b)
            e >>= 1
        return r

    def inv(self, a):
        # field inverse via a^(p^d - 2)
        return self.pow(a, self.p ** self.d - 2)


def _bsgs_dlog(g, h, n, p):
    """x with g^x = h (ord(g) = n), baby-step giant-step."""
    m = int(n ** 0.5) + 1
    table = {}
    cur = 1
    for j in range(m):
        table.setdefault(cur, j)
        cur = cur * g % p
    gm_inv = pow(pow(g, m, p), p - 2, p)
    cur = h % p
    for i in range(m):
        if cur in table:
            return (i * m + table[cur]) % n
        cur = cur * gm_inv % p
    raise ValueError("dlog not found")


def _pohlig_hellman(g, h, p, factors):
    """dlog of h base g in Fp* (order p-1 with the given prime factors)."""
    n = p - 1
    residues, moduli = [], []
    for q in sorted(set(factors)):
        e = 0
        m = n
        while m % q == 0:
            e += 1
            m //= q
        qe = q ** e
        gq = pow(g, n // qe, p)
        hq = pow(h, n // qe, p)
        # solve in the order-qe subgroup digit by digit
        x = 0
        gamma = pow(gq, q ** (e - 1), p)        # order q
        for k in range(e):
            hk = pow(hq * pow(gq, (-x) % n, p) % p, q ** (e - 1 - k), p)
            dk = _bsgs_dlog(gamma, hk, q, p)
            x += dk * (q ** k)
        residues.append(x % qe)
        moduli.append(qe)
    # CRT combine (factor list must cover p - 1 completely)
    x, M = 0, 1
    for r, m in zip(residues, moduli):
        t = (r - x) * pow(M, -1, m) % m
        x = x + M * t
        M *= m
    assert M == n, "incomplete p-1 factorization"
    return x % n


def _dth_root(t, d, p, factors):
    """u with u^d = t mod p, or None.  Needs the prime factors of p-1."""
    t %= p
    if t == 0:
        return 0
    # find a generator
    n = p - 1
    qs = sorted(set(factors))
    g = None
    for cand in range(2, 1000):
        if all(pow(cand, n // q, p) != 1 for q in qs):
            g = cand
            break
    assert g is not None
    e = _pohlig_hellman(g, t, p, qs)
    gcd_ = __import__("math").gcd(d, n)
    if e % gcd_:
        return None
    # solve d*x = e (mod n)
    d2, e2, n2 = d // gcd_, e // gcd_, n // gcd_
    x = e2 * pow(d2, -1, n2) % n2
    return pow(g, x, p)


PM1_FACTORS = {
    # p - 1 prime factors (enables computed homogenization isomorphisms)
    BABYBEAR_P: [2, 3, 5],
    GOLDILOCKS_P: [2, 3, 5, 17, 257, 65537],
}


def _hom_setup(model):
    """Per-slot isomorphism matrices slot_i <-> Fq[Y]/(Y^d - W), W = r_0.

    hom_i: coords of a(X) mod (X^d - r_i) -> coords of a(rho_i) in the
    Y-basis, where rho_i^d = r_i in the common field.  Returns
    (SlotField, [d x d hom matrices], [inverse matrices])."""
    p, d = model.p, model.d
    W = model.slot_roots[0] % p
    F = SlotField(p, d, W)
    factors = PM1_FACTORS[p]
    homs, dehoms = [], []
    for r in model.slot_roots:
        rho = None
        for a in range(d):
            # try rho = Y^a * u with u^d = r / W^a in Fq
            t = r * pow(pow(W, a, p), p - 2, p) % p
            u = _dth_root(t, d, p, factors)
            if u is not None:
                rho = tuple((u if j == a else 0) for j in range(d))
                break
        assert rho is not None, f"no d-th root structure for slot root {r}"
        assert F.pow(rho, d) == F.of(r), "rho^d != r"
        # columns: rho^j coordinates
        pows = [F.one()]
        for _ in range(1, d):
            pows.append(F.mul(pows[-1], rho))
        M = [[pows[j][i] for j in range(d)] for i in range(d)]   # (d, d)
        homs.append(M)
        dehoms.append(_invert_mod(M, p))
    return F, homs, dehoms


def _matvec_mod(M, v, p):
    return tuple(sum(M[i][j] * v[j] for j in range(len(v))) % p
                 for i in range(len(v)))


def _invert_mod(A, p):
    n = len(A)
    M = [row[:] + [1 if i == j else 0 for j in range(n)]
         for i, row in enumerate(A)]
    for col in range(n):
        piv = next(r for r in range(col, n) if M[r][col] % p)
        M[col], M[piv] = M[piv], M[col]
        inv = pow(M[col][col], p - 2, p)
        M[col] = [v * inv % p for v in M[col]]
        for r in range(n):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [(M[r][j] - f * M[col][j]) % p for j in range(2 * n)]
    return [row[n:] for row in M]


def _pows(base, idxs, p):
    return [pow(base, i, p) for i in idxs]


BABYBEAR = CyclotomicModel(
    "babybear", BABYBEAR_P, 72, 8, 1,
    [BABYBEAR_ROOTS_24[i] for i in (1, 13, 7, 19, 5, 17, 11, 23)])

FROG = CyclotomicModel(
    "frog", FROG_P, 16, 4, 0,
    [FROG_ROOTS_8[i] for i in (1, 5, 3, 7)])

STARK = CyclotomicModel(
    "stark_prime", STARK_P, 16, 16, 0,
    [STARK_ROOTS_32[i] for i in (1, 17, 9, 25, 5, 21, 13, 29,
                                 3, 19, 11, 27, 7, 23, 15, 31)])

# goldilocks slot roots: 24th roots g^i, g = 2^40, same power order as
# babybear (goldilocks/ntt.rs; cross-checked against ring/ref_impl.py)
_GL_ROOTS_24 = [pow(1 << 40, i, GOLDILOCKS_P) for i in range(24)]
GOLDILOCKS = CyclotomicModel(
    "goldilocks", GOLDILOCKS_P, 24, 8, 1,
    [_GL_ROOTS_24[i] for i in (1, 13, 7, 19, 5, 17, 11, 23)])

MODELS = {m.name: m for m in (BABYBEAR, FROG, STARK, GOLDILOCKS)}
