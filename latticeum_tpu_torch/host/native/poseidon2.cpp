// Native Poseidon2-Goldilocks core for the zkVM runtime.
//
// The TPU handles batched hashing (Merkle leaves); this library covers the
// inherently SEQUENTIAL paths that Python is too slow for and a TPU cannot
// parallelize: the whole-memory sponge chain (commitments.rs:192-217 maps
// 2M words through one absorb chain), the Fiat-Shamir duplex challenger,
// and single-shot permutations.  Exposed via a C ABI for ctypes.
//
// Field: p = 2^64 - 2^32 + 1; reduction uses 2^64 = 2^32 - 1 (mod p).
// Constants are injected from Python at init (single source of truth:
// latticeum_tpu_torch/host/crypto/consts.py).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

static const u64 P = 0xFFFFFFFF00000001ULL;
static const u64 EPS = 0xFFFFFFFFULL;

static inline u64 reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & 0xFFFFFFFFULL;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPS;           // borrow: subtract 2^32-1
    u64 t1 = hi_lo * EPS;
    u64 t2 = t0 + t1;
    if (t2 < t0) t2 += EPS;              // carry: add 2^32-1
    if (t2 >= P) t2 -= P;
    return t2;
}

static inline u64 fmul(u64 a, u64 b) { return reduce128((u128)a * b); }
static inline u64 fadd(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a || s >= P) s -= P;
    return s;
}

static inline u64 sbox7(u64 x) {
    u64 x2 = fmul(x, x);
    u64 x4 = fmul(x2, x2);
    u64 x6 = fmul(x4, x2);
    return fmul(x6, x);
}

// constants (filled by p2_init)
static u64 W8_INIT[4][8], W8_TERM[4][8];
static u64 W16_INIT[4][16], W16_TERM[4][16];
static u64 INTERNAL22[22];
static u64 DIAG8[8], DIAG16[16];

extern "C" void p2_init(const u64* w8i, const u64* w8t, const u64* w16i,
                        const u64* w16t, const u64* internal,
                        const u64* diag8, const u64* diag16) {
    memcpy(W8_INIT, w8i, sizeof(W8_INIT));
    memcpy(W8_TERM, w8t, sizeof(W8_TERM));
    memcpy(W16_INIT, w16i, sizeof(W16_INIT));
    memcpy(W16_TERM, w16t, sizeof(W16_TERM));
    memcpy(INTERNAL22, internal, sizeof(INTERNAL22));
    memcpy(DIAG8, diag8, sizeof(DIAG8));
    memcpy(DIAG16, diag16, sizeof(DIAG16));
}

template <int W>
static inline void mds_light(u64* s) {
    // M4 block transform + circulant sums (poseidon2.rs:243-268)
    for (int b = 0; b < W; b += 4) {
        u64 c0 = s[b], c1 = s[b + 1], c2 = s[b + 2], c3 = s[b + 3];
        u64 t01 = fadd(c0, c1), t23 = fadd(c2, c3);
        u64 d0 = fadd(fadd(fadd(c0, c0), fadd(c1, fadd(c1, c1))), t23);
        u64 d1 = fadd(fadd(c0, fadd(c1, c1)),
                      fadd(fadd(c2, fadd(c2, c2)), c3));
        u64 d2 = fadd(t01, fadd(fadd(c2, c2), fadd(c3, fadd(c3, c3))));
        u64 d3 = fadd(fadd(fadd(c0, fadd(c0, c0)), c1), fadd(c2, fadd(c3, c3)));
        s[b] = d0; s[b + 1] = d1; s[b + 2] = d2; s[b + 3] = d3;
    }
    u64 sums[4];
    for (int k = 0; k < 4; k++) {
        sums[k] = 0;
        for (int j = k; j < W; j += 4) sums[k] = fadd(sums[k], s[j]);
    }
    for (int i = 0; i < W; i++) s[i] = fadd(s[i], sums[i & 3]);
}

template <int W>
static void perm(u64* s, const u64* ext_init, const u64* ext_term,
                 const u64* diag) {
    // ext_init/ext_term: 4 rounds x W constants, row-major
    mds_light<W>(s);
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < W; i++)
            s[i] = sbox7(fadd(s[i], ext_init[r * W + i]));
        mds_light<W>(s);
    }
    for (int r = 0; r < 22; r++) {
        s[0] = sbox7(fadd(s[0], INTERNAL22[r]));
        u64 tot = 0;
        for (int i = 0; i < W; i++) tot = fadd(tot, s[i]);
        for (int i = 0; i < W; i++) s[i] = fadd(fmul(s[i], diag[i]), tot);
    }
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < W; i++)
            s[i] = sbox7(fadd(s[i], ext_term[r * W + i]));
        mds_light<W>(s);
    }
}

extern "C" void p2_perm8(u64* state) {
    perm<8>(state, &W8_INIT[0][0], &W8_TERM[0][0], DIAG8);
}
extern "C" void p2_perm16(u64* state) {
    perm<16>(state, &W16_INIT[0][0], &W16_TERM[0][0], DIAG16);
}

// Padding-free width-8 sponge over a value stream -> 4-element digest
// (plonky3 PaddingFreeSponge semantics; poseidon2.rs:206-235 loop shape).
extern "C" void p2_hash_narrow(const u64* vals, u64 n, u64* out4) {
    u64 s[8] = {0};
    u64 pos = 0;
    while (pos < n) {
        u64 take = n - pos < 4 ? n - pos : 4;
        for (u64 i = 0; i < take; i++) s[i] = vals[pos + i] % P;
        p2_perm8(s);
        pos += take;
    }
    memcpy(out4, s, 4 * sizeof(u64));
}

// Wide sponge (width 16 / rate 12) -> 4-element digest.
extern "C" void p2_hash_wide(const u64* vals, u64 n, u64* out4) {
    u64 s[16] = {0};
    u64 pos = 0;
    while (pos < n) {
        u64 take = n - pos < 12 ? n - pos : 12;
        for (u64 i = 0; i < take; i++) s[i] = vals[pos + i] % P;
        p2_perm16(s);
        pos += take;
    }
    memcpy(out4, s, 4 * sizeof(u64));
}

// Batched width-8 leaf hashing: rows (count x row_len) -> digests (count x 4).
extern "C" void p2_hash_rows_narrow(const u64* rows, u64 count, u64 row_len,
                                    u64* out) {
    for (u64 r = 0; r < count; r++)
        p2_hash_narrow(rows + r * row_len, row_len, out + r * 4);
}

// One Merkle compression level: (2n x 4) digests -> (n x 4).
extern "C" void p2_compress_level(const u64* digests, u64 pairs, u64* out) {
    for (u64 i = 0; i < pairs; i++) {
        u64 s[8];
        memcpy(s, digests + i * 8, 8 * sizeof(u64));
        p2_perm8(s);
        memcpy(out + i * 4, s, 4 * sizeof(u64));
    }
}

// Duplex challenger (width 16, rate 12): state layout
//   st[0..16] sponge state, st[16] = input_len, st[17] = output_len,
//   st[18..30] input buffer, st[30..42] output buffer.
extern "C" void p2_duplex(u64* st) {
    for (u64 i = 0; i < st[16]; i++) st[i] = st[18 + i];
    st[16] = 0;
    p2_perm16(st);
    for (int i = 0; i < 12; i++) st[30 + i] = st[i];
    st[17] = 12;
}

extern "C" void p2_observe_many(u64* st, const u64* vals, u64 n) {
    for (u64 k = 0; k < n; k++) {
        st[17] = 0;  // clear output buffer
        st[18 + st[16]] = vals[k] % P;
        st[16]++;
        if (st[16] == 12) p2_duplex(st);
    }
}

extern "C" u64 p2_sample(u64* st) {
    if (st[16] > 0 || st[17] == 0) p2_duplex(st);
    st[17]--;
    return st[30 + st[17]];
}
