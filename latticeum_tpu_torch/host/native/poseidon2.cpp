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

// Every function below is free of data-dependent branches: the carries and
// comparisons of field arithmetic are random, so a branch on them would
// mispredict on about every other operation.  Carries come from the
// overflow builtins and turn into masks.  Inside a permutation a value is
// any u64 of its residue; only the linear layer's outputs, and so every
// state a permutation returns, are canonical, in [0, p).

static inline u64 mask(bool b) { return (u64)0 - (u64)b; }

// Any u64 -> canonical: one conditional subtract, as 2^64 < 2p.
static inline u64 canon(u64 x) { return x - (P & mask(x >= P)); }

// Any 128-bit x -> a u64 of its residue (not canonical).  x = lo + hl 2^64
// + hh 2^96, with 2^64 = EPS and 2^96 = -1 (mod p).
static inline u64 reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u64 t0;
    bool borrow = __builtin_sub_overflow(lo, hi >> 32, &t0);
    t0 -= EPS & mask(borrow);            // borrow: 2^64 = EPS
    u64 t1;
    bool carry = __builtin_add_overflow(t0, (hi & EPS) * EPS, &t1);
    return t1 + (EPS & mask(carry));     // cannot carry again
}

// x below 2^96 (the linear layer's sums) -> x mod p, canonical: lo + hi EPS.
// canon(reduce128(x)) gives the same; this form saves a subtract and a mask
// a lane, and the core runs 10-17 % faster with it (20,000 chained width-16
// permutations, g++ -O3 on an x86 Xeon: 3.5-4.5 against 3.9-5.2 us each).
static inline u64 reduce96(u128 x) {
    u64 t;
    bool carry = __builtin_add_overflow((u64)x, (u64)(x >> 64) * EPS, &t);
    return canon(t + (EPS & mask(carry)));
}

static inline u64 fmul(u64 a, u64 b) { return reduce128((u128)a * b); }

// Any a, canonical b -> a u64 of the residue of a + b.
static inline u64 add_lazy(u64 a, u64 b) {
    u64 s;
    bool carry = __builtin_add_overflow(a, b, &s);
    return s + (EPS & mask(carry));      // a + b < 2^64 + p: no carry again
}

static inline u64 sbox7(u64 x) {
    u64 x2 = fmul(x, x);
    u64 x3 = fmul(x2, x);
    u64 x4 = fmul(x2, x2);
    return fmul(x4, x3);
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
    // M4 block transform + circulant sums (poseidon2.rs:243-268), summed
    // unreduced in 128 bits (each output at most 7 + 7 W / 4 times 2^64,
    // so any u64 input is taken) and reduced once a lane.
    u128 d[W];
    for (int b = 0; b < W; b += 4) {
        u128 c0 = s[b], c1 = s[b + 1], c2 = s[b + 2], c3 = s[b + 3];
        u128 t01 = c0 + c1, t23 = c2 + c3, t0123 = t01 + t23;
        u128 t01123 = t0123 + c1, t01233 = t0123 + c3;
        d[b] = t01123 + t01;                 // 2 c0 + 3 c1 + c2 + c3
        d[b + 1] = t01123 + 2 * c2;          // c0 + 2 c1 + 3 c2 + c3
        d[b + 2] = t01233 + t23;             // c0 + c1 + 2 c2 + 3 c3
        d[b + 3] = t01233 + 2 * c0;          // 3 c0 + c1 + c2 + 2 c3
    }
    u128 sums[4];
    for (int k = 0; k < 4; k++) {
        sums[k] = d[k];
        for (int j = k + 4; j < W; j += 4) sums[k] += d[j];
    }
    for (int i = 0; i < W; i++) s[i] = reduce96(d[i] + sums[i & 3]);
}

template <int W>
static void perm(u64* s, const u64* ext_init, const u64* ext_term,
                 const u64* diag) {
    // ext_init/ext_term: 4 rounds x W constants, row-major.  s may hold
    // any u64, as the first linear layer reduces it.
    mds_light<W>(s);
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < W; i++)
            s[i] = sbox7(add_lazy(s[i], ext_init[r * W + i]));
        mds_light<W>(s);
    }
    for (int r = 0; r < 22; r++) {
        // (Diag(d) + J) s: the sum (below W 2^64) stays unreduced, and
        // each lane's s d + sum, below 2^64 p + W 2^64 < 2^128, is reduced
        // once
        s[0] = sbox7(add_lazy(s[0], INTERNAL22[r]));
        u128 tot = 0;
        for (int i = 0; i < W; i++) tot += s[i];
        for (int i = 0; i < W; i++)
            s[i] = reduce128((u128)s[i] * diag[i] + tot);
    }
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < W; i++)
            s[i] = sbox7(add_lazy(s[i], ext_term[r * W + i]));
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
        // raw u64 in: the permutation's first linear layer reduces them
        for (u64 i = 0; i < take; i++) s[i] = vals[pos + i];
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
        for (u64 i = 0; i < take; i++) s[i] = vals[pos + i];
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
        st[18 + st[16]] = canon(vals[k]);  // the buffer is read as it is
        st[16]++;
        if (st[16] == 12) p2_duplex(st);
    }
}

extern "C" u64 p2_sample(u64* st) {
    if (st[16] > 0 || st[17] == 0) p2_duplex(st);
    st[17]--;
    return st[30 + st[17]];
}
