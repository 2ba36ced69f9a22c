// Ed25519 signing on the host: RFC 8032 key generation and deterministic
// signatures from a 32-byte seed.  The signing half of the JAX package's
// native/ed25519.cpp (SHA-512, the radix-2^51 field, scalars mod L with a
// Barrett reduction, extended-coordinate group formulas and a 4-bit
// fixed-window base-point multiplication), copied without its verifiers:
// the port verifies on the card only.
//
// Not constant time (the window lookup and the scalar walk branch on
// secret bits): for test keys and fixtures, not for a production signer.
//
// Exported C ABI (ctypes, see native.py):
//   ed25519_pubkey(seed32, out32)
//   ed25519_sign(seed32, msg, len, sig64)

#include <cstdint>
#include <cstring>
#include <cstdlib>

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef uint8_t u8;

// ------------------------------------------------------------------ sha512
// FIPS 180-4, straightforward from the spec.

static const u64 SHA_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

struct Sha512 {
    u64 h[8];
    u8 buf[128];
    u64 buflen;          // bytes currently in buf
    u64 total;           // total message bytes so far

    void init() {
        static const u64 iv[8] = {
            0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
            0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
            0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
            0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
        memcpy(h, iv, sizeof iv);
        buflen = 0;
        total = 0;
    }

    static inline u64 rotr(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

    void block(const u8* p) {
        u64 w[80];
        for (int i = 0; i < 16; i++) {
            w[i] = ((u64)p[8 * i] << 56) | ((u64)p[8 * i + 1] << 48) |
                   ((u64)p[8 * i + 2] << 40) | ((u64)p[8 * i + 3] << 32) |
                   ((u64)p[8 * i + 4] << 24) | ((u64)p[8 * i + 5] << 16) |
                   ((u64)p[8 * i + 6] << 8) | (u64)p[8 * i + 7];
        }
        for (int i = 16; i < 80; i++) {
            u64 s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
            u64 s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        u64 a = h[0], b = h[1], c = h[2], d = h[3];
        u64 e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 80; i++) {
            u64 S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
            u64 ch = (e & f) ^ (~e & g);
            u64 t1 = hh + S1 + ch + SHA_K[i] + w[i];
            u64 S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
            u64 maj = (a & b) ^ (a & c) ^ (b & c);
            u64 t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const u8* p, u64 n) {
        total += n;
        if (buflen) {
            u64 take = 128 - buflen;
            if (take > n) take = n;
            memcpy(buf + buflen, p, take);
            buflen += take;
            p += take;
            n -= take;
            if (buflen == 128) { block(buf); buflen = 0; }
        }
        while (n >= 128) { block(p); p += 128; n -= 128; }
        if (n) { memcpy(buf, p, n); buflen = n; }
    }

    void final(u8 out[64]) {
        u64 bits_hi = total >> 61, bits_lo = total << 3;
        u8 pad = 0x80;
        update(&pad, 1);
        static const u8 zeros[128] = {0};
        u64 rem = (buflen <= 112) ? 112 - buflen : 240 - buflen;
        update(zeros, rem);
        u8 lenb[16];
        for (int i = 0; i < 8; i++) lenb[i] = (u8)(bits_hi >> (56 - 8 * i));
        for (int i = 0; i < 8; i++) lenb[8 + i] = (u8)(bits_lo >> (56 - 8 * i));
        update(lenb, 16);
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++)
                out[8 * i + j] = (u8)(h[i] >> (56 - 8 * j));
    }
};

// ------------------------------------------------------- field GF(2^255-19)
// Radix-2^51: x = v[0] + v[1]*2^51 + ... + v[4]*2^204.  add/sub carry on
// exit, mul/sq reduce on exit, so every limb stays < 2^52 and u128
// accumulation (5 products of < 2^52 * 2^52 each) can never overflow.

struct fe { u64 v[5]; };

static const u64 MASK51 = (1ULL << 51) - 1;

static const fe FE_ZERO = {{0, 0, 0, 0, 0}};
static const fe FE_ONE = {{1, 0, 0, 0, 0}};
static const fe FE_D = {{0x34dca135978a3ULL, 0x1a8283b156ebdULL,
                         0x5e7a26001c029ULL, 0x739c663a03cbbULL,
                         0x52036cee2b6ffULL}};
static const fe FE_2D = {{0x69b9426b2f159ULL, 0x35050762add7aULL,
                          0x3cf44c0038052ULL, 0x6738cc7407977ULL,
                          0x2406d9dc56dffULL}};
static const fe FE_SQRTM1 = {{0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL,
                              0x7ef5e9cbd0c60ULL, 0x78595a6804c9eULL,
                              0x2b8324804fc1dULL}};

static inline void fe_carry(fe& r) {
    // two passes: after the first, every limb < 2^51 except possibly a
    // tiny spill into the next; the second settles it.  For ARBITRARY
    // limb magnitudes (frombytes, fold residue) — the add/sub hot path
    // uses the single-pass variant below.
    for (int pass = 0; pass < 2; pass++) {
        u64 c = r.v[4] >> 51;
        r.v[4] &= MASK51;
        r.v[0] += 19 * c;
        for (int i = 0; i < 4; i++) {
            c = r.v[i] >> 51;
            r.v[i] &= MASK51;
            r.v[i + 1] += c;
        }
    }
}

static inline void fe_carry1(fe& r) {
    // ONE pass suffices on the add/sub hot path: the weakly-reduced
    // form (limb < 2^51 + 2^7) is closed under add/sub/mul:
    //   - mul/sq outputs: the final fold "o0 += 19*c" can leave a tail
    //     carry into o1 of up to ~95 < 2^7 (c <= 5*2^51-ish from the
    //     u128 accumulation), every other limb < 2^51 — weakly reduced;
    //   - add of two such values: limbs < 2^52 + 2^8, so each pass-1
    //     carry is <= 2 and the 19*carry fold into limb 0 stays < 2^7
    //     — weakly reduced again;
    //   - sub's 2p bias per limb (2^52 - 2) strictly exceeds any weakly
    //     reduced subtrahend limb, so no underflow;
    //   - mul/sq accumulate 5 products of < 2^52 * 19*2^52 < 2^111
    //     each in u128 — no overflow — and reduce on exit;
    //   - fe_tobytes (hence iszero/isodd) re-runs the full two-pass
    //     carry before canonicalizing, so no consumer reads weak limbs.
    u64 c = r.v[4] >> 51;
    r.v[4] &= MASK51;
    r.v[0] += 19 * c;
    for (int i = 0; i < 4; i++) {
        c = r.v[i] >> 51;
        r.v[i] &= MASK51;
        r.v[i + 1] += c;
    }
}

static inline void fe_add(fe& r, const fe& a, const fe& b) {
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
    fe_carry1(r);
}

// 2p in radix 2^51 (bias so a-b can't underflow for reduced a, b)
static const u64 TWOP0 = 0xFFFFFFFFFFFDAULL;
static const u64 TWOPX = 0xFFFFFFFFFFFFEULL;

static inline void fe_sub(fe& r, const fe& a, const fe& b) {
    r.v[0] = a.v[0] + TWOP0 - b.v[0];
    for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + TWOPX - b.v[i];
    fe_carry1(r);
}

static inline void fe_neg(fe& r, const fe& a) { fe_sub(r, FE_ZERO, a); }

static inline void fe_mul(fe& r, const fe& a, const fe& b) {
    u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
    u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
    u64 t1 = 19 * b1, t2 = 19 * b2, t3 = 19 * b3, t4 = 19 * b4;
    u128 r0 = (u128)a0 * b0 + (u128)a1 * t4 + (u128)a2 * t3 +
              (u128)a3 * t2 + (u128)a4 * t1;
    u128 r1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * t4 +
              (u128)a3 * t3 + (u128)a4 * t2;
    u128 r2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
              (u128)a3 * t4 + (u128)a4 * t3;
    u128 r3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 +
              (u128)a3 * b0 + (u128)a4 * t4;
    u128 r4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 +
              (u128)a3 * b1 + (u128)a4 * b0;
    u64 c;
    u64 o0 = (u64)r0 & MASK51; c = (u64)(r0 >> 51);
    r1 += c;
    u64 o1 = (u64)r1 & MASK51; c = (u64)(r1 >> 51);
    r2 += c;
    u64 o2 = (u64)r2 & MASK51; c = (u64)(r2 >> 51);
    r3 += c;
    u64 o3 = (u64)r3 & MASK51; c = (u64)(r3 >> 51);
    r4 += c;
    u64 o4 = (u64)r4 & MASK51; c = (u64)(r4 >> 51);
    o0 += 19 * c;
    c = o0 >> 51; o0 &= MASK51; o1 += c;
    r.v[0] = o0; r.v[1] = o1; r.v[2] = o2; r.v[3] = o3; r.v[4] = o4;
}

static inline void fe_sq(fe& r, const fe& a) {
    u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
    u64 a0_2 = 2 * a0, a1_2 = 2 * a1;
    u64 a3_19 = 19 * a3, a4_19 = 19 * a4, a4_38 = 38 * a4, a3_38 = 38 * a3;
    u128 r0 = (u128)a0 * a0 + (u128)a4_38 * a1 + (u128)a3_38 * a2;
    u128 r1 = (u128)a0_2 * a1 + (u128)a4_38 * a2 + (u128)a3_19 * a3;
    u128 r2 = (u128)a0_2 * a2 + (u128)a1 * a1 + (u128)a4_38 * a3;
    u128 r3 = (u128)a0_2 * a3 + (u128)a1_2 * a2 + (u128)a4_19 * a4;
    u128 r4 = (u128)a0_2 * a4 + (u128)a1_2 * a3 + (u128)a2 * a2;
    u64 c;
    u64 o0 = (u64)r0 & MASK51; c = (u64)(r0 >> 51);
    r1 += c;
    u64 o1 = (u64)r1 & MASK51; c = (u64)(r1 >> 51);
    r2 += c;
    u64 o2 = (u64)r2 & MASK51; c = (u64)(r2 >> 51);
    r3 += c;
    u64 o3 = (u64)r3 & MASK51; c = (u64)(r3 >> 51);
    r4 += c;
    u64 o4 = (u64)r4 & MASK51; c = (u64)(r4 >> 51);
    o0 += 19 * c;
    c = o0 >> 51; o0 &= MASK51; o1 += c;
    r.v[0] = o0; r.v[1] = o1; r.v[2] = o2; r.v[3] = o3; r.v[4] = o4;
}

static inline void fe_sqn(fe& r, const fe& a, int n) {
    fe_sq(r, a);
    for (int i = 1; i < n; i++) fe_sq(r, r);
}

static void fe_tobytes(u8 s[32], const fe& a) {
    fe t = a;
    fe_carry(t);
    // canonical reduction: add 19, propagate, drop bit 255, subtract 19
    // trick — compute t + 19, if it overflows 2^255 then t >= p
    u64 q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;              // q = 1 iff t >= p
    t.v[0] += 19 * q;
    u64 c;
    c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
    c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
    c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
    c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
    t.v[4] &= MASK51;                    // drop 2^255
    u64 w0 = t.v[0] | (t.v[1] << 51);
    u64 w1 = (t.v[1] >> 13) | (t.v[2] << 38);
    u64 w2 = (t.v[2] >> 26) | (t.v[3] << 25);
    u64 w3 = (t.v[3] >> 39) | (t.v[4] << 12);
    u64 w[4] = {w0, w1, w2, w3};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) s[8 * i + j] = (u8)(w[i] >> (8 * j));
}

static bool fe_isodd(const fe& a) {
    u8 s[32];
    fe_tobytes(s, a);
    return s[0] & 1;
}

// shared prefix of the 2^255-21 and 2^252-3 addition chains: returns
// z^(2^250 - 1) in r250, plus z^11 and z^(2^10-1) used by the callers
static void fe_chain250(fe& r250, fe& z11, fe& z10_0, const fe& z) {
    fe z2, t, z9, z5_0;
    fe_sq(z2, z);                        // 2
    fe_sqn(t, z2, 2);                    // 8
    fe_mul(z9, t, z);                    // 9
    fe_mul(z11, z9, z2);                 // 11
    fe_sq(t, z11);                       // 22
    fe_mul(z5_0, t, z9);                 // 2^5 - 1
    fe_sqn(t, z5_0, 5);
    fe_mul(z10_0, t, z5_0);              // 2^10 - 1
    fe_sqn(t, z10_0, 10);
    fe mid;
    fe_mul(mid, t, z10_0);               // 2^20 - 1
    fe_sqn(t, mid, 20);
    fe_mul(t, t, mid);                   // 2^40 - 1
    fe_sqn(t, t, 10);
    fe z50_0;
    fe_mul(z50_0, t, z10_0);             // 2^50 - 1
    fe_sqn(t, z50_0, 50);
    fe z100_0;
    fe_mul(z100_0, t, z50_0);            // 2^100 - 1
    fe_sqn(t, z100_0, 100);
    fe_mul(t, t, z100_0);                // 2^200 - 1
    fe_sqn(t, t, 50);
    fe_mul(r250, t, z50_0);              // 2^250 - 1
}

static void fe_invert(fe& r, const fe& a) {
    // a^(p-2) = a^(2^255 - 21)
    fe z250, z11, z10_0, t;
    fe_chain250(z250, z11, z10_0, a);
    fe_sqn(t, z250, 5);                  // 2^255 - 2^5
    fe_mul(r, t, z11);                   // 2^255 - 32 + 11 = 2^255 - 21
}

// ------------------------------------------------------------ scalars mod L

// L = 2^252 + 27742317777372353535851937790883648493, little-endian limbs
static const u64 SC_L[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                            0x0ULL, 0x1000000000000000ULL};
// mu = floor(2^512 / L), 260 bits (5 limbs)
static const u64 SC_MU[5] = {0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL,
                             0xffffffffffffffebULL, 0xffffffffffffffffULL,
                             0xfULL};

struct sc { u64 v[4]; };     // always < L

static inline int sc_geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static inline void sc_sub4(u64 a[4], const u64 b[4]) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u64 bi = b[i] + borrow;
        borrow = (bi < borrow) ? 1 : (a[i] < bi ? 1 : 0);
        a[i] = a[i] - bi;
    }
}

// Barrett: reduce a 512-bit value (8 limbs LE) mod L
static void sc_reduce512(sc& r, const u64 x[8]) {
    // q = (x * mu) >> 512, keeping only the limbs we need
    u64 prod[13] = {0};
    for (int i = 0; i < 8; i++) {
        u64 carry = 0;
        for (int j = 0; j < 5; j++) {
            u128 t = (u128)x[i] * SC_MU[j] + prod[i + j] + carry;
            prod[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        prod[i + 5] = carry;
    }
    u64 q[5];
    for (int i = 0; i < 5; i++) q[i] = prod[8 + i];
    // r = x - q*L  (low 8 limbs; result < 3L fits in 4)
    u64 ql[8] = {0};
    for (int i = 0; i < 5; i++) {
        u64 carry = 0;
        for (int j = 0; j < 4 && i + j < 8; j++) {
            u128 t = (u128)q[i] * SC_L[j] + ql[i + j] + carry;
            ql[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        if (i + 4 < 8) ql[i + 4] += carry;
    }
    u64 rem[8];
    u64 borrow = 0;
    for (int i = 0; i < 8; i++) {
        u64 bi = ql[i] + borrow;
        borrow = (bi < borrow) ? 1 : (x[i] < bi ? 1 : 0);
        rem[i] = x[i] - bi;
    }
    // at most two conditional subtracts (r < 3L and L > 2^252)
    for (int k = 0; k < 2; k++)
        if (rem[4] | rem[5] | rem[6] | rem[7] || sc_geq(rem, SC_L)) {
            u64 borrow2 = 0;
            for (int i = 0; i < 8; i++) {
                u64 bi = (i < 4 ? SC_L[i] : 0) + borrow2;
                borrow2 = (bi < borrow2) ? 1 : (rem[i] < bi ? 1 : 0);
                rem[i] = rem[i] - bi;
            }
        }
    for (int i = 0; i < 4; i++) r.v[i] = rem[i];
}

static void sc_from_bytes64(sc& r, const u8 b[64]) {
    u64 x[8];
    for (int i = 0; i < 8; i++) {
        x[i] = 0;
        for (int j = 0; j < 8; j++) x[i] |= (u64)b[8 * i + j] << (8 * j);
    }
    sc_reduce512(r, x);
}

static void sc_mul(sc& r, const sc& a, const sc& b) {
    u64 prod[8] = {0};
    for (int i = 0; i < 4; i++) {
        u64 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)a.v[i] * b.v[j] + prod[i + j] + carry;
            prod[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        prod[i + 4] = carry;
    }
    sc_reduce512(r, prod);
}

static void sc_add(sc& r, const sc& a, const sc& b) {
    u64 carry = 0;
    for (int i = 0; i < 4; i++) {
        u64 s = a.v[i] + carry;
        carry = (s < carry) ? 1 : 0;
        r.v[i] = s + b.v[i];
        if (r.v[i] < s) carry = 1;
    }
    if (carry || sc_geq(r.v, SC_L)) sc_sub4(r.v, SC_L);
}

static inline int sc_bit(const sc& a, int i) {
    return (int)((a.v[i >> 6] >> (i & 63)) & 1);
}

static inline int sc_window(const sc& a, int pos, int width) {
    // bits [pos, pos+width) of the 256-bit scalar, little-endian
    int word = pos >> 6, shift = pos & 63;
    u64 w = a.v[word] >> shift;
    if (shift + width > 64 && word + 1 < 4)
        w |= a.v[word + 1] << (64 - shift);
    return (int)(w & ((1ULL << width) - 1));
}

// ----------------------------------------------------------- group elements
// Extended coordinates (X:Y:Z:T), x = X/Z, y = Y/Z, T = XY/Z.

struct ge { fe X, Y, Z, T; };

static const ge GE_ID = {FE_ZERO, FE_ONE, FE_ONE, FE_ZERO};

// the ed25519 base point, fully constant (T = Bx*By mod p precomputed)
// so there is no runtime init and no init race across threads
static const ge BASE_POINT = {
    {{0x62d608f25d51aULL, 0x412a4b4f6592aULL, 0x75b7171a4b31dULL,
      0x1ff60527118feULL, 0x216936d3cd6e5ULL}},
    {{0x6666666666658ULL, 0x4ccccccccccccULL, 0x1999999999999ULL,
      0x3333333333333ULL, 0x6666666666666ULL}},
    FE_ONE,
    {{0x68ab3a5b7dda3ULL, 0xeea2a5eadbbULL, 0x2af8df483c27eULL,
      0x332b375274732ULL, 0x67875f0fd78b7ULL}}};

// unified addition (complete for a=-1 square, d nonsquare: every curve
// point including ZIP-215's small-torsion components)
static void ge_add(ge& r, const ge& p, const ge& q) {
    fe a, b, c, d, e, f, g, h, t;
    fe_sub(a, p.Y, p.X);
    fe_sub(t, q.Y, q.X);
    fe_mul(a, a, t);                    // A = (Y1-X1)(Y2-X2)
    fe_add(b, p.Y, p.X);
    fe_add(t, q.Y, q.X);
    fe_mul(b, b, t);                    // B = (Y1+X1)(Y2+X2)
    fe_mul(c, p.T, q.T);
    fe_mul(c, c, FE_2D);                // C = 2d T1 T2
    fe_mul(d, p.Z, q.Z);
    fe_add(d, d, d);                    // D = 2 Z1 Z2
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.X, e, f);
    fe_mul(r.Y, g, h);
    fe_mul(r.T, e, h);
    fe_mul(r.Z, f, g);
}

static void ge_double(ge& r, const ge& p) {
    // dbl-2008-hwcd with a = -1 (D = -A folded into each expression)
    fe a, b, c, e, f, g, h, t;
    fe_sq(a, p.X);                      // A = X^2
    fe_sq(b, p.Y);                      // B = Y^2
    fe_sq(c, p.Z);
    fe_add(c, c, c);                    // C = 2 Z^2
    fe_add(t, p.X, p.Y);
    fe_sq(t, t);
    fe_sub(e, t, a);
    fe_sub(e, e, b);                    // E = (X+Y)^2 - A - B
    fe_sub(g, b, a);                    // G = D + B = B - A
    fe_sub(f, g, c);                    // F = G - C
    fe_add(h, a, b);
    fe_neg(h, h);                       // H = D - B = -(A + B)
    fe_mul(r.X, e, f);
    fe_mul(r.Y, g, h);
    fe_mul(r.T, e, h);
    fe_mul(r.Z, f, g);
}

// fixed-window (4-bit) scalar multiplication for the single-verify path
static void ge_scalarmul(ge& r, const sc& k, const ge& p) {
    ge tab[16];
    tab[0] = GE_ID;
    tab[1] = p;
    for (int i = 2; i < 16; i++) ge_add(tab[i], tab[i - 1], p);
    ge acc = GE_ID;
    for (int w = 63; w >= 0; w--) {
        for (int i = 0; i < 4; i++) ge_double(acc, acc);
        int nib = sc_window(k, 4 * w, 4);
        if (nib) ge_add(acc, acc, tab[nib]);
    }
    r = acc;
}

// compress to the wire encoding: y with sign(x) in the top bit
static void ge_compress(u8 out[32], const ge& p) {
    fe zi, x, y;
    fe_invert(zi, p.Z);
    fe_mul(x, p.X, zi);
    fe_mul(y, p.Y, zi);
    fe_tobytes(out, y);
    if (fe_isodd(x)) out[31] |= 0x80;
}

// expanded secret: a = clamp(SHA512(seed)[0:32]) mod L, prefix = [32:64].
// Reduction mod L before the ladder is sound: B has order L.
static void ed25519_expand_seed(const u8* seed, sc& a, u8 prefix[32],
                                u8 pub[32]) {
    u8 h[64];
    Sha512 sh;
    sh.init();
    sh.update(seed, 32);
    sh.final(h);
    h[0] &= 248; h[31] &= 127; h[31] |= 64;
    u8 wide[64] = {0};
    memcpy(wide, h, 32);
    sc_from_bytes64(a, wide);
    memcpy(prefix, h + 32, 32);
    ge A;
    ge_scalarmul(A, a, BASE_POINT);
    ge_compress(pub, A);
}

extern "C" {

// public key from a 32-byte seed (RFC 8032 key generation)
void ed25519_pubkey(const u8* seed, u8* out32) {
    sc a;
    u8 prefix[32];
    ed25519_expand_seed(seed, a, prefix, out32);
}

// RFC 8032 deterministic signature from a 32-byte seed
void ed25519_sign(const u8* seed, const u8* msg, u64 msg_len, u8* sig64) {
    sc a;
    u8 prefix[32], pub[32];
    ed25519_expand_seed(seed, a, prefix, pub);
    u8 r64[64];
    Sha512 s2;
    s2.init();
    s2.update(prefix, 32);
    s2.update(msg, msg_len);
    s2.final(r64);
    sc r;
    sc_from_bytes64(r, r64);
    ge R;
    ge_scalarmul(R, r, BASE_POINT);
    ge_compress(sig64, R);
    u8 k64[64];
    Sha512 s3;
    s3.init();
    s3.update(sig64, 32);
    s3.update(pub, 32);
    s3.update(msg, msg_len);
    s3.final(k64);
    sc k, ka, S;
    sc_from_bytes64(k, k64);
    sc_mul(ka, k, a);
    sc_add(S, r, ka);
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            sig64[32 + 8 * i + j] = (u8)(S.v[i] >> (8 * j));
}

}  // extern "C"
