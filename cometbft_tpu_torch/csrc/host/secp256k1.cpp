// secp256k1 ECDSA for the port's host (reference seam:
// crypto/secp256k1/secp256k1.go).  Verification is a copy of the JAX
// package's cometbft_tpu/native/secp256k1.cpp: radix-2^52 field limbs
// with unsigned __int128 accumulation, Jacobian point arithmetic (a=0
// short Weierstrass), Barrett scalar arithmetic mod n, and one Shamir
// joint ladder for u1*G + u2*Q.  Semantics: 33-byte compressed pubkeys,
// 64-byte r||s big-endian signatures, 1 <= r,s < n, LOW-S ONLY,
// e = SHA-256(msg) mod n, valid iff R != inf and R.x mod n == r.
//
// Added for the port, over the same field, scalar and group code: key
// derivation and RFC 6979 signing (HMAC-SHA256 nonces, S normalised to
// the low half), byte for byte the JAX package's
// cometbft_tpu/crypto/_secp256k1_py.py, and RIPEMD-160 for addresses.
// The signer's base-point ladder skips zero windows and its inversions
// are variable-time: keys made here are for tests, fixtures and
// in-process networks, not for a validator that signs in production.
//
// Exported C ABI (ctypes):
//   secp256k1_verify(pub33, sig64, msg, msg_len) -> 1/0
//   secp256k1_verify_batch(pubs, sigs, msgs, offs, n, out) -> lanes ok
//   secp256k1_pubkey(d32, out33) -> 1, or 0 when d is not in [1, n)
//   secp256k1_sign(d32, msg, msg_len, out64) -> 1, or 0 (d not in [1, n))
//   ripemd160(msg, len, out20)

#include <cstdint>
#include <cstring>

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef uint8_t u8;

// ------------------------------------------------------------------ sha256
// Shared implementation (sha256_inline.h); thin shim keeps this file's
// call sites unchanged.

#include "sha256_inline.h"

static void sha256(const u8* msg, u64 len, u8 out[32]) {
    sha256i::oneshot(msg, len, out);
}

// ----------------------------------------------- field GF(2^256 - 2^32 - 977)
// Radix-2^52, 5 limbs.  2^260 == 16*C (mod p) with C = 2^32 + 977, so
// overflow limbs fold back with a single small multiply.

struct fe { u64 v[5]; };

static const u64 M52 = (1ULL << 52) - 1;
static const u64 C16 = 0x1000003D10ULL;     // 16 * (2^32 + 977)

static const fe FE_SEVEN = {{7, 0, 0, 0, 0}};
static const fe GX = {{0x2815b16f81798ULL, 0xdb2dce28d959fULL,
                       0xe870b07029bfcULL, 0xbbac55a06295cULL,
                       0x79be667ef9dcULL}};
static const fe GY = {{0x7d08ffb10d4b8ULL, 0x48a68554199c4ULL,
                       0xe1108a8fd17b4ULL, 0xc4655da4fbfc0ULL,
                       0x483ada7726a3ULL}};

static inline void fe_carry_weak(fe& r) {
    // bring limbs under ~2^52 (top limb may hold up to 2^48+eps after a
    // fold; 2^260 overflow recycles through C16/16 at limb 0)
    u64 c;
    c = r.v[4] >> 48;            // keep top limb at 48 bits so products
    r.v[4] &= (1ULL << 48) - 1;  // never reach the fold limit
    // c * 2^(4*52+48) = c * 2^256 == c * (2^32+977) = c * (C16 >> 4)
    u128 t = (u128)c * (C16 >> 4) + r.v[0];
    r.v[0] = (u64)t & M52;
    r.v[1] += (u64)(t >> 52);
    for (int i = 1; i < 4; i++) {
        c = r.v[i] >> 52;
        r.v[i] &= M52;
        r.v[i + 1] += c;
    }
}

static inline void fe_add(fe& r, const fe& a, const fe& b) {
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
    fe_carry_weak(r);
}

// 4p as per-limb multiples (NOT normalized) for the subtraction bias:
// every limb is >= 2^53, strictly above the largest weakly-reduced
// operand limb (~2^52 + 2^41), so a.v[i] + BIAS4P[i] - b.v[i] can never
// underflow u64 (a 2p bias with a normalized low limb CAN underflow —
// it sat below 2^52 — and silently corrupted ~2^-19 of decompressions)
static const u64 BIAS4P[5] = {0x3ffffbfffff0bcULL, 0x3ffffffffffffcULL,
                              0x3ffffffffffffcULL, 0x3ffffffffffffcULL,
                              0x3fffffffffffcULL};

static inline void fe_sub(fe& r, const fe& a, const fe& b) {
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + BIAS4P[i] - b.v[i];
    fe_carry_weak(r);
}

static inline void _fold10(const u128 acc[10], fe& r) {
    // carry into 10 exact 52-bit limbs (a*b < 2^512 < 2^520, so the
    // chain terminates with no residue past limb 9), then fold: limb
    // (5+k) has weight 2^(260+52k) == 16C * 2^(52k).  lo[5+k]*C16 <=
    // 2^52 * 2^41 = 2^93, so t fits u128; the fold carry stays <= 2^41.
    u64 lo[10];
    u128 carry = 0;
    for (int i = 0; i < 10; i++) {
        carry += acc[i];
        lo[i] = (u64)carry & M52;
        carry >>= 52;
    }
    u64 res[6] = {lo[0], lo[1], lo[2], lo[3], lo[4], 0};
    u64 cc = 0;
    for (int k = 0; k < 5; k++) {
        u128 t = (u128)lo[5 + k] * C16 + res[k] + cc;
        res[k] = (u64)t & M52;
        cc = (u64)(t >> 52);
    }
    res[5] = cc;                          // weight 2^260 again, <= 2^41
    u128 t2 = (u128)res[5] * C16 + res[0];
    res[0] = (u64)t2 & M52;
    res[1] += (u64)(t2 >> 52);            // <= 2^30 extra: no overflow
    fe out = {{res[0], res[1], res[2], res[3], res[4]}};
    fe_carry_weak(out);
    r = out;
}

static void fe_mul(fe& r, const fe& a, const fe& b) {
    u128 acc[10] = {0};
    for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++)
            acc[i + j] += (u128)a.v[i] * b.v[j];
    _fold10(acc, r);
}

static inline void fe_sq(fe& r, const fe& a) {
    u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
    u128 acc[10];
    acc[0] = (u128)a0 * a0;
    acc[1] = (u128)(2 * a0) * a1;
    acc[2] = (u128)(2 * a0) * a2 + (u128)a1 * a1;
    acc[3] = (u128)(2 * a0) * a3 + (u128)(2 * a1) * a2;
    acc[4] = (u128)(2 * a0) * a4 + (u128)(2 * a1) * a3 + (u128)a2 * a2;
    acc[5] = (u128)(2 * a1) * a4 + (u128)(2 * a2) * a3;
    acc[6] = (u128)(2 * a2) * a4 + (u128)a3 * a3;
    acc[7] = (u128)(2 * a3) * a4;
    acc[8] = (u128)a4 * a4;
    acc[9] = 0;
    _fold10(acc, r);
}

static void fe_frombytes(fe& r, const u8 s[32]) {
    // big-endian 32 bytes -> 5x52 limbs
    u64 w[4];
    for (int i = 0; i < 4; i++) {
        w[i] = 0;
        for (int j = 0; j < 8; j++)
            w[i] = (w[i] << 8) | s[8 * i + j];   // w[0] = most significant
    }
    u64 w0 = w[3], w1 = w[2], w2 = w[1], w3 = w[0];   // little-endian now
    r.v[0] = w0 & M52;
    r.v[1] = ((w0 >> 52) | (w1 << 12)) & M52;
    r.v[2] = ((w1 >> 40) | (w2 << 24)) & M52;
    r.v[3] = ((w2 >> 28) | (w3 << 36)) & M52;
    r.v[4] = w3 >> 16;
    fe_carry_weak(r);
}

static void fe_tobytes(u8 s[32], const fe& a) {
    fe t = a;
    fe_carry_weak(t);
    fe_carry_weak(t);
    // canonical: add C and check overflow of 2^256 (t >= p iff t + C
    // carries past bit 256, with C = 2^32 + 977)
    u64 c0 = C16 >> 4;
    u64 q = (t.v[0] + c0) >> 52;
    q = (t.v[1] + q) >> 52;
    q = (t.v[2] + q) >> 52;
    q = (t.v[3] + q) >> 52;
    q = (t.v[4] + q) >> 48;              // top limb holds 48 bits
    // if q: t -= p  (equivalently t = t + C, dropping bit 256)
    if (q) {
        u128 tt = (u128)t.v[0] + c0;
        t.v[0] = (u64)tt & M52;
        u64 cc = (u64)(tt >> 52);
        for (int i = 1; i < 5; i++) {
            u64 s2 = t.v[i] + cc;
            cc = s2 >> 52;
            t.v[i] = s2 & M52;
        }
        t.v[4] &= (1ULL << 48) - 1;      // drop 2^256
    }
    u64 w0 = t.v[0] | (t.v[1] << 52);
    u64 w1 = (t.v[1] >> 12) | (t.v[2] << 40);
    u64 w2 = (t.v[2] >> 24) | (t.v[3] << 28);
    u64 w3 = (t.v[3] >> 36) | (t.v[4] << 16);
    u64 w[4] = {w3, w2, w1, w0};         // big-endian order
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            s[8 * i + j] = (u8)(w[i] >> (56 - 8 * j));
}

static bool fe_iszero(const fe& a) {
    u8 b[32];
    fe_tobytes(b, a);
    u8 acc = 0;
    for (int i = 0; i < 32; i++) acc |= b[i];
    return acc == 0;
}

static bool fe_equal(const fe& a, const fe& b) {
    fe d;
    fe_sub(d, a, b);
    return fe_iszero(d);
}

static bool fe_isodd(const fe& a) {
    u8 b[32];
    fe_tobytes(b, a);
    return b[31] & 1;
}

static inline void fe_sqn(fe& r, const fe& a, int n) {
    fe_sq(r, a);
    for (int i = 1; i < n; i++) fe_sq(r, r);
}

// x^(2^223 - 1): the shared prefix of both fixed exponents —
// p - 2      = (2^223 - 1)*2^33 + 0xFFFFFC2D   (33-bit tail)   and
// (p + 1)/4  = (2^223 - 1)*2^31 + 0x3FFFFF0C   (31-bit tail)
// (both identities follow from p = 2^256 - 2^32 - 977: the tails are
// 2^33 - 2^32 - 979 and 2^31 - 2^30 - 244).  The 2^k-1 ladder costs
// ~222 sq + 12 mul vs the generic bit-scan's ~250 mul.
static void fe_chain223(fe& r, const fe& x) {
    fe x2, x4, x8, x16, x32, x64, x128, t;
    fe_sq(t, x);
    fe_mul(x2, t, x);                    // 2^2 - 1
    fe_sqn(t, x2, 2);
    fe_mul(x4, t, x2);                   // 2^4 - 1
    fe_sqn(t, x4, 4);
    fe_mul(x8, t, x4);                   // 2^8 - 1
    fe_sqn(t, x8, 8);
    fe_mul(x16, t, x8);                  // 2^16 - 1
    fe_sqn(t, x16, 16);
    fe_mul(x32, t, x16);                 // 2^32 - 1
    fe_sqn(t, x32, 32);
    fe_mul(x64, t, x32);                 // 2^64 - 1
    fe_sqn(t, x64, 64);
    fe_mul(x128, t, x64);                // 2^128 - 1
    fe_sqn(t, x128, 64);
    fe_mul(t, t, x64);                   // 2^192 - 1
    fe_sqn(t, t, 16);
    fe_mul(t, t, x16);                   // 2^208 - 1
    fe_sqn(t, t, 8);
    fe_mul(t, t, x8);                    // 2^216 - 1
    fe_sqn(t, t, 4);
    fe_mul(t, t, x4);                    // 2^220 - 1
    fe_sqn(t, t, 2);
    fe_mul(t, t, x2);                    // 2^222 - 1
    fe_sq(t, t);
    fe_mul(r, t, x);                     // 2^223 - 1
}

// square-and-multiply over a short tail (the low 33/31 bits of the
// fixed exponents after the shared 2^223-1 prefix)
static void fe_pow_tail(fe& r, const fe& prefix, const fe& x,
                        u64 tail, int bits) {
    // u64 tail: bits can be 33, and (u32 >> 32) is undefined behavior
    // (x86 shifts count mod 32 — exactly the bug this signature avoids)
    fe acc = prefix;
    for (int i = bits - 1; i >= 0; i--) {
        fe_sq(acc, acc);
        if ((tail >> i) & 1) fe_mul(acc, acc, x);
    }
    r = acc;
}

static void fe_invert(fe& r, const fe& a) {
    // a^(p-2) = a^((2^223-1)*2^33 + 0xFFFFFC2D)
    fe pre;
    fe_chain223(pre, a);
    fe_pow_tail(r, pre, a, 0xFFFFFC2Du, 33);
}

static bool fe_sqrt(fe& r, const fe& a) {
    // p == 3 (mod 4): candidate = a^((p+1)/4) =
    // a^((2^223-1)*2^31 + 0x3FFFFF0C); verify square
    fe pre, cand, chk;
    fe_chain223(pre, a);
    fe_pow_tail(cand, pre, a, 0x3FFFFF0Cu, 31);
    fe_sq(chk, cand);
    if (!fe_equal(chk, a)) return false;
    r = cand;
    return true;
}

// -------------------------------------------------------------- scalars mod n

static const u64 SC_N[4] = {0xbfd25e8cd0364141ULL, 0xbaaedce6af48a03bULL,
                            0xfffffffffffffffeULL, 0xffffffffffffffffULL};
static const u64 SC_HALF_N[4] = {0xdfe92f46681b20a0ULL,
                                 0x5d576e7357a4501dULL,
                                 0xffffffffffffffffULL,
                                 0x7fffffffffffffffULL};
static const u64 SC_MU[5] = {0x402da1732fc9bec0ULL, 0x4551231950b75fc4ULL,
                             0x1ULL, 0x0ULL, 0x1ULL};

struct sc { u64 v[4]; };

static inline int sc_geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static inline bool sc_iszero(const sc& a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static void sc_reduce512(sc& r, const u64 x[8]) {
    u64 prod[13] = {0};
    for (int i = 0; i < 8; i++) {
        u64 carry = 0;
        for (int j = 0; j < 5; j++) {
            u128 t = (u128)x[i] * SC_MU[j] + prod[i + j] + carry;
            prod[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        prod[i + 5] += carry;
    }
    u64 q[5];
    for (int i = 0; i < 5; i++) q[i] = prod[8 + i];
    u64 ql[8] = {0};
    for (int i = 0; i < 5; i++) {
        u64 carry = 0;
        for (int j = 0; j < 4 && i + j < 8; j++) {
            u128 t = (u128)q[i] * SC_N[j] + ql[i + j] + carry;
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
    for (int k = 0; k < 3; k++)
        if (rem[4] | rem[5] | rem[6] | rem[7] || sc_geq(rem, SC_N)) {
            u64 borrow2 = 0;
            for (int i = 0; i < 8; i++) {
                u64 bi = (i < 4 ? SC_N[i] : 0) + borrow2;
                borrow2 = (bi < borrow2) ? 1 : (rem[i] < bi ? 1 : 0);
                rem[i] = rem[i] - bi;
            }
        }
    for (int i = 0; i < 4; i++) r.v[i] = rem[i];
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

// load 32 big-endian bytes; true if the value is in [1, n)
static bool sc_from_bytes_checked(sc& r, const u8 b[32]) {
    for (int i = 0; i < 4; i++) {
        r.v[i] = 0;
        for (int j = 0; j < 8; j++)
            r.v[i] = (r.v[i] << 8) | b[(3 - i) * 8 + j];
    }
    return !sc_iszero(r) && !sc_geq(r.v, SC_N);
}

static void sc_from_hash(sc& r, const u8 b[32]) {
    u64 x[8] = {0};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            x[i] = (x[i] << 8) | b[(3 - i) * 8 + j];
    sc_reduce512(r, x);
}

// 256-bit helpers for the inversion (variable-time is fine: ECDSA
// verification handles only public values)
static inline bool u256_iszero(const u64 a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

static inline bool u256_iseven(const u64 a[4]) { return !(a[0] & 1); }

static inline void u256_rshift1(u64 a[4]) {
    a[0] = (a[0] >> 1) | (a[1] << 63);
    a[1] = (a[1] >> 1) | (a[2] << 63);
    a[2] = (a[2] >> 1) | (a[3] << 63);
    a[3] >>= 1;
}

static inline u64 u256_add(u64 r[4], const u64 a[4], const u64 b[4]) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a[i] + b[i];
        r[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

static inline void u256_sub(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u64 bi = b[i] + borrow;
        borrow = (bi < borrow) ? 1 : (a[i] < bi ? 1 : 0);
        r[i] = a[i] - bi;
    }
}

static void sc_invert(sc& r, const sc& a) {
    // binary extended gcd mod n (~15x faster than the Fermat ladder of
    // Barrett multiplications; gcd(a, n) == 1 since n is prime)
    u64 u[4] = {a.v[0], a.v[1], a.v[2], a.v[3]};
    u64 v[4] = {SC_N[0], SC_N[1], SC_N[2], SC_N[3]};
    u64 x1[4] = {1, 0, 0, 0};
    u64 x2[4] = {0, 0, 0, 0};
    while (!u256_iszero(u) && !u256_iszero(v)) {
        while (u256_iseven(u)) {
            u256_rshift1(u);
            if (u256_iseven(x1)) {
                u256_rshift1(x1);
            } else {
                u64 carry = u256_add(x1, x1, SC_N);
                u256_rshift1(x1);
                x1[3] |= carry << 63;
            }
        }
        while (u256_iseven(v)) {
            u256_rshift1(v);
            if (u256_iseven(x2)) {
                u256_rshift1(x2);
            } else {
                u64 carry = u256_add(x2, x2, SC_N);
                u256_rshift1(x2);
                x2[3] |= carry << 63;
            }
        }
        if (sc_geq(u, v)) {
            u256_sub(u, u, v);
            // x1 = (x1 - x2) mod n
            if (sc_geq(x1, x2)) {
                u256_sub(x1, x1, x2);
            } else {
                u64 t[4];
                u256_sub(t, x2, x1);
                u256_sub(x1, SC_N, t);
            }
        } else {
            u256_sub(v, v, u);
            if (sc_geq(x2, x1)) {
                u256_sub(x2, x2, x1);
            } else {
                u64 t[4];
                u256_sub(t, x1, x2);
                u256_sub(x2, SC_N, t);
            }
        }
    }
    const u64* out = u256_iszero(u) ? x2 : x1;
    for (int i = 0; i < 4; i++) r.v[i] = out[i];
}

static inline int sc_window(const sc& a, int pos, int width) {
    int word = pos >> 6, shift = pos & 63;
    u64 w = a.v[word] >> shift;
    if (shift + width > 64 && word + 1 < 4)
        w |= a.v[word + 1] << (64 - shift);
    return (int)(w & ((1ULL << width) - 1));
}

// ------------------------------------------------- GLV endomorphism split
// secp256k1 has the cube-root endomorphism psi(x, y) = (beta*x, y) with
// psi(P) = [lambda]P, so k*P = k1*P + k2*psi(P) with |k1|, |k2| ~ 2^128
// — the joint ladder then needs HALF the doublings.  Every constant is
// VERIFIED at library init (beta^2+beta+1 = 0 mod p, lambda^2+lambda+1
// = 0 mod n, the lattice relations, and psi(G) == lambda*G against the
// plain ladder), and every per-call decomposition is re-verified
// algebraically (k1 + lambda*k2 == k mod n, magnitudes < 2^130); any
// mismatch falls back to the plain 2-table ladder, so a wrong constant
// can only cost speed, never correctness.

static const u8 GLV_BETA_BYTES[32] = {
    0x7a, 0xe9, 0x6a, 0x2b, 0x65, 0x7c, 0x07, 0x10,
    0x6e, 0x64, 0x47, 0x9e, 0xac, 0x34, 0x34, 0xe9,
    0x9c, 0xf0, 0x49, 0x75, 0x12, 0xf5, 0x89, 0x95,
    0xc1, 0x39, 0x6c, 0x28, 0x71, 0x95, 0x01, 0xee};
static const u8 GLV_LAMBDA_BYTES[32] = {
    0x53, 0x63, 0xad, 0x4c, 0xc0, 0x5c, 0x30, 0xe0,
    0xa5, 0x26, 0x1c, 0x02, 0x88, 0x12, 0x64, 0x5a,
    0x12, 0x2e, 0x22, 0xea, 0x20, 0x81, 0x66, 0x78,
    0xdf, 0x02, 0x96, 0x7c, 0x1b, 0x23, 0xbd, 0x72};
// lattice basis (a1 + b1*lambda == 0, a2 + b2*lambda == 0 mod n), with
// b1 stored negated: b1 = -B1N, b2 = a1
static const u64 GLV_A1[2] = {0xe86c90e49284eb15ULL, 0x3086d221a7d46bcdULL};
static const u64 GLV_B1N[2] = {0x6f547fa90abfe4c3ULL, 0xe4437ed6010e8828ULL};
static const u64 GLV_A2[3] = {0x57c1108d9d44cfd8ULL, 0x14ca50f7a8e2f3f6ULL,
                              0x1ULL};

static fe GLV_BETA;
static sc GLV_LAMBDA;
static u64 GLV_G1[4], GLV_G2[4];     // round(2^384 * b2 / n), ... * (-b1)
static bool GLV_OK = false;

// 512-bit / 256-bit long division (init-only; bitwise, trivially right)
static void u512_divmod_n(const u64 num[8], u64 quot[8]) {
    u64 rem[4] = {0, 0, 0, 0};
    for (int i = 0; i < 8; i++) quot[i] = 0;
    for (int bit = 511; bit >= 0; bit--) {
        // rem = rem*2 + bit_i  (rem < n < 2^256 so the shift can't drop)
        u64 carry = 0;
        for (int i = 0; i < 4; i++) {
            u64 nx = (rem[i] << 1) | carry;
            carry = rem[i] >> 63;
            rem[i] = nx;
        }
        rem[0] |= (num[bit >> 6] >> (bit & 63)) & 1;
        if (carry || sc_geq(rem, SC_N)) {
            u64 borrow = 0;
            for (int i = 0; i < 4; i++) {
                u64 bi = SC_N[i] + borrow;
                borrow = (bi < borrow) ? 1 : (rem[i] < bi ? 1 : 0);
                rem[i] = rem[i] - bi;
            }
        } else {
            continue;
        }
        quot[bit >> 6] |= 1ULL << (bit & 63);
    }
}

// (a[na] * b[nb]) into out[na+nb] (schoolbook, u128 carries)
static void limb_mul(const u64* a, int na, const u64* b, int nb, u64* out) {
    for (int i = 0; i < na + nb; i++) out[i] = 0;
    for (int i = 0; i < na; i++) {
        u64 carry = 0;
        for (int j = 0; j < nb; j++) {
            u128 t = (u128)a[i] * b[j] + out[i + j] + carry;
            out[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        out[i + nb] += carry;
    }
}

// c = (k * g + 2^383) >> 384 — the rounded GLV quotient.  c fits 2
// limbs because c ~ m*k/n with m <= max(|b1|, b2) < 2^128 and k < n,
// so c < 2^128 (g itself is ~2^253 for b2 and ~2^255.8 for -b1)
static void glv_round_mul(const sc& k, const u64 g[4], u64 c[2]) {
    u64 prod[8];
    limb_mul(k.v, 4, g, 4, prod);
    // add the rounding bit at position 383
    u128 t = (u128)prod[5] + (1ULL << 63);
    prod[5] = (u64)t;
    u64 carry = (u64)(t >> 64);
    for (int i = 6; i < 8 && carry; i++) {
        t = (u128)prod[i] + carry;
        prod[i] = (u64)t;
        carry = (u64)(t >> 64);
    }
    c[0] = prod[6];
    c[1] = prod[7];
}

// signed small scalar: magnitude (3 limbs, < 2^130) + sign
struct glv_half { u64 mag[3]; bool neg; };

// d (mod n, canonical) -> small signed form; false if |d| >= 2^130
static bool glv_small(const u64 d[4], glv_half& out) {
    if ((d[3] | (d[2] >> 2)) == 0) {            // d < 2^130
        out.mag[0] = d[0]; out.mag[1] = d[1]; out.mag[2] = d[2];
        out.neg = false;
        return true;
    }
    u64 nd[4];
    u256_sub(nd, SC_N, d);                      // n - d
    if ((nd[3] | (nd[2] >> 2)) == 0) {
        out.mag[0] = nd[0]; out.mag[1] = nd[1]; out.mag[2] = nd[2];
        out.neg = true;
        return true;
    }
    return false;
}

static inline int glv_window(const glv_half& h, int pos) {
    // pos is always a multiple of 4 (the ladder steps whole windows),
    // so a 4-bit window can never straddle a 64-bit limb boundary
    return (int)((h.mag[pos >> 6] >> (pos & 63)) & 0xF);
}

// k -> k1 + lambda*k2 (mod n), both halves small; false -> caller uses
// the plain ladder.  Includes the full algebraic re-verification.
static bool glv_decompose(const sc& k, glv_half& k1, glv_half& k2) {
    u64 c1[2], c2[2];
    glv_round_mul(k, GLV_G1, c1);
    glv_round_mul(k, GLV_G2, c2);
    // s = c1*a1 + c2*a2  (< 2^255 < n: no reduction needed)
    u64 s1[4], s2[5], s[5] = {0};
    limb_mul(c1, 2, GLV_A1, 2, s1);
    limb_mul(c2, 2, GLV_A2, 3, s2);
    u64 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)s1[i] + s2[i] + carry;
        s[i] = (u64)t;
        carry = (u64)(t >> 64);
    }
    if (carry + s2[4] != 0) return false;       // defensive: can't happen
    // d1 = (k - s) mod n
    u64 d1[4];
    if (sc_geq(k.v, s)) {
        u256_sub(d1, k.v, s);
    } else {
        u64 t[4];
        u256_sub(t, s, k.v);
        u256_sub(d1, SC_N, t);
    }
    if (!glv_small(d1, k1)) return false;
    // d2 = (c1*b1n - c2*b2) mod n   (k2 = -(c1*b1 + c2*b2) = c1*b1n - c2*b2)
    u64 t1[4], t2[4];
    limb_mul(c1, 2, GLV_B1N, 2, t1);
    limb_mul(c2, 2, GLV_A1, 2, t2);             // b2 == a1
    u64 d2[4];
    if (sc_geq(t1, t2)) {
        u256_sub(d2, t1, t2);
        if (sc_geq(d2, SC_N)) u256_sub(d2, d2, SC_N);
    } else {
        u64 t[4];
        u256_sub(t, t2, t1);
        if (sc_geq(t, SC_N)) u256_sub(t, t, SC_N);
        u256_sub(d2, SC_N, t);
    }
    if (!glv_small(d2, k2)) return false;
    // re-verify: k1 + lambda*k2 == k (mod n)
    sc m2 = {{k2.mag[0], k2.mag[1], k2.mag[2], 0}};
    sc lk2;
    sc_mul(lk2, GLV_LAMBDA, m2);
    u64 acc[4] = {k1.mag[0], k1.mag[1], k1.mag[2], 0};
    if (k1.neg) {
        u64 t[4];
        u256_sub(t, SC_N, acc);
        for (int i = 0; i < 4; i++) acc[i] = t[i];
    }
    u64 l[4] = {lk2.v[0], lk2.v[1], lk2.v[2], lk2.v[3]};
    if (k2.neg) {
        u64 t[4];
        u256_sub(t, SC_N, l);
        for (int i = 0; i < 4; i++) l[i] = t[i];
    }
    u64 sum[4];
    u64 cadd = u256_add(sum, acc, l);
    if (cadd || sc_geq(sum, SC_N)) u256_sub(sum, sum, SC_N);
    return sum[0] == k.v[0] && sum[1] == k.v[1] &&
           sum[2] == k.v[2] && sum[3] == k.v[3];
}

// ---------------------------------------------------- points (Jacobian, a=0)

struct ge { fe X, Y, Z; bool inf; };

static const ge GE_INF = {{{0}}, {{0}}, {{0}}, true};

static void ge_double(ge& r, const ge& p) {
    if (p.inf) { r = p; return; }
    // no y == 0 check: a y = 0 point would have order 2, and
    // secp256k1's group order n is an odd prime (cofactor 1) — no
    // 2-torsion exists, so on-curve inputs can never hit it (and every
    // ladder input is decompression-validated on-curve)
    fe A, B, Cc, D, X3, Y3, Z3, t;
    fe_sq(A, p.X);                       // A = X^2
    fe_sq(B, p.Y);                       // B = Y^2
    fe_sq(Cc, B);                        // C = B^2
    fe_add(t, p.X, B);
    fe_sq(t, t);
    fe_sub(t, t, A);
    fe_sub(t, t, Cc);
    fe_add(D, t, t);                     // D = 2((X+B)^2 - A - C)
    fe M;
    fe_add(M, A, A);
    fe_add(M, M, A);                     // M = 3A (a = 0)
    fe_sq(X3, M);
    fe_sub(X3, X3, D);
    fe_sub(X3, X3, D);                   // X3 = M^2 - 2D
    fe c8;
    fe_add(c8, Cc, Cc);
    fe_add(c8, c8, c8);
    fe_add(c8, c8, c8);                  // 8C
    fe_sub(Y3, D, X3);
    fe_mul(Y3, M, Y3);
    fe_sub(Y3, Y3, c8);                  // Y3 = M(D - X3) - 8C
    fe_mul(Z3, p.Y, p.Z);
    fe_add(Z3, Z3, Z3);                  // Z3 = 2YZ
    r.X = X3; r.Y = Y3; r.Z = Z3; r.inf = false;
}

static void ge_add(ge& r, const ge& p, const ge& q) {
    if (p.inf) { r = q; return; }
    if (q.inf) { r = p; return; }
    fe Z1Z1, Z2Z2, U1, U2, S1, S2, H, Rr, t;
    fe_sq(Z1Z1, p.Z);
    fe_sq(Z2Z2, q.Z);
    fe_mul(U1, p.X, Z2Z2);
    fe_mul(U2, q.X, Z1Z1);
    fe_mul(S1, p.Y, q.Z);
    fe_mul(S1, S1, Z2Z2);
    fe_mul(S2, q.Y, p.Z);
    fe_mul(S2, S2, Z1Z1);
    fe_sub(H, U2, U1);
    fe_sub(Rr, S2, S1);
    if (fe_iszero(H)) {
        if (fe_iszero(Rr)) { ge_double(r, p); return; }
        r = GE_INF;                      // P + (-P)
        return;
    }
    fe HH, HHH, V, X3, Y3, Z3;
    fe_sq(HH, H);
    fe_mul(HHH, HH, H);
    fe_mul(V, U1, HH);
    fe_sq(X3, Rr);
    fe_sub(X3, X3, HHH);
    fe_sub(X3, X3, V);
    fe_sub(X3, X3, V);                   // X3 = R^2 - HHH - 2V
    fe_sub(t, V, X3);
    fe_mul(Y3, Rr, t);
    fe_mul(t, S1, HHH);
    fe_sub(Y3, Y3, t);                   // Y3 = R(V - X3) - S1*HHH
    fe_mul(Z3, p.Z, q.Z);
    fe_mul(Z3, Z3, H);                   // Z3 = Z1 Z2 H
    r.X = X3; r.Y = Y3; r.Z = Z3; r.inf = false;
}

static bool ge_decompress(ge& r, const u8 pub[33]) {
    if (pub[0] != 0x02 && pub[0] != 0x03) return false;
    fe x, y2, y;
    // reject non-canonical x (>= p): round-trip the bytes
    fe_frombytes(x, pub + 1);
    u8 chk[32];
    fe_tobytes(chk, x);
    if (memcmp(chk, pub + 1, 32) != 0) return false;
    fe_sq(y2, x);
    fe_mul(y2, y2, x);
    fe_add(y2, y2, FE_SEVEN);            // y^2 = x^3 + 7
    if (!fe_sqrt(y, y2)) return false;
    if (fe_isodd(y) != (pub[0] == 0x03)) {
        fe zero = {{0, 0, 0, 0, 0}};
        fe_sub(y, zero, y);
    }
    r.X = x; r.Y = y;
    r.Z.v[0] = 1; r.Z.v[1] = r.Z.v[2] = r.Z.v[3] = r.Z.v[4] = 0;
    r.inf = false;
    return true;
}

// mixed addition r = p + q with AFFINE q (madd-2007-bl shape): 8 fe_mul
// + 3 fe_sq vs general ge_add's 12 + 4 — the ladder's table entries are
// pre-normalized to affine exactly so every window add is mixed
struct geaff { fe x, y; bool inf; };

static void ge_madd(ge& r, const ge& p, const geaff& q) {
    if (q.inf) { r = p; return; }
    if (p.inf) {
        r.X = q.x; r.Y = q.y;
        r.Z = {{1, 0, 0, 0, 0}};
        r.inf = false;
        return;
    }
    fe Z1Z1, U2, S2, H, Rr, t;
    fe_sq(Z1Z1, p.Z);
    fe_mul(U2, q.x, Z1Z1);
    fe_mul(S2, q.y, p.Z);
    fe_mul(S2, S2, Z1Z1);
    fe_sub(H, U2, p.X);
    fe_sub(Rr, S2, p.Y);
    if (fe_iszero(H)) {
        if (fe_iszero(Rr)) { ge_double(r, p); return; }
        r = GE_INF;
        return;
    }
    fe HH, HHH, V, X3, Y3, Z3;
    fe_sq(HH, H);
    fe_mul(HHH, HH, H);
    fe_mul(V, p.X, HH);
    fe_sq(X3, Rr);
    fe_sub(X3, X3, HHH);
    fe_sub(X3, X3, V);
    fe_sub(X3, X3, V);
    fe_sub(t, V, X3);
    fe_mul(Y3, Rr, t);
    fe_mul(t, p.Y, HHH);
    fe_sub(Y3, Y3, t);
    fe_mul(Z3, p.Z, H);
    r.X = X3; r.Y = Y3; r.Z = Z3; r.inf = false;
}

// batch-normalize Jacobian points to affine: ONE field inversion for the
// whole table (Montgomery trick), then x = X/Z^2, y = Y/Z^3 per entry
static void ge_batch_to_affine(geaff* out, const ge* in, int n) {
    // n <= 16 at every call site (window tables); stack storage keeps
    // the per-verification hot path allocation-free
    fe partial[16];
    fe acc = {{1, 0, 0, 0, 0}};
    for (int i = 0; i < n; i++) {
        partial[i] = acc;
        if (!in[i].inf) fe_mul(acc, acc, in[i].Z);
    }
    fe inv;
    fe_invert(inv, acc);
    for (int i = n - 1; i >= 0; i--) {
        out[i].inf = in[i].inf;
        if (in[i].inf) continue;
        fe zi, zi2;
        fe_mul(zi, inv, partial[i]);         // 1 / Z_i
        fe_mul(inv, inv, in[i].Z);           // drop Z_i from the running inv
        fe_sq(zi2, zi);
        fe_mul(out[i].x, in[i].X, zi2);
        fe_mul(out[i].y, in[i].Y, zi2);
        fe_mul(out[i].y, out[i].y, zi);
    }
}

// ------------------------------------------------------------- verification

// 4-bit base-point window in AFFINE form, built once at library load
// (dlopen runs initializers single-threaded, so no init race across
// ctypes calls); affine entries make every ladder add a mixed add.
// PSI_G_TAB is the endomorphism image (beta*x, y) of each entry —
// psi(i*G) = i*psi(G), so it needs only one field mul per entry.
static geaff G_TAB[16];
static geaff PSI_G_TAB[16];

static void ge_scalarmul_plain(ge& r, const sc& k, const ge& p) {
    // simple 4-bit ladder (init-time psi(G) check only)
    ge tab[16];
    tab[0] = GE_INF;
    tab[1] = p;
    for (int i = 2; i < 16; i++) ge_add(tab[i], tab[i - 1], p);
    ge acc = GE_INF;
    for (int w = 63; w >= 0; w--) {
        for (int i = 0; i < 4; i++) ge_double(acc, acc);
        int d = sc_window(k, 4 * w, 4);
        if (d) ge_add(acc, acc, tab[d]);
    }
    r = acc;
}

static void psi_table(geaff* out, const geaff* in) {
    for (int i = 0; i < 16; i++) {
        out[i].inf = in[i].inf;
        if (in[i].inf) continue;
        fe_mul(out[i].x, GLV_BETA, in[i].x);
        out[i].y = in[i].y;
    }
}

static bool glv_init() {
    fe_frombytes(GLV_BETA, GLV_BETA_BYTES);
    for (int i = 0; i < 4; i++) {
        GLV_LAMBDA.v[i] = 0;
        for (int j = 0; j < 8; j++)
            GLV_LAMBDA.v[i] = (GLV_LAMBDA.v[i] << 8)
                | GLV_LAMBDA_BYTES[(3 - i) * 8 + j];
    }
    // beta^2 + beta + 1 == 0 (mod p)
    fe t, one = {{1, 0, 0, 0, 0}};
    fe_sq(t, GLV_BETA);
    fe_add(t, t, GLV_BETA);
    fe_add(t, t, one);
    if (!fe_iszero(t)) return false;
    // lambda^2 + lambda + 1 == 0 (mod n)
    sc lt;
    sc_mul(lt, GLV_LAMBDA, GLV_LAMBDA);
    u64 acc[4];
    u64 c = u256_add(acc, lt.v, GLV_LAMBDA.v);
    if (c || sc_geq(acc, SC_N)) u256_sub(acc, acc, SC_N);
    u64 onev[4] = {1, 0, 0, 0};
    c = u256_add(acc, acc, onev);
    if (c || sc_geq(acc, SC_N)) u256_sub(acc, acc, SC_N);
    if ((acc[0] | acc[1] | acc[2] | acc[3]) != 0) return false;
    // lattice relations: a1 == b1n * lambda, a2 == n - (a1 * lambda)
    // (a1 + b1*lambda == 0 with b1 = -b1n;  a2 + b2*lambda == 0, b2 = a1)
    sc b1n = {{GLV_B1N[0], GLV_B1N[1], 0, 0}};
    sc a1 = {{GLV_A1[0], GLV_A1[1], 0, 0}};
    sc chk;
    sc_mul(chk, b1n, GLV_LAMBDA);
    if (chk.v[0] != GLV_A1[0] || chk.v[1] != GLV_A1[1] ||
        chk.v[2] | chk.v[3]) return false;
    sc_mul(chk, a1, GLV_LAMBDA);
    u64 na2[4];
    u256_sub(na2, SC_N, chk.v);                  // -a1*lambda mod n
    if (na2[0] != GLV_A2[0] || na2[1] != GLV_A2[1] ||
        na2[2] != GLV_A2[2] || na2[3]) return false;
    // rounded quotients: G1 = round(2^384*b2/n) with b2 == a1, and
    // G2 = round(2^384*b1n/n) — computed as ((m << 384) + n/2) / n
    for (int which = 0; which < 2; which++) {
        const u64* m = which == 0 ? GLV_A1 : GLV_B1N;
        u64 nm[8] = {0};
        nm[6] = m[0];
        nm[7] = m[1];
        // += floor(n/2): 4-limb value (n odd -> n>>1)
        u64 half[4] = {(SC_N[0] >> 1) | (SC_N[1] << 63),
                       (SC_N[1] >> 1) | (SC_N[2] << 63),
                       (SC_N[2] >> 1) | (SC_N[3] << 63),
                       SC_N[3] >> 1};
        u64 carry = 0;
        for (int i = 0; i < 8; i++) {
            u128 tt = (u128)nm[i] + (i < 4 ? half[i] : 0) + carry;
            nm[i] = (u64)tt;
            carry = (u64)(tt >> 64);
        }
        u64 q[8];
        u512_divmod_n(nm, q);
        if (q[4] | q[5] | q[6] | q[7]) return false;     // g must fit 4 limbs
        for (int i = 0; i < 4; i++)
            (which == 0 ? GLV_G1 : GLV_G2)[i] = q[i];
    }
    // psi(G) == lambda * G — the one check the per-call verification
    // cannot cover (it would pass equally for lambda^2)
    ge lg;
    ge jg;
    jg.X = GX; jg.Y = GY; jg.Z = {{1, 0, 0, 0, 0}}; jg.inf = false;
    ge_scalarmul_plain(lg, GLV_LAMBDA, jg);
    fe zi, zi2, lx;
    fe_invert(zi, lg.Z);
    fe_sq(zi2, zi);
    fe_mul(lx, lg.X, zi2);
    fe px;
    fe_mul(px, GLV_BETA, GX);
    if (!fe_equal(lx, px)) return false;
    return true;
}

static const bool _gtab_ready = []() {
    ge jac[16];
    jac[0] = GE_INF;
    jac[1].X = GX;
    jac[1].Y = GY;
    jac[1].Z = {{1, 0, 0, 0, 0}};
    jac[1].inf = false;
    for (int i = 2; i < 16; i++) ge_add(jac[i], jac[i - 1], jac[1]);
    ge_batch_to_affine(G_TAB, jac, 16);
    GLV_OK = glv_init();
    if (GLV_OK) psi_table(PSI_G_TAB, G_TAB);
    return true;
}();

// ---------------------------------------------------------------- signing

// HMAC-SHA256 (RFC 2104) with a 32-byte key
static void hmac_sha256(const u8 key[32], const u8* msg, size_t len,
                        u8 out[32]) {
    u8 pad[64], inner[32];
    sha256i::ctx c;
    memset(pad, 0x36, 64);
    for (int i = 0; i < 32; i++) pad[i] ^= key[i];
    sha256i::init(c);
    sha256i::update(c, pad, 64);
    sha256i::update(c, msg, len);
    sha256i::final(c, inner);
    memset(pad, 0x5c, 64);
    for (int i = 0; i < 32; i++) pad[i] ^= key[i];
    sha256i::init(c);
    sha256i::update(c, pad, 64);
    sha256i::update(c, inner, 32);
    sha256i::final(c, out);
}

static void sc_to_bytes(u8 b[32], const sc& a) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            b[8 * i + j] = (u8)(a.v[3 - i] >> (56 - 8 * j));
}

// r = a + b mod n (a, b < n)
static void sc_add(sc& r, const sc& a, const sc& b) {
    u64 c = u256_add(r.v, a.v, b.v);
    if (c || sc_geq(r.v, SC_N)) u256_sub(r.v, r.v, SC_N);
}

// RFC 6979 section 3.2 nonce for SHA-256 and the curve order n (qlen =
// hlen = 256): bits2octets(h1) = h1 mod n
static void rfc6979_k(sc& k, const u8 x[32], const u8 h1[32]) {
    sc z;
    sc_from_hash(z, h1);
    u8 bo[32];
    sc_to_bytes(bo, z);
    u8 v[32], kk[32], buf[32 + 1 + 32 + 32];
    memset(v, 0x01, 32);
    memset(kk, 0x00, 32);
    for (u8 sep = 0; sep < 2; sep++) {
        memcpy(buf, v, 32);
        buf[32] = sep;
        memcpy(buf + 33, x, 32);
        memcpy(buf + 65, bo, 32);
        hmac_sha256(kk, buf, sizeof buf, kk);
        hmac_sha256(kk, v, 32, v);
    }
    for (;;) {
        hmac_sha256(kk, v, 32, v);
        if (sc_from_bytes_checked(k, v)) return;
        memcpy(buf, v, 32);
        buf[32] = 0x00;
        hmac_sha256(kk, buf, 33, kk);
        hmac_sha256(kk, v, 32, v);
    }
}

// affine (x, y) of k*G (k in [1, n)): the 4-bit window ladder over the
// affine base table
static void ge_mul_base_affine(fe& x, fe& y, const sc& k) {
    ge acc = GE_INF;
    for (int w = 63; w >= 0; w--) {
        for (int i = 0; i < 4; i++) ge_double(acc, acc);
        int d = sc_window(k, 4 * w, 4);
        if (d) ge_madd(acc, acc, G_TAB[d]);
    }
    fe zi, zi2;
    fe_invert(zi, acc.Z);
    fe_sq(zi2, zi);
    fe_mul(x, acc.X, zi2);
    fe_mul(y, acc.Y, zi2);
    fe_mul(y, y, zi);
}

// ------------------------------------------------------------- RIPEMD-160

static inline uint32_t rol32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

static void rmd160_compress(uint32_t h[5], const u8 blk[64]) {
    static const int RL[80] = {
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
        3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
        1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
        4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
    static const int RR[80] = {
        5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
        6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
        15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
        8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
        12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
    static const int SL[80] = {
        11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
        7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
        11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
        11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
        9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
    static const int SR[80] = {
        8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
        9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
        9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
        15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
        8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
    static const uint32_t KL[5] = {0x00000000u, 0x5a827999u, 0x6ed9eba1u,
                                   0x8f1bbcdcu, 0xa953fd4eu};
    static const uint32_t KR[5] = {0x50a28be6u, 0x5c4dd124u, 0x6d703ef3u,
                                   0x7a6d76e9u, 0x00000000u};
    uint32_t X[16];
    for (int i = 0; i < 16; i++)
        X[i] = (uint32_t)blk[4 * i] | ((uint32_t)blk[4 * i + 1] << 8)
            | ((uint32_t)blk[4 * i + 2] << 16)
            | ((uint32_t)blk[4 * i + 3] << 24);
    auto f = [](int j, uint32_t x, uint32_t y, uint32_t z) -> uint32_t {
        switch (j >> 4) {
            case 0: return x ^ y ^ z;
            case 1: return (x & y) | (~x & z);
            case 2: return (x | ~y) ^ z;
            case 3: return (x & z) | (y & ~z);
            default: return x ^ (y | ~z);
        }
    };
    uint32_t al = h[0], bl = h[1], cl = h[2], dl = h[3], el = h[4];
    uint32_t ar = al, br = bl, cr = cl, dr = dl, er = el;
    for (int j = 0; j < 80; j++) {
        uint32_t t = rol32(al + f(j, bl, cl, dl) + X[RL[j]] + KL[j >> 4],
                           SL[j]) + el;
        al = el; el = dl; dl = rol32(cl, 10); cl = bl; bl = t;
        t = rol32(ar + f(79 - j, br, cr, dr) + X[RR[j]] + KR[j >> 4],
                  SR[j]) + er;
        ar = er; er = dr; dr = rol32(cr, 10); cr = br; br = t;
    }
    uint32_t t = h[1] + cl + dr;
    h[1] = h[2] + dl + er;
    h[2] = h[3] + el + ar;
    h[3] = h[4] + al + br;
    h[4] = h[0] + bl + cr;
    h[0] = t;
}

extern "C" {

// 1 = valid, 0 = invalid.  pub: 33-byte compressed SEC1; sig: r||s
// big-endian, low-s enforced; e = SHA-256(msg) mod n.
int secp256k1_verify(const u8* pub, const u8* sig, const u8* msg,
                     u64 msg_len) {
    sc r_s, s_s;
    if (!sc_from_bytes_checked(r_s, sig)) return 0;
    if (!sc_from_bytes_checked(s_s, sig + 32)) return 0;
    if (sc_geq(s_s.v, SC_HALF_N) && !(s_s.v[0] == SC_HALF_N[0]
        && s_s.v[1] == SC_HALF_N[1] && s_s.v[2] == SC_HALF_N[2]
        && s_s.v[3] == SC_HALF_N[3])) {
        // s > n/2: reject malleable signatures (matches the Python
        // seam's low-s rule; s == n/2 itself is allowed)
        return 0;
    }
    ge Q;
    if (!ge_decompress(Q, pub)) return 0;

    u8 h[32];
    sha256(msg, msg_len, h);
    sc e, w, u1, u2;
    sc_from_hash(e, h);
    sc_invert(w, s_s);
    sc_mul(u1, e, w);
    sc_mul(u2, r_s, w);

    // Shamir joint ladder over affine tables (every window add is a
    // mixed add, 8M+3S vs the general 12M+4S).  With a VERIFIED GLV
    // split the four ~130-bit halves share 33 window positions (132
    // doublings); otherwise the plain 2-table 64-window ladder runs.
    ge qtj[16];
    qtj[0] = GE_INF;
    qtj[1] = Q;
    for (int i = 2; i < 16; i++) ge_add(qtj[i], qtj[i - 1], Q);
    geaff qt[16];
    ge_batch_to_affine(qt, qtj, 16);

    ge acc = GE_INF;
    glv_half h1a, h1b, h2a, h2b;
    if (GLV_OK && glv_decompose(u1, h1a, h1b)
        && glv_decompose(u2, h2a, h2b)) {
        geaff psi_qt[16];
        psi_table(psi_qt, qt);
        const geaff* tabs[4] = {G_TAB, PSI_G_TAB, qt, psi_qt};
        const glv_half* halves[4] = {&h1a, &h1b, &h2a, &h2b};
        for (int wdx = 32; wdx >= 0; wdx--) {
            for (int k = 0; k < 4; k++) ge_double(acc, acc);
            for (int t = 0; t < 4; t++) {
                int d = glv_window(*halves[t], 4 * wdx);
                if (!d) continue;
                geaff e = tabs[t][d];
                if (halves[t]->neg) {
                    fe zero = {{0, 0, 0, 0, 0}};
                    fe_sub(e.y, zero, e.y);
                }
                ge_madd(acc, acc, e);
            }
        }
    } else {
        for (int wdx = 63; wdx >= 0; wdx--) {
            for (int k = 0; k < 4; k++) ge_double(acc, acc);
            int d1 = sc_window(u1, 4 * wdx, 4);
            if (d1) ge_madd(acc, acc, G_TAB[d1]);
            int d2 = sc_window(u2, 4 * wdx, 4);
            if (d2) ge_madd(acc, acc, qt[d2]);
        }
    }
    if (acc.inf) return 0;

    // R.x mod n == r, checked PROJECTIVELY (no field inversion):
    // x = X/Z^2 == r (mod n) iff X == c*Z^2 (mod p) for c in {r, r+n}
    // — x < p and r < n, so x ≡ r (mod n) only via x == r or x == r+n,
    // the latter possible only when r < p - n (~2^128.3)
    fe z2, cand, rx;
    fe_sq(z2, acc.Z);
    fe_frombytes(rx, sig);                  // r as a field element (r < n < p)
    fe_mul(cand, rx, z2);
    if (fe_equal(cand, acc.X)) return 1;
    // second candidate r + n (as a 256-bit integer; fits iff no carry)
    u64 rn[4];
    if (u256_add(rn, r_s.v, SC_N) == 0) {
        // only meaningful when r + n < p; if r + n >= p the candidate
        // wraps and cannot equal x (x < p) -- fe_frombytes would reduce
        // mod p and produce a WRONG acceptance, so check the bound:
        // p - n fits in 129 bits, so r + n < p iff rn < p, tested via
        // canonical bytes round-trip
        u8 rb[32];
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 8; j++)
                rb[8 * i + j] = (u8)(rn[3 - i] >> (56 - 8 * j));
        fe rnf;
        fe_frombytes(rnf, rb);
        u8 chkb[32];
        fe_tobytes(chkb, rnf);
        if (memcmp(chkb, rb, 32) == 0) {    // rn < p: candidate valid
            fe_mul(cand, rnf, z2);
            if (fe_equal(cand, acc.X)) return 1;
        }
    }
    return 0;
}

// out[i] = secp256k1_verify of lane i (pubs n x 33, sigs n x 64, lane i's
// message msgs[offs[i] .. offs[i + 1])); returns the lanes that verify
u64 secp256k1_verify_batch(const u8* pubs, const u8* sigs, const u8* msgs,
                           const u64* offs, u64 n, u8* out) {
    u64 ok = 0;
    for (u64 i = 0; i < n; i++) {
        out[i] = (u8)secp256k1_verify(pubs + 33 * i, sigs + 64 * i,
                                      msgs + offs[i], offs[i + 1] - offs[i]);
        ok += out[i];
    }
    return ok;
}

// the compressed SEC1 public key of d (32 bytes big-endian)
int secp256k1_pubkey(const u8* d32, u8* out33) {
    sc d;
    if (!sc_from_bytes_checked(d, d32)) return 0;
    fe x, y;
    ge_mul_base_affine(x, y, d);
    out33[0] = fe_isodd(y) ? 3 : 2;
    fe_tobytes(out33 + 1, x);
    return 1;
}

// r||s over SHA-256(msg): the RFC 6979 nonce, S normalised to the low
// half (the JAX package's _secp256k1_py.sign, byte for byte)
int secp256k1_sign(const u8* d32, const u8* msg, u64 msg_len, u8* out64) {
    sc d;
    if (!sc_from_bytes_checked(d, d32)) return 0;
    u8 h1[32];
    sha256(msg, msg_len, h1);
    sc z, k, r, s;
    sc_from_hash(z, h1);
    rfc6979_k(k, d32, h1);
    for (;;) {
        fe x, y;
        ge_mul_base_affine(x, y, k);
        u8 xb[32];
        fe_tobytes(xb, x);
        sc_from_hash(r, xb);                   // x mod n
        if (!sc_iszero(r)) {
            sc kinv, rd, t;
            sc_invert(kinv, k);
            sc_mul(rd, r, d);
            sc_add(t, z, rd);
            sc_mul(s, kinv, t);
            if (!sc_iszero(s)) break;
        }
        // unreachable in practice; the JAX signer's retry: k + 1 (mod n,
        // 0 -> 1)
        sc one = {{1, 0, 0, 0}};
        sc_add(k, k, one);
        if (sc_iszero(k)) k = one;
    }
    if (sc_geq(s.v, SC_HALF_N) && memcmp(s.v, SC_HALF_N, sizeof s.v) != 0)
        u256_sub(s.v, SC_N, s.v);              // low S
    sc_to_bytes(out64, r);
    sc_to_bytes(out64 + 32, s);
    return 1;
}

void ripemd160(const u8* msg, u64 len, u8* out20) {
    uint32_t h[5] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u,
                     0xc3d2e1f0u};
    u64 full = len / 64;
    for (u64 b = 0; b < full; b++) rmd160_compress(h, msg + 64 * b);
    u8 tail[128] = {0};
    u64 rem = len - 64 * full;
    memcpy(tail, msg + 64 * full, rem);
    tail[rem] = 0x80;
    u64 tl = rem + 9 <= 64 ? 64 : 128;
    u64 bits = len * 8;
    for (int i = 0; i < 8; i++) tail[tl - 8 + i] = (u8)(bits >> (8 * i));
    for (u64 o = 0; o < tl; o += 64) rmd160_compress(h, tail + o);
    for (int i = 0; i < 5; i++)
        for (int j = 0; j < 4; j++) out20[4 * i + j] = (u8)(h[i] >> (8 * j));
}

}  // extern "C"
