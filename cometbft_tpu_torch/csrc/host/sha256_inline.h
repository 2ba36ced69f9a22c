// SHA-256 (FIPS 180-4) for the host libraries bls12381.cpp
// (expand_message_xmd), secp256k1.cpp (digests, RFC 6979 nonces) and
// kvstore.cpp (merkle trees), a copy of the JAX package's shared header.
// All functions are internal-linkage.
//
// The build stamp in cometbft_tpu_torch/native.py folds the *.h sources
// into the digest, so editing this header rebuilds the library.

#ifndef COMETBFT_TPU_SHA256_INLINE_H
#define COMETBFT_TPU_SHA256_INLINE_H

#include <cstdint>
#include <cstring>

#if defined(__SHA__) && defined(__SSE4_1__) && defined(__x86_64__)
#include <immintrin.h>
#define COMETBFT_TPU_SHA256_SHANI 1
#endif

namespace sha256i {

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

#ifdef COMETBFT_TPU_SHA256_SHANI
// SHA-NI compress (Intel SHA extensions): ~6x the portable loop per
// block.  Compiled only when -march=native reports the extension (the
// native.py build retries without -march=native, which drops back to
// the portable path below).  Layout per the ISA: state rides as the
// (ABEF, CDGH) pair, message words load big-endian via PSHUFB.
static inline void compress_shani(uint32_t h[8], const uint8_t blk[64]) {
#ifdef __AVX__
    // The SHA instructions have legacy SSE encodings only: run them with
    // the upper halves of the vector registers clean.  Without this, an
    // inlined context copy through YMM/ZMM registers just before (the
    // level loop of kvstore.cpp:kv_merkle_levels) leaves them dirty and
    // every SSE instruction below pays a transition penalty (on the
    // H100's host: 55 ms for a 2,047-leaf tree against 0.7 ms).
    _mm256_zeroupper();
#endif
    const __m128i MASK = _mm_set_epi64x(0x0c0d0e0f08090a0bULL,
                                        0x0405060700010203ULL);
    __m128i TMP = _mm_loadu_si128((const __m128i *)&h[0]);
    __m128i STATE1 = _mm_loadu_si128((const __m128i *)&h[4]);
    TMP = _mm_shuffle_epi32(TMP, 0xB1);            // CDAB
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);      // EFGH
    __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);     // ABEF
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);   // CDGH
    const __m128i ABEF_SAVE = STATE0, CDGH_SAVE = STATE1;
    __m128i MSG, MSG0, MSG1, MSG2, MSG3;

#define SHA_RND(Ki_hi, Ki_lo, Wi)                                      \
    MSG = _mm_add_epi32(Wi, _mm_set_epi64x(Ki_hi, Ki_lo));             \
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);               \
    MSG = _mm_shuffle_epi32(MSG, 0x0E);                                \
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG)
#define SHA_EXT(Wa, Wb, Wc, Wd)                                        \
    TMP = _mm_alignr_epi8(Wd, Wc, 4);                                  \
    Wa = _mm_add_epi32(Wa, TMP);                                       \
    Wa = _mm_sha256msg2_epu32(Wa, Wd);                                 \
    Wb = _mm_sha256msg1_epu32(Wb, Wd)

    MSG0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(blk + 0)),
                            MASK);
    SHA_RND(0xE9B5DBA5B5C0FBCFULL, 0x71374491428A2F98ULL, MSG0);
    MSG1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(blk + 16)),
                            MASK);
    SHA_RND(0xAB1C5ED5923F82A4ULL, 0x59F111F13956C25BULL, MSG1);
    MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);
    MSG2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(blk + 32)),
                            MASK);
    SHA_RND(0x550C7DC3243185BEULL, 0x12835B01D807AA98ULL, MSG2);
    MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);
    MSG3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(blk + 48)),
                            MASK);
    SHA_RND(0xC19BF1749BDC06A7ULL, 0x80DEB1FE72BE5D74ULL, MSG3);
    SHA_EXT(MSG0, MSG2, MSG2, MSG3);   // extend W16..19, prep next msg1
    SHA_RND(0x240CA1CC0FC19DC6ULL, 0xEFBE4786E49B69C1ULL, MSG0);
    SHA_EXT(MSG1, MSG3, MSG3, MSG0);
    SHA_RND(0x76F988DA5CB0A9DCULL, 0x4A7484AA2DE92C6FULL, MSG1);
    SHA_EXT(MSG2, MSG0, MSG0, MSG1);
    SHA_RND(0xBF597FC7B00327C8ULL, 0xA831C66D983E5152ULL, MSG2);
    SHA_EXT(MSG3, MSG1, MSG1, MSG2);
    SHA_RND(0x1429296706CA6351ULL, 0xD5A79147C6E00BF3ULL, MSG3);
    SHA_EXT(MSG0, MSG2, MSG2, MSG3);
    SHA_RND(0x53380D134D2C6DFCULL, 0x2E1B213827B70A85ULL, MSG0);
    SHA_EXT(MSG1, MSG3, MSG3, MSG0);
    SHA_RND(0x92722C8581C2C92EULL, 0x766A0ABB650A7354ULL, MSG1);
    SHA_EXT(MSG2, MSG0, MSG0, MSG1);
    SHA_RND(0xC76C51A3C24B8B70ULL, 0xA81A664BA2BFE8A1ULL, MSG2);
    SHA_EXT(MSG3, MSG1, MSG1, MSG2);
    SHA_RND(0x106AA070F40E3585ULL, 0xD6990624D192E819ULL, MSG3);
    SHA_EXT(MSG0, MSG2, MSG2, MSG3);
    SHA_RND(0x34B0BCB52748774CULL, 0x1E376C0819A4C116ULL, MSG0);
    SHA_EXT(MSG1, MSG3, MSG3, MSG0);
    SHA_RND(0x682E6FF35B9CCA4FULL, 0x4ED8AA4A391C0CB3ULL, MSG1);
    // W52..55: msg2 extension only (no further msg1 needed)
    TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
    MSG2 = _mm_add_epi32(MSG2, TMP);
    MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
    SHA_RND(0x8CC7020884C87814ULL, 0x78A5636F748F82EEULL, MSG2);
    TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
    MSG3 = _mm_add_epi32(MSG3, TMP);
    MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
    SHA_RND(0xC67178F2BEF9A3F7ULL, 0xA4506CEB90BEFFFAULL, MSG3);
#undef SHA_RND
#undef SHA_EXT

    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
    TMP = _mm_shuffle_epi32(STATE0, 0x1B);         // FEBA
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);      // DCHG
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);   // DCBA
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);      // HGFE
    _mm_storeu_si128((__m128i *)&h[0], STATE0);
    _mm_storeu_si128((__m128i *)&h[4], STATE1);
}
#endif  // COMETBFT_TPU_SHA256_SHANI

static inline void compress_portable(uint32_t h[8], const uint8_t blk[64]) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = (uint32_t)blk[4 * i] << 24 | (uint32_t)blk[4 * i + 1] << 16 |
               (uint32_t)blk[4 * i + 2] << 8 | blk[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                      (w[i - 15] >> 3);
        uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                      (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + S1 + ch + K[i] + w[i];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + S0 + mj;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static inline void compress(uint32_t h[8], const uint8_t blk[64]) {
#ifdef COMETBFT_TPU_SHA256_SHANI
    compress_shani(h, blk);
#else
    compress_portable(h, blk);
#endif
}

struct ctx {
    uint32_t h[8];
    uint8_t buf[64];
    uint64_t len;
};

static inline void init(ctx &c) {
    static const uint32_t iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    memcpy(c.h, iv, sizeof iv);
    c.len = 0;
}

static inline void update(ctx &c, const uint8_t *d, size_t n) {
    size_t fill = c.len % 64;
    c.len += n;
    if (fill) {
        size_t take = 64 - fill < n ? 64 - fill : n;
        memcpy(c.buf + fill, d, take);
        d += take; n -= take;
        if (fill + take == 64) compress(c.h, c.buf);
        else return;
    }
    while (n >= 64) { compress(c.h, d); d += 64; n -= 64; }
    if (n) memcpy(c.buf, d, n);
}

static inline void final(ctx &c, uint8_t out[32]) {
    uint64_t bits = c.len * 8;
    uint8_t pad[72] = {0x80};
    size_t padlen = (c.len % 64 < 56) ? 56 - c.len % 64 : 120 - c.len % 64;
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
    update(c, pad, padlen);
    update(c, lenb, 8);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 4; j++)
            out[4 * i + j] = (uint8_t)(c.h[i] >> (24 - 8 * j));
}

// one-shot over up to three concatenated segments (nullptr allowed)
static inline void oneshot3(const uint8_t *d1, size_t n1, const uint8_t *d2,
                            size_t n2, const uint8_t *d3, size_t n3,
                            uint8_t out[32]) {
    ctx c;
    init(c);
    if (n1) update(c, d1, n1);
    if (n2) update(c, d2, n2);
    if (n3) update(c, d3, n3);
    final(c, out);
}

static inline void oneshot(const uint8_t *d, size_t n, uint8_t out[32]) {
    oneshot3(d, n, nullptr, 0, nullptr, 0, out);
}

}  // namespace sha256i

#endif  // COMETBFT_TPU_SHA256_INLINE_H
