// ChaCha20-Poly1305 AEAD (RFC 8439) on the host: the cipher of the p2p
// secret connection's frames.  A copy of the JAX package's
// native/aead.cpp.  Every frame of every peer connection is sealed and
// opened here; the pure-Python cipher in crypto/_sc_fallback.py is only
// the plain version the tests hold this library against.
//
// Exported C ABI (ctypes, see native.py):
//   aead_seal(key32, nonce12, aad, aad_len, pt, pt_len, out)   out: ct || tag16
//   aead_open(key32, nonce12, aad, aad_len, ct_tag, len, out)  1: tag ok, 0: refused

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t le32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
         | ((uint32_t)p[3] << 24);
}

inline void store32(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)v; p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16); p[3] = (uint8_t)(v >> 24);
}

inline uint32_t rotl(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

void chacha_block(const uint32_t st[16], uint8_t out[64]) {
    uint32_t s[16];
    memcpy(s, st, sizeof s);
#define QR(a, b, c, d)                                  \
    s[a] += s[b]; s[d] = rotl(s[d] ^ s[a], 16);         \
    s[c] += s[d]; s[b] = rotl(s[b] ^ s[c], 12);         \
    s[a] += s[b]; s[d] = rotl(s[d] ^ s[a], 8);          \
    s[c] += s[d]; s[b] = rotl(s[b] ^ s[c], 7)
    for (int i = 0; i < 10; i++) {
        QR(0, 4, 8, 12); QR(1, 5, 9, 13);
        QR(2, 6, 10, 14); QR(3, 7, 11, 15);
        QR(0, 5, 10, 15); QR(1, 6, 11, 12);
        QR(2, 7, 8, 13); QR(3, 4, 9, 14);
    }
#undef QR
    for (int i = 0; i < 16; i++)
        store32(out + 4 * i, s[i] + st[i]);
}

void chacha_init(uint32_t st[16], const uint8_t key[32], uint32_t counter,
                 const uint8_t nonce[12]) {
    st[0] = 0x61707865; st[1] = 0x3320646E;
    st[2] = 0x79622D32; st[3] = 0x6B206574;
    for (int i = 0; i < 8; i++) st[4 + i] = le32(key + 4 * i);
    st[12] = counter;
    for (int i = 0; i < 3; i++) st[13 + i] = le32(nonce + 4 * i);
}

void chacha_xor(const uint8_t key[32], uint32_t counter,
                const uint8_t nonce[12], const uint8_t *in, uint64_t len,
                uint8_t *out) {
    uint32_t st[16];
    chacha_init(st, key, counter, nonce);
    uint8_t ks[64];
    while (len >= 64) {
        chacha_block(st, ks);
        st[12]++;
        for (int i = 0; i < 64; i++) out[i] = in[i] ^ ks[i];
        in += 64; out += 64; len -= 64;
    }
    if (len) {
        chacha_block(st, ks);
        for (uint64_t i = 0; i < len; i++) out[i] = in[i] ^ ks[i];
    }
}

// poly1305-donna, 32-bit limbs (5 x 26-bit; 64-bit products)
struct Poly {
    uint32_t r[5], h[5], pad[4];

    void init(const uint8_t key[32]) {
        r[0] = (le32(key + 0)) & 0x3ffffff;
        r[1] = (le32(key + 3) >> 2) & 0x3ffff03;
        r[2] = (le32(key + 6) >> 4) & 0x3ffc0ff;
        r[3] = (le32(key + 9) >> 6) & 0x3f03fff;
        r[4] = (le32(key + 12) >> 8) & 0x00fffff;
        for (int i = 0; i < 5; i++) h[i] = 0;
        for (int i = 0; i < 4; i++) pad[i] = le32(key + 16 + 4 * i);
    }

    void blocks(const uint8_t *m, uint64_t len, uint32_t hibit) {
        const uint32_t s1 = r[1] * 5, s2 = r[2] * 5, s3 = r[3] * 5,
                       s4 = r[4] * 5;
        uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4];
        while (len >= 16) {
            h0 += (le32(m + 0)) & 0x3ffffff;
            h1 += (le32(m + 3) >> 2) & 0x3ffffff;
            h2 += (le32(m + 6) >> 4) & 0x3ffffff;
            h3 += (le32(m + 9) >> 6) & 0x3ffffff;
            h4 += (le32(m + 12) >> 8) | hibit;
            uint64_t d0 = (uint64_t)h0 * r[0] + (uint64_t)h1 * s4
                        + (uint64_t)h2 * s3 + (uint64_t)h3 * s2
                        + (uint64_t)h4 * s1;
            uint64_t d1 = (uint64_t)h0 * r[1] + (uint64_t)h1 * r[0]
                        + (uint64_t)h2 * s4 + (uint64_t)h3 * s3
                        + (uint64_t)h4 * s2;
            uint64_t d2 = (uint64_t)h0 * r[2] + (uint64_t)h1 * r[1]
                        + (uint64_t)h2 * r[0] + (uint64_t)h3 * s4
                        + (uint64_t)h4 * s3;
            uint64_t d3 = (uint64_t)h0 * r[3] + (uint64_t)h1 * r[2]
                        + (uint64_t)h2 * r[1] + (uint64_t)h3 * r[0]
                        + (uint64_t)h4 * s4;
            uint64_t d4 = (uint64_t)h0 * r[4] + (uint64_t)h1 * r[3]
                        + (uint64_t)h2 * r[2] + (uint64_t)h3 * r[1]
                        + (uint64_t)h4 * r[0];
            uint64_t c = d0 >> 26; h0 = (uint32_t)d0 & 0x3ffffff;
            d1 += c; c = d1 >> 26; h1 = (uint32_t)d1 & 0x3ffffff;
            d2 += c; c = d2 >> 26; h2 = (uint32_t)d2 & 0x3ffffff;
            d3 += c; c = d3 >> 26; h3 = (uint32_t)d3 & 0x3ffffff;
            d4 += c; c = d4 >> 26; h4 = (uint32_t)d4 & 0x3ffffff;
            h0 += (uint32_t)c * 5; h1 += h0 >> 26; h0 &= 0x3ffffff;
            m += 16; len -= 16;
        }
        h[0] = h0; h[1] = h1; h[2] = h2; h[3] = h3; h[4] = h4;
    }

    void tag(uint8_t out[16]) {
        uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4];
        uint32_t c = h1 >> 26; h1 &= 0x3ffffff;
        h2 += c; c = h2 >> 26; h2 &= 0x3ffffff;
        h3 += c; c = h3 >> 26; h3 &= 0x3ffffff;
        h4 += c; c = h4 >> 26; h4 &= 0x3ffffff;
        h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
        h1 += c;
        // h + 5 - 2^130; select it when h >= p
        uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
        uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
        uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
        uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
        uint32_t g4 = h4 + c - (1u << 26);
        uint32_t mask = (g4 >> 31) - 1;     // all-ones when h >= p
        h0 = (h0 & ~mask) | (g0 & mask);
        h1 = (h1 & ~mask) | (g1 & mask);
        h2 = (h2 & ~mask) | (g2 & mask);
        h3 = (h3 & ~mask) | (g3 & mask);
        h4 = (h4 & ~mask) | (g4 & mask);
        // little-endian 128-bit h + pad
        uint32_t f0 = (h0 | (h1 << 26));
        uint32_t f1 = ((h1 >> 6) | (h2 << 20));
        uint32_t f2 = ((h2 >> 12) | (h3 << 14));
        uint32_t f3 = ((h3 >> 18) | (h4 << 8));
        uint64_t t = (uint64_t)f0 + pad[0];
        store32(out + 0, (uint32_t)t);
        t = (uint64_t)f1 + pad[1] + (t >> 32);
        store32(out + 4, (uint32_t)t);
        t = (uint64_t)f2 + pad[2] + (t >> 32);
        store32(out + 8, (uint32_t)t);
        t = (uint64_t)f3 + pad[3] + (t >> 32);
        store32(out + 12, (uint32_t)t);
    }
};

// RFC 8439 §2.8 MAC input: aad || pad16 || ct || pad16 || le64(len(aad))
// || le64(len(ct)).  Every poly1305 block here is a full 16 bytes with
// the 2^128 bit set (hibit) — the zero padding is part of the message,
// not the poly1305 0x01-terminator scheme.
void aead_mac(const uint8_t key[32], const uint8_t nonce[12],
              const uint8_t *aad, uint64_t aad_len, const uint8_t *ct,
              uint64_t ct_len, uint8_t tag[16]) {
    uint32_t st[16];
    chacha_init(st, key, 0, nonce);
    uint8_t otk[64];
    chacha_block(st, otk);
    Poly p;
    p.init(otk);
    uint8_t pad[16] = {0};
    uint64_t full = aad_len & ~(uint64_t)15;
    if (full) p.blocks(aad, full, 1u << 24);
    if (aad_len & 15) {
        memcpy(pad, aad + full, aad_len & 15);
        memset(pad + (aad_len & 15), 0, 16 - (aad_len & 15));
        p.blocks(pad, 16, 1u << 24);
    }
    full = ct_len & ~(uint64_t)15;
    if (full) p.blocks(ct, full, 1u << 24);
    if (ct_len & 15) {
        memcpy(pad, ct + full, ct_len & 15);
        memset(pad + (ct_len & 15), 0, 16 - (ct_len & 15));
        p.blocks(pad, 16, 1u << 24);
    }
    uint8_t lens[16];
    for (int i = 0; i < 8; i++) {
        lens[i] = (uint8_t)(aad_len >> (8 * i));
        lens[8 + i] = (uint8_t)(ct_len >> (8 * i));
    }
    p.blocks(lens, 16, 1u << 24);
    p.tag(tag);
}

}  // namespace

extern "C" {

// out must hold pt_len + 16 bytes (ciphertext || tag).
void aead_seal(const uint8_t *key, const uint8_t *nonce, const uint8_t *aad,
               uint64_t aad_len, const uint8_t *pt, uint64_t pt_len,
               uint8_t *out) {
    chacha_xor(key, 1, nonce, pt, pt_len, out);
    aead_mac(key, nonce, aad, aad_len, out, pt_len, out + pt_len);
}

// ct_len INCLUDES the 16-byte tag; out holds ct_len - 16 bytes.
// Returns 1 on tag match, 0 on mismatch (out untouched on mismatch).
int aead_open(const uint8_t *key, const uint8_t *nonce, const uint8_t *aad,
              uint64_t aad_len, const uint8_t *ct, uint64_t ct_len,
              uint8_t *out) {
    if (ct_len < 16) return 0;
    uint64_t pt_len = ct_len - 16;
    uint8_t tag[16];
    aead_mac(key, nonce, aad, aad_len, ct, pt_len, tag);
    uint8_t diff = 0;
    for (int i = 0; i < 16; i++) diff |= (uint8_t)(tag[i] ^ ct[pt_len + i]);
    if (diff) return 0;
    chacha_xor(key, 1, nonce, ct, pt_len, out);
    return 1;
}

}  // extern "C"
