// Canonical vote sign bytes of one commit's lanes, built in one call.
//
// The port's copy of the JAX package's native encoder (put_varint and
// build_vote_sign_bytes, cometbft_tpu/native/ed25519.cpp:1195-1252),
// with nothing else of that file: the N rows of one commit differ only
// in the timestamp and the commit-vs-nil prefix, so the body without
// the timestamp comes in as three fragments and each row is assembled
// from them.  Byte-exact with types/canonical.py CanonicalVoteEncoder.
// Built with g++ by cometbft_tpu_torch/native.py.

#include <cstdint>
#include <cstring>

typedef uint64_t u64;
typedef uint8_t u8;

static inline u64 put_varint(u8* out, u64 v) {
    u64 i = 0;
    while (v >= 0x80) { out[i++] = (u8)(v | 0x80); v >>= 7; }
    out[i++] = (u8)v;
    return i;
}

extern "C" {

// flags[i] == 2 (commit) selects pre_commit, anything else pre_nil.
// Each row = varint(body_len) || pre || ts_field || post, zero-padded to
// row_stride; lens[i] receives the true length.  Returns 0 on success or
// the required stride when row_stride is too small (nothing written).
u64 build_vote_sign_bytes(const u8* pre_commit, u64 pre_commit_len,
                          const u8* pre_nil, u64 pre_nil_len,
                          const u8* post, u64 post_len,
                          const int64_t* ts_ns, const u8* flags, u64 n,
                          u8* out, u64 row_stride, u64* lens) {
    // worst-case timestamp field: tag(1) + len(1) + [tag+varint(10)] +
    // [tag+varint(5)] = 19 bytes; worst-case body-length prefix: 5
    u64 maxpre = pre_commit_len > pre_nil_len ? pre_commit_len : pre_nil_len;
    u64 need = 5 + maxpre + 19 + post_len;
    if (need > row_stride) return need;
    for (u64 i = 0; i < n; i++) {
        // Timestamp{seconds, nanos} with floor division (python divmod)
        int64_t ns = ts_ns[i];
        int64_t secs = ns / 1000000000;
        int64_t nanos = ns % 1000000000;
        if (nanos < 0) { nanos += 1000000000; secs -= 1; }
        u8 tsf[19];
        u64 tl = 0;
        if (secs != 0) {               // field 1 varint, omitted when 0
            tsf[tl++] = 0x08;
            tl += put_varint(tsf + tl, (u64)secs);
        }
        if (nanos != 0) {              // field 2 varint, omitted when 0
            tsf[tl++] = 0x10;
            tl += put_varint(tsf + tl, (u64)nanos);
        }
        const u8* pre = (flags[i] == 2) ? pre_commit : pre_nil;
        u64 pre_len = (flags[i] == 2) ? pre_commit_len : pre_nil_len;
        u64 body_len = pre_len + 2 + tl + post_len;
        u8* row = out + i * row_stride;
        u64 off = put_varint(row, body_len);
        memcpy(row + off, pre, pre_len);
        off += pre_len;
        row[off++] = 0x2a;             // field 5, wire type 2 (always emitted)
        row[off++] = (u8)tl;           // ts submessage length (<= 17)
        memcpy(row + off, tsf, tl);
        off += tl;
        memcpy(row + off, post, post_len);
        off += post_len;
        memset(row + off, 0, row_stride - off);
        lens[i] = off;
    }
    return 0;
}

}  // extern "C"
