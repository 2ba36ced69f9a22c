// The port's host copy of the JAX package's native KV store and merkle
// trees (cometbft_tpu/native/kvstore.cpp): an append-only log with an
// ordered in-memory index, crash-safe through CRC'd records and
// torn-tail truncation, compaction on a garbage-ratio threshold; the
// record layout is LogDB's ([crc32][klen][vlen|TOMBSTONE][key][value]),
// so either package and either backend reads the other's files.  The
// RFC-6962 trees (kv_merkle_root, kv_merkle_levels) hash with the
// shared sha256_inline.h.
//
// Exposed through a minimal C ABI consumed via ctypes
// (cometbft_tpu_torch/storage/nativedb.py, cometbft_tpu_torch/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kTombstone = 0xFFFFFFFFu;
constexpr double kCompactGarbageRatio = 0.5;
constexpr uint64_t kCompactMinBytes = 1u << 20;

// CRC-32 (IEEE, zlib-compatible) — table-driven, no external deps.
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32_ieee(const uint8_t* buf, size_t len) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Store {
  std::string path;
  int fd = -1;
  std::map<std::string, std::string> data;  // ordered: range scans
  uint64_t live_bytes = 0;
  uint64_t log_bytes = 0;

  bool open(const char* p) {
    path = p;
    replay();
    fd = ::open(path.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
    return fd >= 0;
  }

  void replay() {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> raw((size_t)size);
    if (size > 0 && fread(raw.data(), 1, (size_t)size, f) != (size_t)size) {
      fclose(f);
      return;
    }
    fclose(f);
    size_t off = 0, good = 0;
    while (off + 12 <= raw.size()) {
      uint32_t crc, klen, vlen;
      memcpy(&crc, &raw[off], 4);
      memcpy(&klen, &raw[off + 4], 4);
      memcpy(&vlen, &raw[off + 8], 4);
      uint64_t vl = (vlen == kTombstone) ? 0 : vlen;
      uint64_t end = off + 12 + (uint64_t)klen + vl;
      if (end > raw.size()) break;
      if (crc32_ieee(&raw[off + 12], (size_t)(klen + vl)) != crc) break;
      std::string key((char*)&raw[off + 12], klen);
      if (vlen == kTombstone) {
        data.erase(key);
      } else {
        data[key] = std::string((char*)&raw[off + 12 + klen], vl);
      }
      off = good = (size_t)end;
    }
    if (good < raw.size()) {
      if (truncate(path.c_str(), (off_t)good) != 0) { /* best effort */ }
    }
    log_bytes = good;
    live_bytes = 0;
    for (auto& kv : data) live_bytes += kv.first.size() + kv.second.size();
  }

  void append_record(const std::string& key, const std::string* value,
                     std::string& out) {
    uint32_t klen = (uint32_t)key.size();
    uint32_t vlen = value ? (uint32_t)value->size() : kTombstone;
    std::string body = key;
    if (value) body += *value;
    uint32_t crc = crc32_ieee((const uint8_t*)body.data(), body.size());
    out.append((char*)&crc, 4);
    out.append((char*)&klen, 4);
    out.append((char*)&vlen, 4);
    out += body;
  }

  bool write_and_sync(const std::string& buf) {
    size_t off = 0;
    while (off < buf.size()) {
      ssize_t n = ::write(fd, buf.data() + off, buf.size() - off);
      if (n <= 0) return false;
      off += (size_t)n;
    }
    log_bytes += buf.size();
    return fsync(fd) == 0;
  }

  void apply(const std::string& key, const std::string* value) {
    auto it = data.find(key);
    if (it != data.end())
      live_bytes -= it->first.size() + it->second.size();
    if (value) {
      data[key] = *value;
      live_bytes += key.size() + value->size();
    } else if (it != data.end()) {
      data.erase(it);
    }
  }

  void maybe_compact() {
    if (log_bytes < kCompactMinBytes) return;
    if ((double)live_bytes / (double)log_bytes > 1.0 - kCompactGarbageRatio)
      return;
    std::string tmp = path + ".compact";
    int tfd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (tfd < 0) return;
    std::string buf;
    for (auto& kv : data) append_record(kv.first, &kv.second, buf);
    size_t off = 0;
    while (off < buf.size()) {
      ssize_t n = ::write(tfd, buf.data() + off, buf.size() - off);
      if (n <= 0) { close(tfd); unlink(tmp.c_str()); return; }
      off += (size_t)n;
    }
    if (fsync(tfd) != 0) { close(tfd); unlink(tmp.c_str()); return; }
    close(tfd);
    if (rename(tmp.c_str(), path.c_str()) != 0) return;
    close(fd);
    fd = ::open(path.c_str(), O_WRONLY | O_APPEND, 0644);
    log_bytes = buf.size();
  }
};

struct Iter {
  std::vector<std::pair<std::string, std::string>> items;  // snapshot
  size_t pos = 0;
};

}  // namespace

extern "C" {

void* kv_open(const char* path) {
  Store* s = new Store();
  if (!s->open(path)) {
    delete s;
    return nullptr;
  }
  return s;
}

void kv_close(void* h) {
  Store* s = (Store*)h;
  if (s->fd >= 0) close(s->fd);
  delete s;
}

// returns 1 + malloc'd value when found, 0 when absent
int kv_get(void* h, const uint8_t* key, uint32_t klen, uint8_t** val,
           uint32_t* vlen) {
  Store* s = (Store*)h;
  auto it = s->data.find(std::string((const char*)key, klen));
  if (it == s->data.end()) return 0;
  *vlen = (uint32_t)it->second.size();
  *val = (uint8_t*)malloc(it->second.size() ? it->second.size() : 1);
  memcpy(*val, it->second.data(), it->second.size());
  return 1;
}

void kv_free(uint8_t* p) { free(p); }

int kv_set(void* h, const uint8_t* key, uint32_t klen, const uint8_t* val,
           uint32_t vlen) {
  Store* s = (Store*)h;
  std::string k((const char*)key, klen), v((const char*)val, vlen);
  std::string buf;
  s->append_record(k, &v, buf);
  if (!s->write_and_sync(buf)) return -1;
  s->apply(k, &v);
  s->maybe_compact();
  return 0;
}

int kv_delete(void* h, const uint8_t* key, uint32_t klen) {
  Store* s = (Store*)h;
  std::string k((const char*)key, klen);
  std::string buf;
  s->append_record(k, nullptr, buf);
  if (!s->write_and_sync(buf)) return -1;
  s->apply(k, nullptr);
  return 0;
}

// batch wire: repeated [u32 klen][u32 vlen|TOMBSTONE][key][value]
// one append + ONE fsync for the whole group (atomic grouped save)
int kv_batch(void* h, const uint8_t* wire, uint64_t len) {
  Store* s = (Store*)h;
  std::string buf;
  uint64_t off = 0;
  // first pass: parse + build the log buffer
  std::vector<std::pair<std::string, bool>> parsed;  // key, has_value
  std::vector<std::string> parsed_vals;
  while (off + 8 <= len) {
    uint32_t klen, vlen;
    memcpy(&klen, wire + off, 4);
    memcpy(&vlen, wire + off + 4, 4);
    uint64_t vl = (vlen == kTombstone) ? 0 : vlen;
    if (off + 8 + klen + vl > len) return -2;
    std::string k((const char*)wire + off + 8, klen);
    if (vlen == kTombstone) {
      s->append_record(k, nullptr, buf);
      parsed.push_back({k, false});
      parsed_vals.push_back(std::string());
    } else {
      std::string v((const char*)wire + off + 8 + klen, vl);
      parsed_vals.push_back(v);
      s->append_record(k, &parsed_vals.back(), buf);
      parsed.push_back({k, true});
    }
    off += 8 + klen + vl;
  }
  if (off != len) return -2;
  if (!s->write_and_sync(buf)) return -1;
  for (size_t i = 0; i < parsed.size(); i++)
    s->apply(parsed[i].first, parsed[i].second ? &parsed_vals[i] : nullptr);
  s->maybe_compact();
  return 0;
}

void* kv_iter_new(void* h, const uint8_t* start, uint32_t slen,
                  const uint8_t* end, uint32_t elen) {
  Store* s = (Store*)h;
  Iter* it = new Iter();
  std::string sk((const char*)start, slen);
  auto lo = s->data.lower_bound(sk);
  auto hi = elen ? s->data.lower_bound(std::string((const char*)end, elen))
                 : s->data.end();
  for (auto i = lo; i != hi; ++i) it->items.push_back(*i);
  return it;
}

int kv_iter_next(void* h, uint8_t** key, uint32_t* klen, uint8_t** val,
                 uint32_t* vlen) {
  Iter* it = (Iter*)h;
  if (it->pos >= it->items.size()) return 0;
  auto& kv = it->items[it->pos++];
  *klen = (uint32_t)kv.first.size();
  *key = (uint8_t*)malloc(kv.first.size() ? kv.first.size() : 1);
  memcpy(*key, kv.first.data(), kv.first.size());
  *vlen = (uint32_t)kv.second.size();
  *val = (uint8_t*)malloc(kv.second.size() ? kv.second.size() : 1);
  memcpy(*val, kv.second.data(), kv.second.size());
  return 1;
}

void kv_iter_free(void* h) { delete (Iter*)h; }

uint64_t kv_size(void* h) { return (uint64_t)((Store*)h)->data.size(); }

}  // extern "C"

// ----------------------------------------------------------------------
// RFC-6962 merkle root (crypto/merkle hash_from_byte_slices semantics:
// 0x00/0x01 domain prefixes, split at the largest power of two strictly
// below n, empty tree = SHA-256("")).  The builtin kvstore app calls
// this per block for its app hash — the pure-Python recursion was the
// single hottest function in the end-to-end throughput profile.

typedef unsigned long long u64k;

#include "sha256_inline.h"

static u64k split_point(u64k n) {
    u64k k = 1;
    while (k * 2 < n) k *= 2;
    return k;
}

static void merkle_node(const uint8_t *buf, const u64k *offs, u64k lo,
                        u64k hi, uint8_t out[32]) {
    static const uint8_t LEAF = 0x00, INNER = 0x01;
    u64k n = hi - lo;
    if (n == 1) {
        sha256i::oneshot3(&LEAF, 1, buf + offs[lo],
                          offs[lo + 1] - offs[lo], nullptr, 0, out);
        return;
    }
    u64k k = split_point(n);
    uint8_t l[32], r[32];
    merkle_node(buf, offs, lo, lo + k, l);
    merkle_node(buf, offs, lo + k, hi, r);
    sha256i::oneshot3(&INNER, 1, l, 32, r, 32, out);
}

// One node of the level loop, kept out of line: inlined into the loop,
// the hash context's initial value was hoisted into AVX-512 registers
// (zmm16-31) that stayed live around the SHA-NI block, whose legacy SSE
// instructions then ran at about 5 us a hash on the H100's host (the
// recursive root above, one call a node, ran at 0.2 us).
static __attribute__((noinline)) void node_hash(
        const uint8_t *prefix, const uint8_t *a, size_t na,
        const uint8_t *b, size_t nb, uint8_t out[32]) {
    sha256i::oneshot3(prefix, 1, a, na, b, nb, out);
}

extern "C" {

// leaves concatenated in `buf`; offs has n+1 entries (prefix offsets).
// n == 0 -> SHA-256 of the empty string, matching the Python tree.
void kv_merkle_root(const uint8_t *buf, const u64k *offs, u64k n,
                    uint8_t *out32) {
    if (n == 0) {
        sha256i::oneshot(nullptr, 0, out32);
        return;
    }
    merkle_node(buf, offs, 0, n, out32);
}

// Level-order tree build (crypto/merkle.py batched-proof path): every
// tree level is written to `out` as 32-byte nodes, leaf hashes first,
// root last.  Pairing is adjacent-left-to-right with an odd tail node
// PROMOTED unchanged to the next level — bit-identical to the recursive
// largest-power-of-two split above (same invariant the Python level
// loop relies on; pinned by the golden-vector tests).  `out` must
// hold sum over levels of ceil-halved widths (n + ceil(n/2) + ... + 1)
// nodes.  Returns the node count written.
u64k kv_merkle_levels(const uint8_t *buf, const u64k *offs, u64k n,
                      uint8_t *out) {
    static const uint8_t LEAF = 0x00, INNER = 0x01;
    if (n == 0) return 0;
    for (u64k i = 0; i < n; i++)
        node_hash(&LEAF, buf + offs[i], offs[i + 1] - offs[i], nullptr, 0,
                  out + 32 * i);
    uint8_t *prev = out;
    u64k w = n, total = n;
    while (w > 1) {
        uint8_t *cur = out + 32 * total;
        u64k m = w / 2;
        for (u64k i = 0; i < m; i++)
            node_hash(&INNER, prev + 64 * i, 32, prev + 64 * i + 32, 32,
                      cur + 32 * i);
        if (w & 1) memcpy(cur + 32 * m, prev + 32 * (w - 1), 32);
        w = m + (w & 1);
        prev = cur;
        total += w;
    }
    return total;
}

}  // extern "C"
