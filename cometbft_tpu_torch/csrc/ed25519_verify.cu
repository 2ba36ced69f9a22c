// ed25519_verify_gather: the per-lane ZIP-215 verdict through a cached
// validator-set table.
//
// Replaces cometbft_tpu/ops/ed25519.py:170 verify_padded_gather (core
// _verify_core, :127).  One thread per lane: S < L, ZIP-215 decode of R,
// h = SHA-512(R || A || M) mod L (the sha512_scalar device code, inlined),
// then a 64-window Straus ladder with 4 doublings per window, one niels
// addition from the constant [j]B table and one cached addition from the
// lane's validator row [j](-A), then - R, the cofactor and the identity
// test.  Bound: 32-bit integer multiplies (~3,300 field multiplications
// of 100 products each per lane); the table rows read per lane are 64 x
// 160 bytes.  The constant table sits in __constant__ memory, which
// serializes a warp's differing digits: a first, simple design.
#include "ed25519.cuh"

__global__ void ed25519_verify_gather_kernel(
    const int32_t *__restrict__ tab, const uint8_t *__restrict__ ok_a,
    const int32_t *__restrict__ idx, const uint8_t *__restrict__ rb,
    const uint8_t *__restrict__ sb, const uint32_t *__restrict__ blocks,
    const int32_t *__restrict__ active, int B, int NB,
    uint8_t *__restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t *s = sb + (size_t)b * 32;
  const bool ok_s = sc_lt_l(s);
  ge_ext r;
  const bool ok_r = ge_decompress_zip215(r, rb + (size_t)b * 32);
  uint8_t digest[64], h[32];
  sha512_lane(digest, blocks + (size_t)b * NB * 32, active[b]);
  sc_reduce512_bytes(h, digest);
  const int v = idx[b];
  const int32_t *row = tab + (size_t)v * 640;

  ge_ext acc;
  ge_identity(acc);
  ge_niels bn;
  ge_cached ca;
  for (int w = 63; w >= 0; w--) {
    for (int i = 0; i < 4; i++) ge_dbl(acc, acc);
    ge_base_niels(bn, nibble(s, w));
    ge_add_niels(acc, acc, bn);
    ge_load_cached(ca, row + 40 * nibble(h, w));
    ge_add_cached(acc, acc, ca);
  }
  ge_ext nr;
  ge_neg(nr, r);
  ge_cache(ca, nr);
  ge_add_cached(acc, acc, ca);
  ge_mul_by_cofactor(acc);
  out[b] = (ok_a[v] && ok_r && ok_s && ge_is_identity(acc)) ? 1 : 0;
}

extern "C" int ed25519_verify_gather_launch(
    const void *tab, const void *ok_a, const void *idx, const void *rb,
    const void *sb, const void *blocks, const void *active, int B, int NB,
    void *out, void *stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  LAUNCH(ed25519_verify_gather_kernel, (B + threads - 1) / threads, threads,
         stream, (const int32_t *)tab, (const uint8_t *)ok_a,
         (const int32_t *)idx, (const uint8_t *)rb, (const uint8_t *)sb,
         (const uint32_t *)blocks, (const int32_t *)active, B, NB,
         (uint8_t *)out);
  RETURN_LAUNCH_ERROR();
}
