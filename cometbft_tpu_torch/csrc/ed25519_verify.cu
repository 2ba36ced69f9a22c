// ed25519_verify_gather: the per-lane ZIP-215 verdict through a cached
// validator-set table.
//
// Replaces cometbft_tpu/ops/ed25519.py:170 verify_padded_gather (core
// _verify_core, :127).  One quad of four threads per lane (ed25519.cuh),
// 16 lanes a block.  Thread 0 of the quad checks S < L and hashes
// h = SHA-512(R || A || M) mod L while thread 1 decodes R (ZIP-215);
// then the quad runs the 64-window Straus
// ladder together, 4 doublings, one niels addition from the [j]B table
// and one cached addition from the lane's validator row [j](-A) per
// window, each point operation two product latencies on the quad; then
// - R, the cofactor and the identity test.  The [j]B table (1,920 bytes)
// is copied into shared memory once per block.
// Bound: 32-bit integer multiplies (~3,300 field multiplications per
// lane, spread over the quad); the table rows read per lane are 64 x 160
// bytes.  The latency floor is one lane's chain: the decode's ~265
// products, then 384 point operations of two product latencies each.
#include "ed25519.cuh"

#define VERIFY_THREADS 64
#define VERIFY_LANES (VERIFY_THREADS / 4)

__global__ void BOUNDS(VERIFY_THREADS) ed25519_verify_gather_kernel(
    const int32_t *__restrict__ tab, const uint8_t *__restrict__ ok_a,
    const int32_t *__restrict__ idx, const uint8_t *__restrict__ rb,
    const uint8_t *__restrict__ sb, const uint32_t *__restrict__ blocks,
    const int32_t *__restrict__ active, int B, int NB,
    uint8_t *__restrict__ out) {
  __shared__ int32_t base[16 * 30];
  __shared__ uint8_t h_sh[VERIFY_LANES][32];
  __shared__ int32_t r_sh[VERIFY_LANES][40];
  __shared__ uint8_t ok_s[VERIFY_LANES], ok_r[VERIFY_LANES];
  for (int i = threadIdx.x; i < 16 * 30; i += blockDim.x)
    base[i] = (&c_base_niels[0][0][0])[i];
  const int k = quad_k(), slot = threadIdx.x >> 2;
  const int lane = blockIdx.x * VERIFY_LANES + slot;
  // the spare quads of a ragged last block redo the last lane, unstored
  const int b = lane < B ? lane : B - 1;
  const uint8_t *s = sb + (size_t)b * 32;
  if (k == 0) {
    uint64_t st[8];
    sha512_lane(st, blocks + (size_t)b * NB * 32, active[b]);
    sc_reduce_digest(h_sh[slot], st);
    ok_s[slot] = sc_lt_l(s);
  } else if (k == 1) {
    ge_ext r;
    ok_r[slot] = ge_decompress_zip215(r, rb + (size_t)b * 32);
#pragma unroll
    for (int i = 0; i < 10; i++) {
      r_sh[slot][i] = r.x.v[i];
      r_sh[slot][10 + i] = r.y.v[i];
      r_sh[slot][20 + i] = r.z.v[i];
      r_sh[slot][30 + i] = r.t.v[i];
    }
  }
  __syncthreads();
  const int v = idx[b];
  const int32_t *row = tab + (size_t)v * 640;
  const uint8_t *h = h_sh[slot];
  ge_ext acc;
  ge_identity(acc);
  fe q;
  for (int w = 63; w >= 0; w--) {
    if (w < 63)
      for (int i = 0; i < 4; i++) geq_dbl(acc, k);
    geq_niels_part(q, base + 30 * nibble(s, w), k);
    geq_add(acc, k, q);
    geq_cached_part(q, row + 40 * nibble(h, w), k);
    geq_add(acc, k, q);
  }
  ge_ext r;
  fe_load(r.x, r_sh[slot]);
  fe_load(r.y, r_sh[slot] + 10);
  fe_load(r.z, r_sh[slot] + 20);
  fe_load(r.t, r_sh[slot] + 30);
  ge_neg(r, r);
  geq_cache_part(q, r, k, true);
  geq_add(acc, k, q);
  for (int i = 0; i < 3; i++) geq_dbl(acc, k);
  if (k == 0 && lane < B)
    out[lane] = (ok_a[v] && ok_s[slot] && ok_r[slot] && ge_is_identity(acc))
                    ? 1 : 0;
}

extern "C" int ed25519_verify_gather_launch(
    const void *tab, const void *ok_a, const void *idx, const void *rb,
    const void *sb, const void *blocks, const void *active, int B, int NB,
    void *out, void *stream) {
  if (B <= 0) return 0;
  LAUNCH(ed25519_verify_gather_kernel, (B + VERIFY_LANES - 1) / VERIFY_LANES,
         VERIFY_THREADS, stream, (const int32_t *)tab, (const uint8_t *)ok_a,
         (const int32_t *)idx, (const uint8_t *)rb, (const uint8_t *)sb,
         (const uint32_t *)blocks, (const int32_t *)active, B, NB,
         (uint8_t *)out);
  RETURN_LAUNCH_ERROR();
}
