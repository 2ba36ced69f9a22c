// ed25519_tables: per-validator ZIP-215 decode of A and the cached table
// [j](-A), j = 0..15.
//
// Replaces cometbft_tpu/ops/ed25519.py:112 prepare_pubkey_tables (with
// _build_neg_a_table, :75), which the JAX package jits once per validator
// set.  One thread per validator: decompress (one exponentiation, ~275
// field multiplications), negate, one doubling and 13 cached additions,
// then 16 x 40 int32 in canonical limbs written contiguously (2,560 bytes
// per validator).
// Bound: 32-bit integer multiplies; it runs once per validator set, so
// its cost is amortized across commits.
#include "ed25519.cuh"

__global__ void ed25519_tables_kernel(const uint8_t *__restrict__ pub, int N,
                                      int32_t *__restrict__ tab,
                                      uint8_t *__restrict__ ok) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  ge_ext a;
  const bool good = ge_decompress_zip215(a, pub + (size_t)n * 32);
  ge_write_neg_table(tab + (size_t)n * 640, a);
  ok[n] = good ? 1 : 0;
}

extern "C" int ed25519_tables_launch(const void *pub, int N, void *tab,
                                     void *ok, void *stream) {
  if (N <= 0) return 0;
  const int threads = 128;
  LAUNCH(ed25519_tables_kernel, (N + threads - 1) / threads, threads, stream,
         (const uint8_t *)pub, N, (int32_t *)tab, (uint8_t *)ok);
  RETURN_LAUNCH_ERROR();
}
