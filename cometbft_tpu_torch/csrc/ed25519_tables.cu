// ed25519_tables: per-validator ZIP-215 decode of A and the cached table
// [j](-A), j = 0..15.
//
// Replaces cometbft_tpu/ops/ed25519.py:112 prepare_pubkey_tables (with
// _build_neg_a_table, :75), which the JAX package jits once per validator
// set.  The lane layout of K6a's lane stage (lane_decode_tables,
// csrc/ed25519.cuh): blocks of 64 threads take LPB validators (16 or 32,
// ops/rlc.py:lane_block), lanes [0, LPB) of one of the two warps decode
// A (one exponentiation, ~265 field multiplications) into shared memory
// and write ok, then the block's 16 quads write the tables (negate, one
// doubling and 13 cached additions at two product latencies each on the
// quad), 16 x 40 int32 in canonical limbs (2,560 bytes per validator).
// Bound: 32-bit integer multiplies, far above the bytes; the card holds
// fewer warps than it has schedulers, so the call waits on one block's
// chain (the decode's squarings, then the quad's tables), longer where
// an SM holds a third block.  It runs once per validator set, so its
// cost is amortized across commits.
#include "ed25519.cuh"

template <int LPB>
__global__ void BOUNDS(LANE_THREADS) ed25519_tables_kernel(
    const uint8_t *__restrict__ pub, int N, int32_t *__restrict__ tab,
    uint8_t *__restrict__ ok) {
  const int lo = blockIdx.x * LPB;
  const int n = N - lo < LPB ? N - lo : LPB;
  lane_decode_tables<LPB>(pub + (size_t)lo * 32, n, tab + (size_t)lo * 640,
                          [&](int t, bool good) { ok[lo + t] = good; },
                          [](int) {});  // nothing for the other warp
}

// pub (N, 32) u8 -> tab (N, 16, 4, 10) int32, ok (N,) u8, at lpb (16 or
// 32) validators a block
extern "C" int ed25519_tables_launch(const void *pub, int N, int lpb,
                                     void *tab, void *ok, void *stream) {
  if (N <= 0) return 0;
#define TABLES_LAUNCH(LPB)                                                \
  LAUNCH(ed25519_tables_kernel<LPB>, (N + LPB - 1) / LPB, LANE_THREADS,   \
         stream, (const uint8_t *)pub, N, (int32_t *)tab, (uint8_t *)ok)
  if (lpb == 16)
    TABLES_LAUNCH(16);
  else if (lpb == 32)
    TABLES_LAUNCH(32);
  else
    return 1;  // cudaErrorInvalidValue
#undef TABLES_LAUNCH
  RETURN_LAUNCH_ERROR();
}
