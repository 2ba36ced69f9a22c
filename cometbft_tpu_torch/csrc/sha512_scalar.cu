// sha512_scalar: h = SHA-512(R || A || M) mod L for every lane.
//
// Replaces the hash-and-reduce stage that XLA inlines into the TPU verify
// programs: cometbft_tpu/ops/sha512.py:165 sha512_blocks followed by
// cometbft_tpu/ops/scalar.py:67 reduce512.  One thread per lane walks its
// active host-padded blocks with native 64-bit words, then reduces the
// digest fully below L.  Bound: integer operations (80 rounds of 64-bit
// adds and rotates per block); the bytes moved are 256 per block in and 32
// out per lane.  The same device code is inlined in ed25519_verify.cu and
// in ed25519_rlc.cu's lane stage, so the verify paths never launch this
// kernel: it stands alone behind the public sha512_scalar.
#include "ed25519.cuh"

__global__ void sha512_scalar_kernel(const uint32_t *__restrict__ blocks,
                                     const int32_t *__restrict__ active,
                                     int B, int NB, uint8_t *__restrict__ h) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint64_t st[8];
  sha512_lane(st, blocks + (size_t)b * NB * 32, active[b]);
  sc_reduce_digest(h + (size_t)b * 32, st);
}

extern "C" int sha512_scalar_launch(const void *blocks, const void *active,
                                    int B, int NB, void *h, void *stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  LAUNCH(sha512_scalar_kernel, (B + threads - 1) / threads, threads, stream,
         (const uint32_t *)blocks, (const int32_t *)active, B, NB,
         (uint8_t *)h);
  RETURN_LAUNCH_ERROR();
}
