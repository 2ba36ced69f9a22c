// aggregate_g1_masked: the masked sum of BLS12-381 G1 points.
//
// Replaces cometbft_tpu/ops/blsg1.py:169 aggregate_g1_masked, the device
// half of the aggregate-commit check (crypto/blsagg.py): the selected
// rows of a validator set's cohort table of affine public keys are added
// into one projective point, which the host turns affine (one inversion)
// and feeds to the two pairings.
//
// Arithmetic, as in the JAX package and the plain version
// (ops/blsg1.py): F_p with p of 381 bits in Montgomery form with
// R = 2^384, here as 12 little-endian 32-bit words and CIOS
// multiplication with 64-bit products; point addition is the complete
// projective formula for a = 0 (Renes-Costello-Batina 2015, Algorithm 7,
// b3 = 12), 14 Montgomery products, so identity rows, doublings and
// cancellations take the same code.  Every value is fully reduced after
// every operation, so the result is the same canonical point as the JAX
// package's and the plain version's.
//
// Launches (one C call, on the caller's stream):
//   g1_load_kernel    one thread per row of the padded table (n2 rows, a
//                     power of two >= R): a selected row goes into
//                     Montgomery form with Z = 1, any other row (and the
//                     padding) becomes the identity (0 : 1 : 0);
//   g1_level_kernel   one launch per tree level, one thread per parent:
//                     row i += row i + h, in place (thread i alone reads
//                     rows i and i + h and writes row i); log2(n2) levels,
//                     14 for 10,000 rows;
//   g1_store_kernel   one thread: row 0 out of Montgomery form, written as
//                     (3, 32) canonical 12-bit limbs, the JAX boundary.
//
// Bound on the H100: 32-bit integer instructions.  A product is 144
// 32x32->64-bit multiply-adds for a * b and as many for the reduction
// with their carries (966 integer instructions in the built SASS,
// scripts/blsg1_sass_count.py); an addition is 14 products plus 19
// modular adds and subs (15,470).  The bytes (96 per table row, 144 per
// projective row of a level) take far less time than the operations.
// Each thread's chain of products is serial and the levels near the root
// hold a handful of threads, so the series waits on latency at these
// sizes; that is expected for a first kernel.
//
// Every __noinline__ function here reads all its inputs before it writes
// its output (the nvcc 12.9 stack-slot fault of csrc/ed25519.cuh), so an
// output may alias an input.
#include "launch.cuh"
#include "blsg1_consts.h"

#define FP_N 12

struct fp {
  uint32_t w[FP_N];
};

// a + b as a 64-bit sum split into word and carry
DEV uint32_t addc(uint32_t a, uint32_t b, uint32_t &carry) {
  const uint64_t t = (uint64_t)a + b + carry;
  carry = (uint32_t)(t >> 32);
  return (uint32_t)t;
}

DEV uint32_t subb(uint32_t a, uint32_t b, uint32_t &borrow) {
  const uint64_t t = (uint64_t)a - b - borrow;
  borrow = (uint32_t)(t >> 63);
  return (uint32_t)t;
}

DEV fp fp_from_const(const uint32_t c[FP_N]) {
  fp r;
#pragma unroll
  for (int i = 0; i < FP_N; i++) r.w[i] = c[i];
  return r;
}

// t - p where that does not borrow, else t (0 <= t < 2p)
DEV fp fp_reduce_once(const uint32_t t[FP_N]) {
  uint32_t d[FP_N], borrow = 0;
#pragma unroll
  for (int i = 0; i < FP_N; i++) d[i] = subb(t[i], c_bls_p[i], borrow);
  fp r;
#pragma unroll
  for (int i = 0; i < FP_N; i++) r.w[i] = borrow ? t[i] : d[i];
  return r;
}

DEV fp fp_add(const fp &a, const fp &b) {
  uint32_t t[FP_N], carry = 0;
#pragma unroll
  for (int i = 0; i < FP_N; i++) t[i] = addc(a.w[i], b.w[i], carry);
  return fp_reduce_once(t);  // a + b < 2p < 2^382: no carry out
}

DEV fp fp_sub(const fp &a, const fp &b) {
  uint32_t t[FP_N], borrow = 0;
#pragma unroll
  for (int i = 0; i < FP_N; i++) t[i] = subb(a.w[i], b.w[i], borrow);
  uint32_t mask = 0u - borrow, carry = 0;  // add p back where a < b
  fp r;
#pragma unroll
  for (int i = 0; i < FP_N; i++)
    r.w[i] = addc(t[i], c_bls_p[i] & mask, carry);
  return r;
}

// Montgomery product a * b * 2^-384 mod p (CIOS, 12 words).  Reads a and
// b completely into the accumulation before the result is written.
DEV_NOINLINE fp fp_mul(const fp a, const fp b) {
  uint32_t t[FP_N + 2];
#pragma unroll
  for (int i = 0; i < FP_N + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < FP_N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FP_N; j++) {
      c = (uint64_t)a.w[j] * b.w[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[FP_N] + (c >> 32);
    t[FP_N] = (uint32_t)c;
    t[FP_N + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * c_bls_n0;
    c = (uint64_t)m * c_bls_p[0] + t[0];
#pragma unroll
    for (int j = 1; j < FP_N; j++) {
      c = (uint64_t)m * c_bls_p[j] + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[FP_N] + (c >> 32);
    t[FP_N - 1] = (uint32_t)c;
    t[FP_N] = t[FP_N + 1] + (uint32_t)(c >> 32);
  }
  return fp_reduce_once(t);  // t < 2p, so t[FP_N] is 0
}

struct g1p {
  fp x, y, z;
};

// RCB15 Algorithm 7 for a = 0, b3 = 12 (ops/blsg1.py:_padd); the
// sequence of the JAX package's formulas, name for name.
DEV g1p g1_add(const g1p &p1, const g1p &p2) {
  const fp b3 = fp_from_const(c_bls_b3_m);
  fp t0 = fp_mul(p1.x, p2.x);
  fp t1 = fp_mul(p1.y, p2.y);
  fp t2 = fp_mul(p1.z, p2.z);
  const fp t3 = fp_sub(fp_mul(fp_add(p1.x, p1.y), fp_add(p2.x, p2.y)),
                       fp_add(t0, t1));
  const fp t4 = fp_sub(fp_mul(fp_add(p1.y, p1.z), fp_add(p2.y, p2.z)),
                       fp_add(t1, t2));
  const fp xz = fp_sub(fp_mul(fp_add(p1.x, p1.z), fp_add(p2.x, p2.z)),
                       fp_add(t0, t2));
  t0 = fp_add(fp_add(t0, t0), t0);  // 3 X1X2
  t2 = fp_mul(b3, t2);              // b3 Z1Z2
  fp z3 = fp_add(t1, t2);
  t1 = fp_sub(t1, t2);
  const fp yz = fp_mul(b3, xz);     // b3 (X1Z2 + X2Z1)
  g1p r;
  r.x = fp_sub(fp_mul(t3, t1), fp_mul(t4, yz));
  r.y = fp_add(fp_mul(yz, t0), fp_mul(t1, z3));
  r.z = fp_add(fp_mul(z3, t4), fp_mul(t0, t3));
  return r;
}

// rows (R, 2, 12) canonical affine words, mask (R,) -> level (n2, 3, 12)
__global__ void g1_load_kernel(const uint32_t *__restrict__ rows,
                               const int32_t *__restrict__ mask, int R,
                               int n2, g1p *__restrict__ level) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  g1p q;
  q.y = fp_from_const(c_bls_one_m);
#pragma unroll
  for (int k = 0; k < FP_N; k++) q.x.w[k] = q.z.w[k] = 0;
  if (i < R && mask[i] != 0) {
    const fp r2 = fp_from_const(c_bls_r2);
    fp x, y;
#pragma unroll
    for (int k = 0; k < FP_N; k++) {
      x.w[k] = rows[(size_t)i * 2 * FP_N + k];
      y.w[k] = rows[(size_t)i * 2 * FP_N + FP_N + k];
    }
    q.x = fp_mul(x, r2);
    q.y = fp_mul(y, r2);
    q.z = fp_from_const(c_bls_one_m);
  }
  level[i] = q;
}

// level[i] = level[i] + level[i + h] for i < h
__global__ void g1_level_kernel(g1p *__restrict__ level, int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  const g1p a = level[i], b = level[i + h];
  level[i] = g1_add(a, b);
}

// level[0] out of Montgomery form -> out (3, 32) 12-bit limbs
__global__ void g1_store_kernel(const g1p *__restrict__ level,
                                int32_t *__restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  fp one;
#pragma unroll
  for (int k = 0; k < FP_N; k++) one.w[k] = k == 0;
  const g1p s = level[0];
  const fp c[3] = {fp_mul(s.x, one), fp_mul(s.y, one), fp_mul(s.z, one)};
  for (int j = 0; j < 3; j++)
    for (int l = 0; l < 32; l++) {
      const int bit = 12 * l, w = bit >> 5, off = bit & 31;
      uint32_t v = c[j].w[w] >> off;
      if (off > 20 && w + 1 < FP_N) v |= c[j].w[w + 1] << (32 - off);
      out[j * 32 + l] = (int32_t)(v & 0xFFFu);
    }
}

// rows (R, 2, 12) words and mask (R,) -> out (3, 32) limbs; scratch holds
// n2 * 3 * 12 words, n2 the least power of two >= max(R, 1)
extern "C" int aggregate_g1_masked_launch(const void *rows, const void *mask,
                                          int R, int n2, void *scratch,
                                          void *out, void *stream) {
  if (R < 0 || n2 < 1 || n2 < R || (n2 & (n2 - 1))) return -1;
  const int threads = 128;
  g1p *level = (g1p *)scratch;
  LAUNCH(g1_load_kernel, (n2 + threads - 1) / threads, threads, stream,
         (const uint32_t *)rows, (const int32_t *)mask, R, n2, level);
  for (int h = n2 / 2; h >= 1; h /= 2)
    LAUNCH(g1_level_kernel, (h + threads - 1) / threads, threads, stream,
           level, h);
  LAUNCH(g1_store_kernel, 1, 1, stream, (const g1p *)level, (int32_t *)out);
  RETURN_LAUNCH_ERROR();
}
