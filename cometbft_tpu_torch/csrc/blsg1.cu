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
// b3 = 12), so identity rows, doublings and cancellations take the same
// code.  Every value is fully reduced after every operation, so any split
// of the work gives the same canonical values as the JAX package and the
// plain version: the product by b3 is taken here as 8x + 4x (modular
// additions), the same value as the reference's Montgomery product by
// 12R.
//
// The sum is the reference's halving tree, row i + row i + h over the
// rows padded with identities to n2 = 2^L, and the same additions on the
// same pairs: RCB15 addition is complete but not canonical (adding the
// identity returns a multiple of the point), so no row is skipped.  The
// tree splits across blocks: with G blocks (a power of two), every pair
// (i, i + h) with h >= G lies in one residue class mod G, so block g
// folds the rows g + G m in shared memory and ends with what row g of the
// reference's level of G rows holds; the last log2 G levels are a tree
// over the G block results.  Launches (one C call, on the caller's
// stream), each a g1_fold_kernel of G1_ROWS rows a block at most:
//   n2 <= G1_ROWS    one block loads the rows (a selected row into
//                    Montgomery form with Z = 1, any other row and the
//                    padding as the identity (0 : 1 : 0)), folds them and
//                    writes row 0 out of Montgomery form as (3, 32)
//                    canonical 12-bit limbs, the JAX boundary;
//   else             the levels split evenly over ceil(L / log2 G1_ROWS)
//                    launches: the first loads from the table into G
//                    block sums (the scratch), each later one folds the
//                    scratch in place (block g reads rows g + G m and
//                    writes row g, which no other block reads), the last
//                    writes the limbs.  Two launches up to 2^16 rows.
// A level of a block runs G1_GROUPS additions at a time, each spread over
// six threads: the formula's products fall into two dependent rounds of
// six (X1X2, Y1Y2, Z1Z2 and the three cross products; then the six
// output products), each thread one product a round, exchanged through
// the block's rows in shared memory (a round's products overwrite the
// pair's two rows, which the round has read), so a level costs two
// product latencies and not fourteen.  A warp runs one product of 32
// additions, so a branch on the product is never divergent, and the six
// warps of one addition's products spread over the SM's four schedulers
// (g1_role): a product keeps a scheduler busy for about 2,000 of its
// 3,100 cycles of latency, so three on one scheduler take twice as long
// (scripts/blsg1_core_bench.py).
//
// Bound on the H100: 32-bit integer instructions.  A product is 144
// 32x32->64-bit multiply-adds for a * b and as many for the reduction
// with their carries; the bound counts the work of the first CUDA
// version, a thread an addition (966 integer instructions a product and
// 15,470 an addition from its SASS, chip_smoke.py:G1_INT_PER_MUL,
// G1_INT_PER_ADD).  The bytes (96 per table row) take far less time.  At
// these sizes the levels' chain binds: L levels of two product latencies
// each.
//
// Every __noinline__ function here reads all its inputs before it writes
// its output (the nvcc 12.9 stack-slot fault of csrc/ed25519.cuh), so an
// output may alias an input.
#include "launch.cuh"
#include "blsg1_consts.h"

#define FP_N 12

// G1_ROWS, the most rows a block folds (a power of two), comes with the
// constants (ops/blsg1.py:FOLD_ROWS)
#ifndef G1_GROUPS
#define G1_GROUPS 64   // additions a block runs at once
#endif
#define G1_THREADS (6 * G1_GROUPS)
// additions a warp holds, one product of each
#define G1_WARP (G1_GROUPS < 32 ? G1_GROUPS : 32)
// after each barrier of an addition (scripts/blsg1_core_bench.cu times
// its phases through it)
#ifndef G1_STAMP
#define G1_STAMP(phase)
#endif

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

// 12 a = 8 a + 4 a, the reference's product by b3 = 12
DEV fp fp_mul12(const fp &a) {
  const fp a2 = fp_add(a, a), a4 = fp_add(a2, a2);
  return fp_add(fp_add(a4, a4), a4);
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

// a projective point (X : Y : Z), Montgomery form
struct g1p {
  fp c[3];
};

// One addition of RCB15 Algorithm 7 (a = 0, b3 = 12; ops/blsg1.py:_padd)
// by six threads, k = 0..5 the thread's product: rows[i] += rows[i + h].
// Every thread of the block calls it (`active` false past the level's
// last pair), since it holds the block's barriers.
//   round 1, thread k:  X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
//                       (X1+Z1)(X2+Z2) -> t0, t1, t2, m3, m4, m5, into
//                       X, Y, Z of row i, then of row i + h;
//   round 2, thread k:  with t3 = m3 - t0 - t1, t4 = m4 - t1 - t2,
//                       yz = 12 (m5 - t0 - t2), 3t0, z3 = t1 + 12 t2 and
//                       t1' = t1 - 12 t2:  t3 t1', t4 yz, yz 3t0, t1' z3,
//                       z3 t4, 3t0 t3 -> product 2c into coordinate c of
//                       row i, 2c + 1 into that of row i + h;
//   then thread c < 3:  X3 = q0 - q1, Y3 = q2 + q3, Z3 = q4 + q5 into row
//                       i, coordinate c.
DEV void g1_add_shared(g1p *rows, int i, int h, int k, bool active) {
  g1p *a = rows + i, *b = rows + i + h;
  fp m = {};
  if (active) {
    fp l, r;
    if (k < 3) {
      l = a->c[k];
      r = b->c[k];
    } else {  // (X, Y), (Y, Z), (X, Z)
      const int u = k == 4 ? 1 : 0, v = k == 3 ? 1 : 2;
      l = fp_add(a->c[u], a->c[v]);
      r = fp_add(b->c[u], b->c[v]);
    }
    m = fp_mul(l, r);
  }
  __syncthreads();  // the pair's rows are read
  G1_STAMP(0);
  if (active) (k < 3 ? a : b)->c[k % 3] = m;
  __syncthreads();
  G1_STAMP(1);
  if (active) {
    const fp t0 = a->c[0], t1 = a->c[1], t2 = a->c[2];
    fp l, r;
    if (k == 1 || k == 2) {
      const fp yz = fp_mul12(fp_sub(b->c[2], fp_add(t0, t2)));
      l = yz;
      r = k == 1 ? fp_sub(b->c[1], fp_add(t1, t2))
                 : fp_add(fp_add(t0, t0), t0);
    } else if (k == 0 || k == 5) {
      l = fp_sub(b->c[0], fp_add(t0, t1));
      r = k == 0 ? fp_sub(t1, fp_mul12(t2)) : fp_add(fp_add(t0, t0), t0);
    } else {  // k = 3, 4
      const fp t2b = fp_mul12(t2);
      l = fp_add(t1, t2b);
      r = k == 3 ? fp_sub(t1, t2b) : fp_sub(b->c[1], fp_add(t1, t2));
    }
    m = fp_mul(l, r);
  }
  __syncthreads();  // the round-1 products are read
  G1_STAMP(2);
  if (active) ((k & 1) ? b : a)->c[k >> 1] = m;
  __syncthreads();
  G1_STAMP(3);
  if (active && k < 3) {
    const fp x = a->c[k], y = b->c[k];
    a->c[k] = k == 0 ? fp_sub(x, y) : fp_add(x, y);
  }
  __syncthreads();
  G1_STAMP(4);
}

// This thread's product k and addition gi of a level: warp w takes
// product w % 6 of additions G1_WARP (w / 6) + lane, so the six warps of
// the first 32 additions (a level near the root has no more) lie on the
// SM's four schedulers (warp w on scheduler w % 4) two or one apiece
DEV void g1_role(int &k, int &gi) {
  const int w = threadIdx.x / G1_WARP;
  k = w % 6;
  gi = w / 6 * G1_WARP + threadIdx.x % G1_WARP;
}

// Block g of G folds M rows (a power of two, at most G1_ROWS), source
// row g + G s as its row s, and writes its sum: to dst[g] (Montgomery
// form), or, where out is not null (G = 1), to out as (3, 32) limbs.
// The source is the table (rows not null: (R, 2, 12) canonical affine
// words and the (R,) mask, rows past R padding) or src, G * M projective
// points; dst may be src.
__global__ void BOUNDS(G1_THREADS) g1_fold_kernel(
    const uint32_t *__restrict__ rows, const int32_t *__restrict__ mask,
    int R, const g1p *src, int M, int G, g1p *dst,
    int32_t *__restrict__ out) {
  __shared__ g1p sh[G1_ROWS];
  const int tid = threadIdx.x, g = blockIdx.x;
  if (rows != nullptr) {
    // one coordinate of a row a thread: X or Y, and Z with X
    const fp r2 = fp_from_const(c_bls_r2), one = fp_from_const(c_bls_one_m);
    fp zero;
#pragma unroll
    for (int k = 0; k < FP_N; k++) zero.w[k] = 0;
    for (int q = tid; q < 2 * M; q += G1_THREADS) {
      const int s = q >> 1, c = q & 1;
      const size_t j = g + (size_t)G * s;
      const bool sel = j < (size_t)R && mask[j] != 0;
      fp v = c ? one : zero;
      if (sel) {
#pragma unroll
        for (int k = 0; k < FP_N; k++)
          v.w[k] = rows[j * 2 * FP_N + c * FP_N + k];
        v = fp_mul(v, r2);
      }
      sh[s].c[c] = v;
      if (c == 0) sh[s].c[2] = sel ? one : zero;
    }
  } else {
    for (int q = tid; q < 3 * M; q += G1_THREADS)
      sh[q / 3].c[q % 3] = src[g + (size_t)G * (q / 3)].c[q % 3];
  }
  __syncthreads();
  int k, gi;
  g1_role(k, gi);
  for (int h = M / 2; h >= 1; h /= 2)
    for (int i = gi; i - gi < h; i += G1_GROUPS)
      g1_add_shared(sh, i < h ? i : 0, h, k, i < h);
  if (tid >= 3) return;
  if (out == nullptr) {
    dst[g].c[tid] = sh[0].c[tid];
    return;
  }
  fp one;
#pragma unroll
  for (int w = 0; w < FP_N; w++) one.w[w] = w == 0;
  const fp v = fp_mul(sh[0].c[tid], one);
  for (int l = 0; l < 32; l++) {
    const int bit = 12 * l, w = bit >> 5, off = bit & 31;
    uint32_t x = v.w[w] >> off;
    if (off > 20 && w + 1 < FP_N) x |= v.w[w + 1] << (32 - off);
    out[tid * 32 + l] = (int32_t)(x & 0xFFFu);
  }
}

// log2 of a power of two
static int g1_log2(int n) {
  int l = 0;
  while ((1 << l) < n) l++;
  return l;
}

// rows (R, 2, 12) words and mask (R,) -> out (3, 32) limbs, n2 the least
// power of two >= max(R, 1).  The first of several launches writes its
// block sums to scratch, scratch_rows projective points of 3 * 12 words
// (ops/blsg1.py:_scratch_rows: n2 >> (L // passes)); one launch needs
// none.
extern "C" int aggregate_g1_masked_launch(const void *rows, const void *mask,
                                          int R, int n2, void *scratch,
                                          int scratch_rows, void *out,
                                          void *stream) {
  if (R < 0 || n2 < 1 || n2 < R || (n2 & (n2 - 1))) return -1;
  const int lmax = g1_log2(G1_ROWS);
  int left = g1_log2(n2), n = n2;
  const int passes = left <= lmax ? 1 : (left + lmax - 1) / lmax;
  if (passes > 1 && (n2 >> (left / passes)) > scratch_rows) return -1;
  for (int p = 0; p < passes; p++) {
    const int a = left / (passes - p), M = 1 << a, G = n >> a;
    const bool last = p + 1 == passes;
    LAUNCH(g1_fold_kernel, G, G1_THREADS, stream,
           p == 0 ? (const uint32_t *)rows : nullptr, (const int32_t *)mask,
           R, p == 0 ? nullptr : (const g1p *)scratch, M, G,
           last ? nullptr : (g1p *)scratch,
           last ? (int32_t *)out : nullptr);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    n = G;
    left -= a;
  }
  return 0;
}
