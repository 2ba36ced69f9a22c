// Ed25519 ZIP-215 device arithmetic shared by the port's CUDA kernels.
//
// Counterpart of cometbft_tpu/ops/{fe_lm,group,sha512,scalar}.py, which
// XLA inlines into the TPU verify programs.  Every function here mirrors
// a plain PyTorch function of cometbft_tpu_torch/ops/{fe,group,sha512,
// scalar}.py operation for operation and with the same carry schedule,
// so a kernel and its plain version compute the same limbs:
//
//   field    ref10 representation, 10 signed limbs of 26/25 bits held in
//            int32, 32 x 32 -> 64-bit products, three parallel floor
//            carry passes after a product, one after an add or subtract;
//   group    extended twisted-Edwards (a = -1) hwcd-2008 formulas with
//            cached and niels operands, permissive ZIP-215 decoding;
//   sha512   native 64-bit words over host-padded big-endian blocks;
//   scalars  ref10 sc_reduce over 21-bit signed limbs in int64, fully
//            reduced below L.
//
// One thread owns one lane; nothing here touches shared memory.  The
// constants (d, 2d, sqrt(-1), 1/2, 1/(2d), the [j]B niels table, the
// SHA-512 round constants, the sc_reduce fold digits and L) come from
// the generated header ed25519_consts.h, which ops/_build.py writes from
// the port's Python oracle before compiling.
//
// Every __noinline__ function reads all of its inputs before it writes
// an output.  nvcc's front-end optimizer (nvcc 12.9 at -O1 and above;
// not -G, not -Xcicc -O0) may give a caller's input object that dies at
// a call the same stack slot as the object the call writes: compiled
// so, the inlined ge_identity_cached passed one address as both the
// output and the input of ge_cache, which then read a half-written
// point.  A callee that finishes reading before it writes is right
// either way (scripts/cuda_stack_slot_probe.py shows both).
#pragma once

#include "launch.cuh"

#include "ed25519_consts.h"

// ------------------------------------------------------------------ field

struct fe {
  int32_t v[10];
};

DEV int limb_width(int i) { return (i & 1) ? 25 : 26; }

DEV void fe_carry(int64_t h[10], int passes) {
  for (int p = 0; p < passes; p++) {
    int64_t c[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
      c[i] = h[i] >> limb_width(i);
      h[i] &= (int64_t(1) << limb_width(i)) - 1;
    }
    h[0] += 19 * c[9];
#pragma unroll
    for (int i = 1; i < 10; i++) h[i] += c[i - 1];
  }
}

DEV void fe_store(fe &o, const int64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = (int32_t)h[i];
}

DEV void fe_const(fe &o, int which) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = c_fe_consts[which][i];
}

DEV void fe_set_small(fe &o, int32_t x) {
  o.v[0] = x;
#pragma unroll
  for (int i = 1; i < 10; i++) o.v[i] = 0;
}

DEV void fe_add(fe &o, const fe &a, const fe &b) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)a.v[i] + b.v[i];
  fe_carry(h, 1);
  fe_store(o, h);
}

DEV void fe_sub(fe &o, const fe &a, const fe &b) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (int64_t)a.v[i] - b.v[i];
  fe_carry(h, 1);
  fe_store(o, h);
}

DEV void fe_neg(fe &o, const fe &a) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = -(int64_t)a.v[i];
  fe_carry(h, 1);
  fe_store(o, h);
}

// 100 products into 10 columns: limb i times limb j lands in column
// (i + j) mod 10, doubled when both limbs are odd (bit-offset mismatch)
// and times 19 when it wraps past 2^255.  Columns stay below 2^61.
DEV void fe_mul(fe &o, const fe &f, const fe &g) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int k = (i + j) % 10;
      const int64_t coef =
          (((i & 1) && (j & 1)) ? 2 : 1) * ((i + j >= 10) ? 19 : 1);
      h[k] += (int64_t)f.v[i] * (int64_t)g.v[j] * coef;
    }
  }
  fe_carry(h, 3);
  fe_store(o, h);
}

DEV void fe_sq(fe &o, const fe &f) { fe_mul(o, f, f); }

DEV void fe_seq_carry(int64_t x[10]) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    int64_t c = x[i] >> limb_width(i);
    x[i] &= (int64_t(1) << limb_width(i)) - 1;
    x[i + 1] += c;
  }
  int64_t c = x[9] >> 25;
  x[9] &= (int64_t(1) << 25) - 1;
  x[0] += 19 * c;
}

// canonical limbs of the value mod p (ops/fe.py:freeze)
DEV void fe_freeze(fe &o, const fe &a) {
  int64_t x[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int64_t p_limb = (int64_t(1) << limb_width(i)) - 1;
    if (i == 0) p_limb -= 18;
    x[i] = (int64_t)a.v[i] + 2 * p_limb;
  }
  fe_seq_carry(x);
  fe_seq_carry(x);
  fe_seq_carry(x);
  int64_t q = (x[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < 10; i++) q = (x[i] + q) >> limb_width(i);
  x[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    int64_t c = x[i] >> limb_width(i);
    x[i] &= (int64_t(1) << limb_width(i)) - 1;
    x[i + 1] += c;
  }
  x[9] &= (int64_t(1) << 25) - 1;
  fe_store(o, x);
}

DEV bool fe_is_zero(const fe &a) {
  fe t;
  fe_freeze(t, a);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= t.v[i];
  return acc == 0;
}

DEV bool fe_eq(const fe &a, const fe &b) {
  fe t;
  fe_sub(t, a, b);
  return fe_is_zero(t);
}

DEV void fe_select(fe &o, bool m, const fe &a, const fe &b) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = m ? a.v[i] : b.v[i];
}

// raw 255-bit value of 32 little-endian bytes (bit 255 dropped, no
// reduction: ZIP-215 accepts y >= p)
DEV void fe_frombytes(fe &out, const uint8_t *s) {
  uint64_t w[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint64_t x = 0;
#pragma unroll
    for (int b = 7; b >= 0; b--) x = (x << 8) | s[8 * k + b];
    w[k] = x;
  }
  w[3] &= 0x7fffffffffffffffULL;
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int wd = limb_width(i);
    const int q = off[i] >> 6, r = off[i] & 63;
    uint64_t x = w[q] >> r;
    if (r + wd > 64) x |= w[q + 1] << (64 - r);
    out.v[i] = (int32_t)(x & ((uint64_t(1) << wd) - 1));
  }
}

DEV_NOINLINE void fe_pow22523(fe &out, const fe &z) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_40_0, z_50_0, z_100_0,
      z_200_0, z_250_0;
  fe_sq(z2, z);
  fe_sq(t, z2);
  fe_sq(t, t);
  fe_mul(z9, z, t);
  fe_mul(z11, z2, z9);
  fe_sq(t, z11);
  fe_mul(z_5_0, z9, t);
  t = z_5_0;
  for (int i = 0; i < 5; i++) fe_sq(t, t);
  fe_mul(z_10_0, t, z_5_0);
  t = z_10_0;
  for (int i = 0; i < 10; i++) fe_sq(t, t);
  fe_mul(z_20_0, t, z_10_0);
  t = z_20_0;
  for (int i = 0; i < 20; i++) fe_sq(t, t);
  fe_mul(z_40_0, t, z_20_0);
  t = z_40_0;
  for (int i = 0; i < 10; i++) fe_sq(t, t);
  fe_mul(z_50_0, t, z_10_0);
  t = z_50_0;
  for (int i = 0; i < 50; i++) fe_sq(t, t);
  fe_mul(z_100_0, t, z_50_0);
  t = z_100_0;
  for (int i = 0; i < 100; i++) fe_sq(t, t);
  fe_mul(z_200_0, t, z_100_0);
  t = z_200_0;
  for (int i = 0; i < 50; i++) fe_sq(t, t);
  fe_mul(z_250_0, t, z_50_0);
  t = z_250_0;
  for (int i = 0; i < 2; i++) fe_sq(t, t);
  fe_mul(out, t, z);
}

// x with x^2 = u / v; returns whether a root exists (ops/fe.py:sqrt_ratio)
DEV_NOINLINE bool fe_sqrt_ratio(fe &x, const fe &u, const fe &v) {
  fe v2, v3, uv3, v4, uv7, p, r, vxx, x2, nu, sm1, t;
  fe_sq(v2, v);
  fe_mul(v3, v2, v);
  fe_mul(uv3, u, v3);
  fe_sq(v4, v2);
  fe_mul(uv7, uv3, v4);
  fe_pow22523(p, uv7);
  fe_mul(r, uv3, p);
  fe_sq(x2, r);
  fe_mul(vxx, v, x2);
  const bool ok_direct = fe_eq(vxx, u);
  fe_neg(nu, u);
  const bool ok_flip = fe_eq(vxx, nu);
  fe_const(sm1, FE_SQRTM1);
  fe_mul(t, r, sm1);
  fe_select(x, ok_direct, r, t);
  return ok_direct || ok_flip;
}

// ------------------------------------------------------------------ group

struct ge_ext {
  fe x, y, z, t;
};
struct ge_cached {
  fe ypx, ymx, z2, t2d;
};
struct ge_niels {
  fe ypx, ymx, t2d;
};

DEV void ge_identity(ge_ext &p) {
  fe_set_small(p.x, 0);
  fe_set_small(p.y, 1);
  fe_set_small(p.z, 1);
  fe_set_small(p.t, 0);
}

DEV_NOINLINE void ge_cache(ge_cached &c, const ge_ext &p) {
  fe d2;
  fe_const(d2, FE_D2);
  ge_cached r;
  fe_add(r.ypx, p.y, p.x);
  fe_sub(r.ymx, p.y, p.x);
  fe_add(r.z2, p.z, p.z);
  fe_mul(r.t2d, p.t, d2);
  c = r;
}

DEV void ge_neg(ge_ext &o, const ge_ext &p) {
  fe_neg(o.x, p.x);
  o.y = p.y;
  o.z = p.z;
  fe_neg(o.t, p.t);
}

DEV_NOINLINE void ge_dbl(ge_ext &o, const ge_ext &p) {
  fe a, b, zz, c, h, e, g, ff, xy, t;
  fe_sq(a, p.x);
  fe_sq(b, p.y);
  fe_sq(zz, p.z);
  fe_add(c, zz, zz);
  fe_add(h, a, b);
  fe_add(xy, p.x, p.y);
  fe_sq(t, xy);
  fe_sub(e, h, t);
  fe_sub(g, a, b);
  fe_add(ff, c, g);
  fe_mul(o.x, e, ff);
  fe_mul(o.y, g, h);
  fe_mul(o.z, ff, g);
  fe_mul(o.t, e, h);
}

DEV void ge_finish(ge_ext &o, const fe &a, const fe &b, const fe &c,
                   const fe &d) {
  fe e, ff, g, h;
  fe_sub(e, b, a);
  fe_sub(ff, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(o.x, e, ff);
  fe_mul(o.y, g, h);
  fe_mul(o.z, ff, g);
  fe_mul(o.t, e, h);
}

DEV_NOINLINE void ge_add_cached(ge_ext &o, const ge_ext &p,
                                const ge_cached &q) {
  fe a, b, c, d, t;
  fe_sub(t, p.y, p.x);
  fe_mul(a, t, q.ymx);
  fe_add(t, p.y, p.x);
  fe_mul(b, t, q.ypx);
  fe_mul(c, p.t, q.t2d);
  fe_mul(d, p.z, q.z2);
  ge_finish(o, a, b, c, d);
}

DEV_NOINLINE void ge_add_niels(ge_ext &o, const ge_ext &p,
                               const ge_niels &q) {
  fe a, b, c, d, t;
  fe_sub(t, p.y, p.x);
  fe_mul(a, t, q.ymx);
  fe_add(t, p.y, p.x);
  fe_mul(b, t, q.ypx);
  fe_mul(c, p.t, q.t2d);
  fe_add(d, p.z, p.z);
  ge_finish(o, a, b, c, d);
}

// cached + cached -> cached (ops/group.py:add_cc); complete, so identity
// operands are fine
DEV_NOINLINE void ge_add_cc(ge_cached &o, const ge_cached &p,
                            const ge_cached &q) {
  fe a, b, c, d, t, k;
  fe_mul(a, p.ymx, q.ymx);
  fe_mul(b, p.ypx, q.ypx);
  fe_mul(t, p.t2d, q.t2d);
  fe_const(k, FE_INV2D);
  fe_mul(c, t, k);
  fe_mul(t, p.z2, q.z2);
  fe_const(k, FE_INV2);
  fe_mul(d, t, k);
  ge_ext r;
  ge_finish(r, a, b, c, d);
  ge_cache(o, r);
}

// ZIP-215 decoding: y >= p accepted, x = 0 with the sign bit accepted,
// small and mixed order accepted; only a non-square x^2 fails
DEV_NOINLINE bool ge_decompress_zip215(ge_ext &p, const uint8_t *enc) {
  const int sign = enc[31] >> 7;
  fe y, yy, one, u, v, dd, x, xf, nx;
  fe_frombytes(y, enc);
  fe_set_small(one, 1);
  fe_sq(yy, y);
  fe_sub(u, yy, one);
  fe_const(dd, FE_D);
  fe_mul(v, yy, dd);
  fe_add(v, v, one);
  const bool ok = fe_sqrt_ratio(x, u, v);
  fe_freeze(xf, x);
  const bool flip = (xf.v[0] & 1) != sign;
  fe_neg(nx, xf);
  fe_select(p.x, flip, nx, xf);
  p.y = y;
  p.z = one;
  fe_mul(p.t, p.x, y);
  return ok;
}

DEV bool ge_is_identity(const ge_ext &p) {
  return fe_is_zero(p.x) && fe_eq(p.y, p.z);
}

DEV void ge_mul_by_cofactor(ge_ext &p) {
  for (int i = 0; i < 3; i++) ge_dbl(p, p);
}

DEV void ge_base_niels(ge_niels &n, int digit) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    n.ypx.v[i] = c_base_niels[digit][0][i];
    n.ymx.v[i] = c_base_niels[digit][1][i];
    n.t2d.v[i] = c_base_niels[digit][2][i];
  }
}

// a table entry is 4 x 10 int32 in the order ypx, ymx, z2, t2d
DEV void ge_load_cached(ge_cached &c, const int32_t *src) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    c.ypx.v[i] = src[i];
    c.ymx.v[i] = src[10 + i];
    c.z2.v[i] = src[20 + i];
    c.t2d.v[i] = src[30 + i];
  }
}

DEV void ge_store_cached(int32_t *dst, const ge_cached &c) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    dst[i] = c.ypx.v[i];
    dst[10 + i] = c.ymx.v[i];
    dst[20 + i] = c.z2.v[i];
    dst[30 + i] = c.t2d.v[i];
  }
}

DEV void ge_identity_cached(ge_cached &c) {
  ge_ext id;
  ge_identity(id);
  ge_cache(c, id);
}

// the 16-entry table [j](-P), j = 0..15, written as 16 x 40 int32
// (ops/ed25519.py:_build_neg_table)
DEV_NOINLINE void ge_write_neg_table(int32_t *dst, const ge_ext &p) {
  ge_ext np, acc;
  ge_neg(np, p);
  ge_cached c1, c;
  ge_identity_cached(c);
  ge_store_cached(dst, c);
  ge_cache(c1, np);
  ge_store_cached(dst + 40, c1);
  ge_dbl(acc, np);
  ge_cache(c, acc);
  ge_store_cached(dst + 80, c);
  for (int j = 3; j < 16; j++) {
    ge_add_cached(acc, acc, c1);
    ge_cache(c, acc);
    ge_store_cached(dst + 40 * j, c);
  }
}

// ----------------------------------------------------------------- sha512

DEV uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// SHA-512 over the first `active` of this lane's host-padded blocks
// (32 big-endian 32-bit words each) -> 64 digest bytes
DEV_NOINLINE void sha512_lane(uint8_t out[64], const uint32_t *blocks,
                              int active) {
  uint64_t st[8];
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = c_sha512_iv[i];
  for (int blk = 0; blk < active; blk++) {
    const uint32_t *wd = blocks + 32 * blk;
    uint64_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++)
      w[i] = ((uint64_t)wd[2 * i] << 32) | (uint64_t)wd[2 * i + 1];
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4],
             f = st[5], g = st[6], h = st[7];
#pragma unroll 16
    for (int t = 0; t < 80; t++) {
      uint64_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        const uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
        const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
        w[t & 15] = wt;
      }
      const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      const uint64_t ch = (e & f) ^ (~e & g);
      const uint64_t t1 = h + S1 + ch + c_sha512_k[t] + wt;
      const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
      const uint64_t t2 = S0 + mj;
      h = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
    st[0] += a;
    st[1] += b;
    st[2] += c;
    st[3] += d;
    st[4] += e;
    st[5] += f;
    st[6] += g;
    st[7] += h;
  }
#pragma unroll
  for (int i = 0; i < 8; i++)
#pragma unroll
    for (int b = 0; b < 8; b++) out[8 * i + b] = (uint8_t)(st[i] >> (56 - 8 * b));
}

// ---------------------------------------------------------------- scalars

#define SC_BITS 21
#define SC_MASK ((int64_t(1) << SC_BITS) - 1)

// nbytes little-endian bytes -> n 21-bit limbs; the last limb takes every
// remaining bit (ops/scalar.py:bytes_to_limbs)
DEV void sc_from_bytes(int64_t *s, int n, const uint8_t *b, int nbytes) {
  for (int i = 0; i < n; i++) {
    const int o = SC_BITS * i;
    const bool last = i == n - 1;
    int end = last ? nbytes : (o + SC_BITS + 7) / 8;
    if (end > nbytes) end = nbytes;
    int64_t acc = 0;
    for (int j = o / 8; j < end; j++) {
      const int sh = 8 * j - o;
      acc |= sh >= 0 ? ((int64_t)b[j] << sh) : ((int64_t)b[j] >> -sh);
    }
    s[i] = last ? acc : (acc & SC_MASK);
  }
}

DEV void sc_fold(int64_t s[24], int k) {
#pragma unroll
  for (int j = 0; j < 6; j++) s[k - 12 + j] += s[k] * c_sc_mu[j];
  s[k] = 0;
}

// carries may be negative: multiply, since a left shift of a negative
// value is undefined in C++17
DEV void sc_carry_round(int64_t s[24], int i) {
  const int64_t c = (s[i] + (int64_t(1) << (SC_BITS - 1))) >> SC_BITS;
  s[i + 1] += c;
  s[i] -= c * (int64_t(1) << SC_BITS);
}

DEV void sc_carry_floor(int64_t s[24], int i) {
  const int64_t c = s[i] >> SC_BITS;
  s[i + 1] += c;
  s[i] -= c * (int64_t(1) << SC_BITS);
}

// ref10 sc_reduce: 24 limbs of a value < 2^512 -> s[0..11] = value mod L
DEV_NOINLINE void sc_reduce(int64_t s[24]) {
  for (int k = 23; k > 17; k--) sc_fold(s, k);
  for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
  for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
  for (int k = 17; k > 11; k--) sc_fold(s, k);
  for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
  for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
  for (int i = 0; i < 12; i++) sc_carry_floor(s, i);
  sc_fold(s, 12);
  for (int i = 0; i < 11; i++) sc_carry_floor(s, i);
}

// sequential floor carry of nonnegative columns into 24 limbs
DEV void sc_normalize(int64_t s[24], const int64_t *cols, int ncols) {
  int64_t c = 0;
  for (int i = 0; i < 24; i++) {
    const int64_t t = (i < ncols ? cols[i] : 0) + c;
    s[i] = t & SC_MASK;
    c = t >> SC_BITS;
  }
}

// 12 reduced limbs -> 32 little-endian bytes
DEV void sc_to_bytes(uint8_t out[32], const int64_t s[12]) {
  for (int k = 0; k < 32; k++) {
    int64_t acc = 0;
    for (int i = 0; i < 12; i++) {
      const int o = SC_BITS * i;
      if (o + SC_BITS <= 8 * k || o >= 8 * k + 8) continue;
      const int sh = o - 8 * k;
      acc |= sh >= 0 ? (s[i] << sh) : (s[i] >> -sh);
    }
    out[k] = (uint8_t)(acc & 255);
  }
}

// 64 digest bytes -> 32 bytes of h mod L
DEV void sc_reduce512_bytes(uint8_t out[32], const uint8_t digest[64]) {
  int64_t s[24];
  sc_from_bytes(s, 24, digest, 64);
  sc_reduce(s);
  sc_to_bytes(out, s);
}

// (x < 2^256 as 32 bytes) * (z < 2^128 as 16 bytes) mod L -> 12 limbs
DEV_NOINLINE void sc_mul_mod_l(int64_t out[12], const uint8_t x32[32],
                               const uint8_t z16[16]) {
  int64_t x[13], z[7], cols[19], s[24];
  sc_from_bytes(x, 13, x32, 32);
  sc_from_bytes(z, 7, z16, 16);
  for (int k = 0; k < 19; k++) cols[k] = 0;
  for (int i = 0; i < 7; i++)
    for (int j = 0; j < 13; j++) cols[i + j] += z[i] * x[j];
  sc_normalize(s, cols, 19);
  sc_reduce(s);
  for (int i = 0; i < 12; i++) out[i] = s[i];
}

// S < L on the raw 32 bytes (ops/scalar.py:lt_l)
DEV bool sc_lt_l(const uint8_t s[32]) {
  for (int i = 31; i >= 0; i--) {
    if (s[i] < c_l_bytes[i]) return true;
    if (s[i] > c_l_bytes[i]) return false;
  }
  return false;
}

DEV int nibble(const uint8_t *b, int w) {
  return (w & 1) ? (b[w >> 1] >> 4) : (b[w >> 1] & 15);
}
