// Ed25519 ZIP-215 device arithmetic shared by the port's CUDA kernels.
//
// Counterpart of cometbft_tpu/ops/{fe_lm,group,sha512,scalar}.py, which
// XLA inlines into the TPU verify programs.  What binds a kernel to its
// plain PyTorch version (cometbft_tpu_torch/ops/{fe,group,ed25519,rlc}.py)
// is its boundary, not its limbs: verdict bytes and digests bit for bit,
// scalars byte for byte, table rows and window sums as field elements mod
// p (rows are stored here in canonical limbs, and any row of limbs below
// 2^26 / 2^25 + 64 in magnitude is read).  Inside, the arithmetic is its
// own:
//
//   field    ref10's representation: 10 signed limbs of 26/25 bits in
//            int32.  A product takes 100 (a square 55) 32 x 32 -> 64-bit
//            products of operands pre-scaled by 2 and 19 as ref10 does,
//            then one chain of rounded carries; add and subtract do not
//            carry.  A product's output is "carried": limbs within
//            2^25 / 2^24 (plus a little on limb 1).  An operand of a
//            product is a sum of at most three carried values, or a
//            boundary row, so every limb stays below 1.65 * 2^26 / 2^25,
//            19 * limb fits int32 and every column fits int64 (ref10's
//            bounds; UBSan checks them in the host build);
//   group    extended twisted-Edwards (a = -1) hwcd-2008 formulas with
//            cached and niels operands, permissive ZIP-215 decoding; every
//            coordinate of an extended point is carried;
//   quad     the same formulas spread over the four threads of a quad
//            (hwcd-2008's 4-way form): each thread holds the whole point,
//            an operation's four products of a round run one per thread
//            and a shuffle gathers them, so a doubling or an addition
//            costs two product latencies instead of eight;
//   sha512   native 64-bit words over host-padded big-endian blocks;
//   scalars  ref10 sc_reduce over 21-bit signed limbs in int64, fully
//            reduced below L.
//
// Every function is inlined and indexes its arrays with constants after
// unrolling, so the kernels keep their points in registers (-Xptxas -v
// reports the stack of each kernel).  No function here is __noinline__;
// one that becomes so must read all of its inputs before it writes an
// output, since nvcc 12.9's front-end optimizer may give a caller's
// dying input and the call's output one stack slot
// (scripts/cuda_stack_slot_probe.py).
//
// The constants (d, 2d, sqrt(-1), 1/2, 1/(2d), the [j]B niels table, the
// [16^w j]B comb, the SHA-512 round constants, the sc_reduce fold digits
// and L) come from the generated header ed25519_consts.h, which
// ops/_build.py writes from the port's Python oracle before compiling.
#pragma once

#include "launch.cuh"

#include "ed25519_consts.h"

// ------------------------------------------------------------------ field

struct fe {
  int32_t v[10];
};

DEV int limb_width(int i) { return (i & 1) ? 25 : 26; }

// one rounded carry out of column i into column i + 1 (9 into 0, times 19)
DEV void carry_step(int64_t h[10], int i) {
  const int wd = limb_width(i);
  const int64_t c = (h[i] + (int64_t(1) << (wd - 1))) >> wd;
  h[i] -= c * (int64_t(1) << wd);
  if (i == 9)
    h[0] += 19 * c;
  else
    h[i + 1] += c;
}

// columns -> carried limbs, ref10's carry order (two interleaved chains,
// 0..5 and 4..9, 0, 1)
DEV void fe_carry64(fe &o, int64_t h[10]) {
  const int order[12] = {0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0};
#pragma unroll
  for (int s = 0; s < 12; s++) carry_step(h, order[s]);
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = (int32_t)h[i];
}

DEV void fe_carry(fe &o, const fe &a) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i];
  fe_carry64(o, h);
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
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = a.v[i] + b.v[i];
}

DEV void fe_sub(fe &o, const fe &a, const fe &b) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = a.v[i] - b.v[i];
}

DEV void fe_neg(fe &o, const fe &a) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = -a.v[i];
}

DEV void fe_load(fe &o, const int32_t *src) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = src[i];
}

// acc += a * b, 32 x 32 -> 64 bits signed: on the card one mad.wide.s32
// (one IMAD.WIDE), where nvcc would otherwise emit an unsigned wide
// product and a sign correction, two instructions
DEV void mac64(int64_t &acc, int32_t a, int32_t b) {
#ifdef __CUDACC__
  asm("mad.wide.s32 %0, %1, %2, %0;" : "+l"(acc) : "r"(a), "r"(b));
#else
  acc += (int64_t)a * b;
#endif
}

// f * g: limb i times limb j lands in column (i + j) mod 10, doubled when
// both limbs are odd (bit-offset mismatch) and times 19 when it wraps past
// 2^255; the doubling rides on f, the 19 on g.
DEV void fe_mul(fe &o, const fe &f, const fe &g) {
  int32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    g19[i] = 19 * g.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      mac64(h[(i + j) % 10], a, b);
    }
  }
  fe_carry64(o, h);
}

// f^2, times 2 when `twice`: the 55 products i <= j, the cross terms
// doubled on the left operand, the odd-odd doubling and the 19 on the
// right one.
DEV void fe_sq_scaled(fe &o, const fe &f, bool twice) {
  int32_t f2[10], f19[10], f38[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f19[i] = 19 * f.v[i];
    f38[i] = (i & 1) ? 38 * f.v[i] : 0;   // used on odd limbs only
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const int32_t a = (i != j) ? f2[i] : f.v[i];
      const bool odd = (i & 1) && (j & 1), wrap = i + j >= 10;
      const int32_t b = wrap ? (odd ? f38[j] : f19[j])
                             : (odd ? f2[j] : f.v[j]);
      mac64(h[(i + j) % 10], a, b);
    }
  }
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] += twice ? h[k] : 0;
  fe_carry64(o, h);
}

DEV void fe_sq(fe &o, const fe &f) { fe_sq_scaled(o, f, false); }

// canonical limbs of the value mod p, from any limbs below 2^30: carry,
// then ref10's fe_tobytes (q = floor(value / p) from the top, subtract
// q p, carry with floors)
DEV void fe_freeze(fe &o, const fe &a) {
  fe t;
  fe_carry(t, a);
  int32_t q = (19 * t.v[9] + (1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; i++) q = (t.v[i] + q) >> limb_width(i);
  t.v[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int32_t c = t.v[i] >> limb_width(i);
    t.v[i] -= c * (1 << limb_width(i));
    t.v[i + 1] += c;
  }
  t.v[9] &= (1 << 25) - 1;
  o = t;
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

// selects by masks, not by ?:, which nvcc may turn into a branch per
// limb, divergent where the condition differs across a warp
DEV void fe_select(fe &o, bool m, const fe &a, const fe &b) {
  const int32_t ma = -(int32_t)m;
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = (a.v[i] & ma) | (b.v[i] & ~ma);
}

// (a, b, c, d)[k] without indexing a register array at run time
DEV void fe_pick4(fe &o, int k, const fe &a, const fe &b, const fe &c,
                  const fe &d) {
  const int32_t m0 = -(int32_t)(k == 0), m1 = -(int32_t)(k == 1),
                m2 = -(int32_t)(k == 2), m3 = -(int32_t)(k == 3);
#pragma unroll
  for (int i = 0; i < 10; i++)
    o.v[i] = (a.v[i] & m0) | (b.v[i] & m1) | (c.v[i] & m2) | (d.v[i] & m3);
}

// raw 255-bit value of 32 little-endian bytes (bit 255 dropped, no
// reduction: ZIP-215 accepts y >= p), carried
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
  fe raw;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int wd = limb_width(i);
    const int q = off[i] >> 6, r = off[i] & 63;
    uint64_t x = w[q] >> r;
    if (r + wd > 64) x |= w[q + 1] << (64 - r);
    raw.v[i] = (int32_t)(x & ((uint64_t(1) << wd) - 1));
  }
  fe_carry(out, raw);
}

DEV void fe_sq_n(fe &t, int n) {
  for (int i = 0; i < n; i++) fe_sq(t, t);
}

// z^((p - 5) / 8), ref10's addition chain
DEV void fe_pow22523(fe &out, const fe &z) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
  fe_sq(z2, z);
  fe_sq(t, z2);
  fe_sq(t, t);
  fe_mul(z9, z, t);
  fe_mul(z11, z2, z9);
  fe_sq(t, z11);
  fe_mul(z_5_0, z9, t);
  t = z_5_0;
  fe_sq_n(t, 5);
  fe_mul(z_10_0, t, z_5_0);
  t = z_10_0;
  fe_sq_n(t, 10);
  fe_mul(z_20_0, t, z_10_0);
  t = z_20_0;
  fe_sq_n(t, 20);
  fe_mul(t, t, z_20_0);
  fe_sq_n(t, 10);
  fe_mul(z_50_0, t, z_10_0);
  t = z_50_0;
  fe_sq_n(t, 50);
  fe_mul(z_100_0, t, z_50_0);
  t = z_100_0;
  fe_sq_n(t, 100);
  fe_mul(t, t, z_100_0);
  fe_sq_n(t, 50);
  fe_mul(t, t, z_50_0);
  fe_sq_n(t, 2);
  fe_mul(out, t, z);
}

// x with x^2 = u / v; returns whether a root exists (ops/fe.py:sqrt_ratio)
DEV bool fe_sqrt_ratio(fe &x, const fe &u, const fe &v) {
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

DEV void ge_cache(ge_cached &c, const ge_ext &p) {
  fe d2;
  fe_const(d2, FE_D2);
  fe_add(c.ypx, p.y, p.x);
  fe_sub(c.ymx, p.y, p.x);
  fe_add(c.z2, p.z, p.z);
  fe_mul(c.t2d, p.t, d2);
}

DEV void ge_neg(ge_ext &o, const ge_ext &p) {
  fe_neg(o.x, p.x);
  o.y = p.y;
  o.z = p.z;
  fe_neg(o.t, p.t);
}

// the outputs of both formulas: (E F, G H, F G, E H)
DEV void ge_finish(ge_ext &o, const fe &e, const fe &f, const fe &g,
                   const fe &h) {
  fe_mul(o.x, e, f);
  fe_mul(o.y, g, h);
  fe_mul(o.z, f, g);
  fe_mul(o.t, e, h);
}

// dbl-2008-hwcd for a = -1, with every one of E, F, G, H negated as in
// ops/group.py:dbl (so the products, and a table's limbs mod p, are the
// plain version's): with A = X^2, B = Y^2, C = 2 Z^2, S = (X + Y)^2 it
// takes H = A + B, G = A - B, E = H - S, F = C + G; every operand is a
// sum of at most three carried values
DEV void ge_dbl_operands(fe &e, fe &f, fe &g, fe &h, const fe &a,
                         const fe &b, const fe &c, const fe &s) {
  fe_add(h, a, b);
  fe_sub(g, a, b);
  fe_sub(e, h, s);
  fe_add(f, c, g);
}

DEV void ge_dbl(ge_ext &o, const ge_ext &p) {
  fe a, b, c, s, xy, e, f, g, h;
  fe_sq(a, p.x);
  fe_sq(b, p.y);
  fe_sq_scaled(c, p.z, true);
  fe_add(xy, p.x, p.y);
  fe_sq(s, xy);
  ge_dbl_operands(e, f, g, h, a, b, c, s);
  ge_finish(o, e, f, g, h);
}

// add-2008-hwcd-3: with A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2),
// C = 2d T1 T2, D = 2 Z1 Z2 it takes E = B - A, F = D - C, G = D + C,
// H = B + A
DEV void ge_add_operands(fe &e, fe &f, fe &g, fe &h, const fe &a,
                         const fe &b, const fe &c, const fe &d) {
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
}

DEV void ge_add(ge_ext &o, const ge_ext &p, const ge_cached &q) {
  fe a, b, c, d, t, e, f, g, h;
  fe_sub(t, p.y, p.x);
  fe_mul(a, t, q.ymx);
  fe_add(t, p.y, p.x);
  fe_mul(b, t, q.ypx);
  fe_mul(c, p.t, q.t2d);
  fe_mul(d, p.z, q.z2);
  ge_add_operands(e, f, g, h, a, b, c, d);
  ge_finish(o, e, f, g, h);
}

DEV void ge_add_niels(ge_ext &o, const ge_ext &p, const ge_niels &q) {
  fe a, b, c, d, t, e, f, g, h;
  fe_sub(t, p.y, p.x);
  fe_mul(a, t, q.ymx);
  fe_add(t, p.y, p.x);
  fe_mul(b, t, q.ypx);
  fe_mul(c, p.t, q.t2d);
  fe_add(d, p.z, p.z);
  ge_add_operands(e, f, g, h, a, b, c, d);
  ge_finish(o, e, f, g, h);
}

// cached + cached -> cached (ops/group.py:add_cc): the add operands
// recovered through the constant factors 1/(2d) and 1/2; complete, so
// identity operands are fine
DEV void ge_add_cc(ge_cached &o, const ge_cached &p, const ge_cached &q) {
  fe a, b, c, d, t, k, e, f, g, h;
  fe_mul(a, p.ymx, q.ymx);
  fe_mul(b, p.ypx, q.ypx);
  fe_mul(t, p.t2d, q.t2d);
  fe_const(k, FE_INV2D);
  fe_mul(c, t, k);
  fe_mul(t, p.z2, q.z2);
  fe_const(k, FE_INV2);
  fe_mul(d, t, k);
  ge_add_operands(e, f, g, h, a, b, c, d);
  ge_ext r;
  ge_finish(r, e, f, g, h);
  ge_cache(o, r);
}

// ZIP-215 decoding: y >= p accepted, x = 0 with the sign bit accepted,
// small and mixed order accepted; only a non-square x^2 fails
DEV bool ge_decompress_zip215(ge_ext &p, const uint8_t *enc) {
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
  fe_select(x, flip, nx, xf);
  fe_carry(p.x, x);
  p.y = y;
  p.z = one;
  fe_mul(p.t, p.x, y);
  return ok;
}

DEV bool ge_is_identity(const ge_ext &p) {
  return fe_is_zero(p.x) && fe_eq(p.y, p.z);
}

DEV void ge_load_niels(ge_niels &n, const int32_t *src) {
  fe_load(n.ypx, src);
  fe_load(n.ymx, src + 10);
  fe_load(n.t2d, src + 20);
}

// a table entry is 4 x 10 int32 in the order ypx, ymx, z2, t2d
DEV void ge_load_cached(ge_cached &c, const int32_t *src) {
  fe_load(c.ypx, src);
  fe_load(c.ymx, src + 10);
  fe_load(c.z2, src + 20);
  fe_load(c.t2d, src + 30);
}

DEV void fe_store(int32_t *dst, const fe &a) {
  fe t;
  fe_freeze(t, a);
#pragma unroll
  for (int i = 0; i < 10; i++) dst[i] = t.v[i];
}

// stores canonical limbs
DEV void ge_store_cached(int32_t *dst, const ge_cached &c) {
  fe_store(dst, c.ypx);
  fe_store(dst + 10, c.ymx);
  fe_store(dst + 20, c.z2);
  fe_store(dst + 30, c.t2d);
}

// ------------------------------------------------------------------- quad
//
// A quad is four consecutive threads (threadIdx.x & ~3); thread k =
// threadIdx.x & 3.  Every thread of the quad holds the same extended
// point.  An operation's first round runs four products, thread k the
// k-th, and gathers them; its second round runs the four output products
// X3 = E F, Y3 = G H, Z3 = F G, T3 = E H, thread k the k-th, and gathers
// those.  All 32 threads of a warp call every quad function together
// (eight quads, each on its own point, or spare quads repeating one):
// the shuffles name the whole warp, since a mask computed per quad makes
// nvcc wrap each shuffle in a convergence loop.

DEV int quad_k() { return threadIdx.x & 3; }

// out[j] = thread j's `mine`, for the four threads of this quad
DEV void fe_gather4(fe out[4], const fe &mine) {
#ifdef __CUDACC__
#pragma unroll
  for (int j = 0; j < 4; j++)
#pragma unroll
    for (int i = 0; i < 10; i++)
      out[j].v[i] = __shfl_sync(0xffffffffu, mine.v[i], j, 4);
#else
  host_quad_gather(out, &mine, sizeof(fe));
#endif
}

DEV void geq_finish(ge_ext &p, int k, const fe &e, const fe &f, const fe &g,
                    const fe &h) {
  fe l, r, m, q[4];
  fe_pick4(l, k, e, g, f, e);
  fe_pick4(r, k, f, h, g, h);
  fe_mul(m, l, r);
  fe_gather4(q, m);
  p.x = q[0];
  p.y = q[1];
  p.z = q[2];
  p.t = q[3];
}

// p = 2 p: thread k squares X, Y, Z (doubled) or X + Y
DEV void geq_dbl(ge_ext &p, int k) {
  fe xy, in, s, q[4], e, f, g, h;
  fe_add(xy, p.x, p.y);
  fe_pick4(in, k, p.x, p.y, p.z, xy);
  fe_sq_scaled(s, in, k == 2);
  fe_gather4(q, s);
  ge_dbl_operands(e, f, g, h, q[0], q[1], q[2], q[3]);
  geq_finish(p, k, e, f, g, h);
}

// p += q, where this thread holds component k of q in the order
// (Y - X, Y + X, 2d T, 2 Z) of a cached point; of a niels point, with the
// constant 2 for 2 Z
DEV void geq_add(ge_ext &p, int k, const fe &qk) {
  fe ypx, ymx, in, m, q[4], e, f, g, h;
  fe_add(ypx, p.y, p.x);
  fe_sub(ymx, p.y, p.x);
  fe_pick4(in, k, ymx, ypx, p.t, p.z);
  fe_mul(m, in, qk);
  fe_gather4(q, m);
  ge_add_operands(e, f, g, h, q[0], q[1], q[2], q[3]);
  geq_finish(p, k, e, f, g, h);
}

// component k of a cached row (ypx, ymx, z2, t2d) for geq_add
DEV void geq_cached_part(fe &o, const int32_t *row, int k) {
  fe_load(o, row + (k == 0 ? 10 : k == 1 ? 0 : k == 2 ? 30 : 20));
}

// component k of a niels row (ypx, ymx, t2d) for geq_add
DEV void geq_niels_part(fe &o, const int32_t *row, int k) {
  fe two;
  fe_set_small(two, 2);
  fe_load(o, row + (k == 0 ? 10 : k == 1 ? 0 : 20));
  fe_select(o, k == 3, two, o);
}

// component k of the cached form of p, held whole: in geq_add's order
// (Y - X, Y + X, 2d T, 2 Z) when `add_order`, else in a row's order
// (Y + X, Y - X, 2 Z, 2d T); one product on every thread
DEV void geq_cache_part(fe &o, const ge_ext &p, int k, bool add_order) {
  fe ypx, ymx, one, two, d2, l, r;
  fe_add(ypx, p.y, p.x);
  fe_sub(ymx, p.y, p.x);
  fe_set_small(one, 1);
  fe_set_small(two, 2);
  fe_const(d2, FE_D2);
  if (add_order) {
    fe_pick4(l, k, ymx, ypx, p.t, p.z);
    fe_pick4(r, k, one, one, d2, two);
  } else {
    fe_pick4(l, k, ypx, ymx, p.z, p.t);
    fe_pick4(r, k, one, one, two, d2);
  }
  fe_mul(o, l, r);
}

// the 16-entry table [j](-P), j = 0..15, written as 16 x 40 int32
// (ops/ed25519.py:_build_neg_table: the identity, -P, [2](-P), then 13
// cached additions), computed by a quad: thread k stores component k of
// every entry, where `store` (a spare quad computes and stores nothing)
DEV void geq_write_neg_table(int32_t *dst, const ge_ext &p, int k,
                             bool store) {
  ge_ext acc, id;
  ge_neg(acc, p);
  fe c1, part;
  geq_cache_part(c1, acc, k, true);
  ge_identity(id);
  geq_cache_part(part, id, k, false);
  if (store) fe_store(dst + 10 * k, part);
  geq_cache_part(part, acc, k, false);
  if (store) fe_store(dst + 40 + 10 * k, part);
  geq_dbl(acc, k);
  for (int j = 2; j < 16; j++) {
    if (j > 2) geq_add(acc, k, c1);
    geq_cache_part(part, acc, k, false);
    if (store) fe_store(dst + 40 * j + 10 * k, part);
  }
}

// threads a block of the lane layout (lane_decode_tables): one warp of
// decoders, then the block's 16 quads
#define LANE_THREADS 64

// The lane layout over LPB points a block of LANE_THREADS threads (16:
// a quad a table, the decode on half a warp; 32: a quad writes two
// tables in turn): lane t < n of one warp decodes encoding t of `enc`
// (ZIP-215) into shared memory and calls per_point(t, ok) with its
// decode bit, while lane t < n of the other warp calls other(t) (the
// RLC lane stage hashes its lane there, in the decode's shadow); after a
// barrier the block's quads write the n points' tables [j](-P) to `tab`,
// 640 int32 a point, LPB / 16 each in turn (the same count on every
// quad; past the last point, a repeat unstored).  What per_point and
// other leave in shared memory is read after the call.
// Every thread of the block calls it with the same n, 1 <= n <= LPB.
// The decoding warp is warp 0 or 1 by bit 2 of warp 0's slot on the SM
// (%warpid), so that the decoders of the blocks an SM holds spread over
// its four schedulers: a decode is one thread's chain of about 265
// products, and two on one scheduler take half as long again (at 10,000
// points, 313 blocks of 32 on 132 SMs: 0.173 ms against 0.198 with warp
// 0 always; chip_smoke.py:table_checks).  The host build takes the
// block's parity, so that both choices run there.
template <int LPB, class PerPoint, class Other>
DEV void lane_decode_tables(const uint8_t *enc, int n, int32_t *tab,
                            PerPoint per_point, Other other) {
  __shared__ int32_t sh[LPB][40];
  __shared__ int dec_warp;
  const int tid = threadIdx.x;
  if (tid == 0) {
#ifdef __CUDACC__
    unsigned slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    dec_warp = (slot >> 2) & 1;
#else
    dec_warp = blockIdx.x & 1;
#endif
  }
  __syncthreads();
  const int t = tid - 32 * dec_warp;
  if (t >= 0 && t < n) {
    ge_ext p;
    const bool ok = ge_decompress_zip215(p, enc + (size_t)t * 32);
#pragma unroll
    for (int i = 0; i < 10; i++) {
      sh[t][i] = p.x.v[i];
      sh[t][10 + i] = p.y.v[i];
      sh[t][20 + i] = p.z.v[i];
      sh[t][30 + i] = p.t.v[i];
    }
    per_point(t, ok);
  }
  const int u = tid - 32 * (1 - dec_warp);
  if (u >= 0 && u < n) other(u);
  __syncthreads();
  const int k = quad_k();
  for (int j = tid >> 2; j < LPB; j += LANE_THREADS / 4) {
    const int l = j < n ? j : n - 1;
    ge_ext p;
    fe_load(p.x, sh[l]);
    fe_load(p.y, sh[l] + 10);
    fe_load(p.z, sh[l] + 20);
    fe_load(p.t, sh[l] + 30);
    geq_write_neg_table(tab + (size_t)l * 640, p, k, j < n);
  }
}

// ----------------------------------------------------------------- sha512

DEV uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

DEV void sha512_round(uint64_t s[8], int r, uint64_t wt) {
  const uint64_t a = s[(8 - r) & 7], b = s[(9 - r) & 7], c = s[(10 - r) & 7],
                 e = s[(12 - r) & 7], f = s[(13 - r) & 7],
                 g = s[(14 - r) & 7], h = s[(15 - r) & 7];
  const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
  const uint64_t ch = (e & f) ^ (~e & g);
  const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
  const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
  const uint64_t t1 = h + S1 + ch + wt;
  // the state rotates by index: h's slot takes the new a, d's the new e
  s[(15 - r) & 7] = t1 + S0 + mj;
  s[(11 - r) & 7] += t1;
}

// SHA-512 over the first `active` of this lane's host-padded blocks
// (32 big-endian 32-bit words each) -> the 8 state words
DEV void sha512_lane(uint64_t st[8], const uint32_t *blocks, int active) {
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = c_sha512_iv[i];
  for (int blk = 0; blk < active; blk++) {
    const uint32_t *wd = blocks + 32 * blk;
    uint64_t w[16], s[8];
#pragma unroll
    for (int i = 0; i < 8; i++) s[i] = st[i];
#pragma unroll
    for (int i = 0; i < 16; i++) {
      w[i] = ((uint64_t)wd[2 * i] << 32) | (uint64_t)wd[2 * i + 1];
      sha512_round(s, i & 7, w[i] + c_sha512_k[i]);
    }
    for (int m = 1; m < 5; m++) {
#pragma unroll
      for (int u = 0; u < 16; u++) {
        const uint64_t w15 = w[(u + 1) & 15], w2 = w[(u + 14) & 15];
        const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        w[u] += s0 + w[(u + 9) & 15] + s1;
        sha512_round(s, u & 7, w[u] + c_sha512_k[16 * m + u]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] += s[i];
  }
}

// ---------------------------------------------------------------- scalars

#define SC_BITS 21
#define SC_MASK ((int64_t(1) << SC_BITS) - 1)

// 64-bit little-endian words -> N 21-bit limbs; the last limb takes
// every remaining bit of the NW words
template <int N, int NW>
DEV void sc_from_words(int64_t s[N], const uint64_t w[NW]) {
#pragma unroll
  for (int i = 0; i < N; i++) {
    const int o = SC_BITS * i, q = o >> 6, r = o & 63;
    uint64_t x = w[q] >> r;
    if (r > 0 && q + 1 < NW) x |= w[q + 1] << (64 - r);
    const bool last = i == N - 1;
    s[i] = last ? (int64_t)x : (int64_t)(x & SC_MASK);
  }
}

// NB little-endian bytes -> 64-bit words
template <int NB>
DEV void words_from_bytes(uint64_t w[NB / 8], const uint8_t *b) {
#pragma unroll
  for (int k = 0; k < NB / 8; k++) {
    uint64_t x = 0;
#pragma unroll
    for (int j = 7; j >= 0; j--) x = (x << 8) | b[8 * k + j];
    w[k] = x;
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
DEV void sc_reduce(int64_t s[24]) {
#pragma unroll
  for (int k = 23; k > 17; k--) sc_fold(s, k);
#pragma unroll
  for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int k = 17; k > 11; k--) sc_fold(s, k);
#pragma unroll
  for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i < 12; i++) sc_carry_floor(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i < 11; i++) sc_carry_floor(s, i);
}

// sequential floor carry of NCOLS nonnegative columns into 24 limbs
template <int NCOLS>
DEV void sc_normalize(int64_t s[24], const int64_t *cols) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 24; i++) {
    const int64_t t = (i < NCOLS ? cols[i] : 0) + c;
    s[i] = t & SC_MASK;
    c = t >> SC_BITS;
  }
}

// 12 reduced limbs -> 32 little-endian bytes
DEV void sc_to_bytes(uint8_t *out, const int64_t s[12]) {
#pragma unroll
  for (int k = 0; k < 32; k++) {
    int64_t acc = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
      const int o = SC_BITS * i;
      if (o + SC_BITS <= 8 * k || o >= 8 * k + 8) continue;
      const int sh = o - 8 * k;
      acc |= sh >= 0 ? (s[i] << sh) : (s[i] >> -sh);
    }
    out[k] = (uint8_t)(acc & 255);
  }
}

DEV uint64_t bswap64(uint64_t x) {
  uint64_t y = 0;
#pragma unroll
  for (int b = 0; b < 8; b++) y = (y << 8) | ((x >> (8 * b)) & 255);
  return y;
}

// a SHA-512 state (big-endian digest words) -> 32 bytes of h mod L
DEV void sc_reduce_digest(uint8_t *out, const uint64_t st[8]) {
  uint64_t w[8];
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = bswap64(st[i]);
  int64_t s[24];
  sc_from_words<24, 8>(s, w);
  sc_reduce(s);
  sc_to_bytes(out, s);
}

// (x < 2^256 as 32 bytes) * (z < 2^128 as 16 bytes) mod L -> 12 limbs
DEV void sc_mul_mod_l(int64_t out[12], const uint8_t *x32,
                      const uint8_t *z16) {
  uint64_t xw[4], zw[2];
  words_from_bytes<32>(xw, x32);
  words_from_bytes<16>(zw, z16);
  int64_t x[13], z[7], cols[19], s[24];
  sc_from_words<13, 4>(x, xw);
  sc_from_words<7, 2>(z, zw);
#pragma unroll
  for (int k = 0; k < 19; k++) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++)
#pragma unroll
    for (int j = 0; j < 13; j++) cols[i + j] += z[i] * x[j];
  sc_normalize<19>(s, cols);
  sc_reduce(s);
#pragma unroll
  for (int i = 0; i < 12; i++) out[i] = s[i];
}

// S < L on the raw 32 bytes (ops/scalar.py:lt_l)
DEV bool sc_lt_l(const uint8_t *s) {
  for (int i = 31; i >= 0; i--) {
    if (s[i] < c_l_bytes[i]) return true;
    if (s[i] > c_l_bytes[i]) return false;
  }
  return false;
}

DEV int nibble(const uint8_t *b, int w) {
  return (w & 1) ? (b[w >> 1] >> 4) : (b[w >> 1] & 15);
}
