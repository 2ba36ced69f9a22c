// ed25519_rlc: random-linear-combination verdicts for a batch, through a
// cached validator-set table, on one device or over a set of shards.
//
// Replaces cometbft_tpu/ops/rlc.py:221 verify_batch_rlc_gather (with
// _rlc_sums :136, _tree_reduce_lanes :109, _rlc_ladder :170) and
// :232 make_verify_batch_rlc_sharded (with _combine :290).  The batch
// passes iff
//     [8]( [sum z_i s_i] B - sum [z_i h_i] A_i - sum [z_i] R_i ) == O
// and every active lane decodes with S < L.  The TPU program runs all of
// it as one sequential grid; here blocks run in any order and share
// nothing, so the work is a series of launches on one stream:
//   1. rlc_lane: per lane, one thread of one warp decodes R, while one
//      thread of the block's other warp hashes the lane (h = SHA-512(R ||
//      A || M) mod L over its active host-padded blocks, the
//      sha512_scalar kernel's device code) and computes z*h and z*s mod
//      L and the lane's scalar checks; after the barrier a thread per lane
//      writes the lane-ok bit (padding lanes, z = 0, never veto), and the
//      block's 16 quads (ed25519.cuh) write the lanes' [j](-R) tables.
//      h never leaves the thread.  A block of 64 threads takes LPB lanes:
//      32 (a quad writes two tables in turn) where there are enough lanes
//      to fill the card, 16 (a quad a table, the decode on half a warp)
//      where there are not, chosen by the caller from the lane count;
//   2. rlc_window_partials: per (window, block of at most 1,024 lanes of
//      one shard), each thread adds up to 8 lanes' table entries for their
//      digits into an extended point (8 products an addition), then a tree
//      over the threads (64 A windows from z*h digits, 32 R windows from
//      the 128-bit z digits).  A shard's lanes split into equal blocks,
//      and no block straddles two shards;
//   3. rlc_fold: per (window, shard), one block adds up the shard's block
//      partials the same way and writes the window sum into the shard's
//      slot;
//   4. rlc_zs_sum: per shard, one block sums z*s mod L and ANDs the
//      lane-ok bits into the shard's slot;
//   5. rlc_comb: [sum z s]B by the fixed-base comb, 64 threads each
//      loading one entry [16^w d_w]B of the generated table, then a tree;
//   6. rlc_ladder: 32 threads add R window w into A window w, then a
//      quad (ed25519.cuh; one warp of them, each the same chain) runs the
//      Horner chain over the 64 windows, adds the comb's point and runs
//      the cofactored identity test.
// ed25519_rlc_gather_launch runs 1-6 on one device, as one shard.  The
// sharded verdict (K7) runs 1-4 once per card, ed25519_rlc_sums_launch,
// over all of that card's lanes and shards (the shards a device set names
// on that card, RLC_MAX_SHARDS of them a pass), each shard writing its 96
// window sums, its sum z*s mod L and its ok byte into its slot of stacked
// outputs; then
// ed25519_rlc_combine_launch runs one block of rlc_combine_ladder: 96
// threads each fold one window's D partials with add_cc in shard order,
// one thread sums the D scalars mod L and ANDs the oks, then 5 and 6 in
// the same block.  An empty shard has no partial blocks, and 3-4 write
// the identity, 0 and 1.
// Bound: 32-bit integer multiplies (a wide product costs a warp about 8
// issue cycles), dominated by stage 1's R decode and table (~300 field
// multiplications per lane) and stage 2's 96 additions per lane.  Stage 1
// is a serial chain per lane (the decode's ~265 products, then the
// table): at a few thousand lanes the card holds fewer warps than it has
// schedulers, so the stage takes one chain, and a quad a table shortens
// it.  The verdict's latency floor is stage 6's chain, 255 doublings and
// 64 additions of two product latencies each on the quad.
#include "ed25519.cuh"

#define RLC_THREADS 128
#define RLC_LANES_PER_THREAD 8
#define RLC_BLOCK_LANES (RLC_THREADS * RLC_LANES_PER_THREAD)
#define RLC_WINDOWS 96
#define RLC_COMB_THREADS 64
#ifndef RLC_MAX_SHARDS
#define RLC_MAX_SHARDS 64  // shards a pass of ed25519_rlc_sums_launch
#endif

// The shards of one card's lanes, passed by value: shard i holds lanes
// [lo[i], lo[i + 1]) and partial blocks [blk[i], blk[i + 1]) of stage 2,
// and writes slot slot[i] of the stacked outputs.
struct RlcShards {
  int n;
  int lo[RLC_MAX_SHARDS + 1];
  int blk[RLC_MAX_SHARDS + 1];
  int slot[RLC_MAX_SHARDS];
};

// LPB lanes a block (lane_decode_tables): a warp's lanes [0, LPB) decode
// R, the other warp's lanes hash theirs and take their scalars and
// checks (the hash reads only blocks [0, min(max(active, 0), NB))), then
// a thread per lane writes its lane-ok bit and the 16 quads write the
// LPB tables, LPB / 16 each
template <int LPB>
__global__ void BOUNDS(LANE_THREADS) rlc_lane_kernel(
    const uint8_t *__restrict__ ok_a, const int32_t *__restrict__ idx,
    const uint8_t *__restrict__ rb, const uint8_t *__restrict__ sb,
    const uint32_t *__restrict__ blocks, const int32_t *__restrict__ active,
    int NB, const uint8_t *__restrict__ z, int B,
    int32_t *__restrict__ rtab, uint8_t *__restrict__ zh,
    int32_t *__restrict__ zs, uint8_t *__restrict__ lane_ok) {
  // per lane: R decodes; A's row decodes and S < L; z = 0 (padding)
  __shared__ uint8_t ok_r[LPB], ok_as[LPB], pad[LPB];
  const int lo = blockIdx.x * LPB;
  const int n = B - lo < LPB ? B - lo : LPB;
  lane_decode_tables<LPB>(
      rb + (size_t)lo * 32, n, rtab + (size_t)lo * 640,
      [&](int t, bool ok) { ok_r[t] = ok; },
      [&](int t) {
        const int b = lo + t;
        const uint8_t *zb = z + (size_t)b * 16;
        const uint8_t *s = sb + (size_t)b * 32;
        const int a = active[b];
        uint64_t st[8];
        sha512_lane(st, blocks + (size_t)b * NB * 32,
                    a < 0 ? 0 : (a > NB ? NB : a));
        uint8_t h[32];
        sc_reduce_digest(h, st);
        int64_t acc[12];
        sc_mul_mod_l(acc, h, zb);
        sc_to_bytes(zh + (size_t)b * 32, acc);
        sc_mul_mod_l(acc, s, zb);
#pragma unroll
        for (int i = 0; i < 12; i++) zs[(size_t)b * 12 + i] = (int32_t)acc[i];
        bool live = false;
        for (int i = 0; i < 16; i++) live |= zb[i] != 0;
        ok_as[t] = ok_a[idx[b]] && sc_lt_l(s);
        pad[t] = !live;
      });
  const int t = threadIdx.x;
  if (t < n) lane_ok[lo + t] = ((ok_r[t] && ok_as[t]) || pad[t]) ? 1 : 0;
}

// the points of threads [0, n) of the block (n block-uniform, at most
// blockDim.x), added in a tree: sh[0] ends as the cached sum (the
// identity for n = 0); each level adds a cached point into an extended
// one and caches the result
DEV void tree_sum(ge_ext acc, ge_cached *sh, int n) {
  const int tid = threadIdx.x;
  ge_cached c;
  ge_cache(c, acc);
  if (tid < n || tid == 0) sh[tid] = c;
  int m = 1;
  while (m < n) m <<= 1;
  __syncthreads();
  for (int s = m / 2; s > 0; s >>= 1) {
    if (tid < s && tid + s < n) {
      ge_add(acc, acc, sh[tid + s]);
      ge_cache(c, acc);
      sh[tid] = c;
    }
    __syncthreads();
  }
}

// the partial block blockIdx.x of window blockIdx.y: its shard's lanes
// split into equal blocks of at most RLC_BLOCK_LANES
__global__ void BOUNDS(RLC_THREADS) rlc_window_partials_kernel(
    const int32_t *__restrict__ tab, const int32_t *__restrict__ idx,
    const uint8_t *__restrict__ zh, const int32_t *__restrict__ rtab,
    const uint8_t *__restrict__ z, RlcShards shards,
    int32_t *__restrict__ partials) {
  __shared__ ge_cached sh[RLC_THREADS];
  const int tid = threadIdx.x;
  const int w = blockIdx.y, blk = blockIdx.x;
  int s = 0;
  while (blk >= shards.blk[s + 1]) s++;
  const int hi = shards.lo[s + 1];
  const int nb = shards.blk[s + 1] - shards.blk[s];
  const int chunk = (hi - shards.lo[s] + nb - 1) / nb;
  const int lo = shards.lo[s] + (blk - shards.blk[s]) * chunk;
  const int n = hi - lo < chunk ? hi - lo : chunk;
  ge_ext acc;
  ge_identity(acc);
  for (int lane = lo + tid; lane < lo + n; lane += RLC_THREADS) {
    const int32_t *e;
    if (w < 64)
      e = tab + (size_t)idx[lane] * 640 + 40 * nibble(zh + (size_t)lane * 32, w);
    else
      e = rtab + (size_t)lane * 640 + 40 * nibble(z + (size_t)lane * 16, w - 64);
    ge_cached c;
    ge_load_cached(c, e);
    ge_add(acc, acc, c);
  }
  tree_sum(acc, sh, n < RLC_THREADS ? n : RLC_THREADS);
  if (tid == 0)
    ge_store_cached(partials + ((size_t)w * gridDim.x + blk) * 40, sh[0]);
}

// the cross-block fold: block (w, s) adds up window w's partials of shard
// s (nblk blocks in all) into its slot of sums
__global__ void BOUNDS(RLC_THREADS) rlc_fold_kernel(
    const int32_t *__restrict__ partials, RlcShards shards, int nblk,
    int32_t *__restrict__ sums) {
  __shared__ ge_cached sh[RLC_THREADS];
  const int tid = threadIdx.x;
  const int w = blockIdx.x, s = blockIdx.y;
  const int b0 = shards.blk[s], n = shards.blk[s + 1] - b0;
  ge_ext acc;
  ge_identity(acc);
  for (int j = tid; j < n; j += RLC_THREADS) {
    ge_cached e;
    ge_load_cached(e, partials + ((size_t)w * nblk + b0 + j) * 40);
    ge_add(acc, acc, e);
  }
  tree_sum(acc, sh, n < RLC_THREADS ? n : RLC_THREADS);
  if (tid == 0)
    ge_store_cached(
        sums + ((size_t)shards.slot[s] * RLC_WINDOWS + w) * 40, sh[0]);
}

#define ZS_THREADS 256

// block s: the sum of z*s mod L and the AND of the lane-ok bits of shard
// s, into its slot
__global__ void BOUNDS(ZS_THREADS) rlc_zs_sum_kernel(
    const int32_t *__restrict__ zs, const uint8_t *__restrict__ lane_ok,
    RlcShards shards, uint8_t *__restrict__ zs_sum,
    uint8_t *__restrict__ all_ok) {
  __shared__ int64_t sh[ZS_THREADS][12];
  __shared__ int sh_ok[ZS_THREADS];
  const int tid = threadIdx.x, s = blockIdx.x;
  int64_t acc[12];
#pragma unroll
  for (int i = 0; i < 12; i++) acc[i] = 0;
  int ok = 1;
  for (int b = shards.lo[s] + tid; b < shards.lo[s + 1]; b += ZS_THREADS) {
#pragma unroll
    for (int i = 0; i < 12; i++) acc[i] += zs[(size_t)b * 12 + i];
    ok &= lane_ok[b];
  }
#pragma unroll
  for (int i = 0; i < 12; i++) sh[tid][i] = acc[i];
  sh_ok[tid] = ok;
  __syncthreads();
  for (int m = ZS_THREADS / 2; m > 0; m >>= 1) {
    if (tid < m) {
#pragma unroll
      for (int i = 0; i < 12; i++) sh[tid][i] += sh[tid + m][i];
      sh_ok[tid] &= sh_ok[tid + m];
    }
    __syncthreads();
  }
  if (tid == 0) {
    int64_t s24[24];
    sc_normalize<12>(s24, sh[0]);
    sc_reduce(s24);
    sc_to_bytes(zs_sum + (size_t)shards.slot[s] * 32, s24);
    all_ok[shards.slot[s]] = (uint8_t)sh_ok[0];
  }
}

// [zs_sum]B = sum over the 64 windows w of [16^w d_w]B, thread w loading
// its entry of the comb; every thread of the block calls it, and sh (64
// entries) ends with the cached sum in sh[0]
DEV void rlc_base_comb(const uint8_t *zs_sum, ge_cached *sh) {
  const int w = threadIdx.x;
  ge_ext acc;
  ge_identity(acc);
  if (w < 64) {
    ge_niels e;
    ge_load_niels(e, &c_base_comb[w][nibble(zs_sum, w)][0][0]);
    ge_add_niels(acc, acc, e);
  }
  tree_sum(acc, sh, 64);
}

__global__ void BOUNDS(RLC_COMB_THREADS) rlc_comb_kernel(
    const uint8_t *__restrict__ zs_sum, int32_t *__restrict__ out) {
  __shared__ ge_cached sh[RLC_COMB_THREADS];
  rlc_base_comb(zs_sum, sh);
  if (threadIdx.x == 0) ge_store_cached(out, sh[0]);
}

// the 64 ladder windows from 96 window sums (rows of 40): R window w
// added into A window w below 32, by threads 0..63 of the block
DEV void rlc_add_r_windows(int32_t *win, const int32_t *sums) {
  const int w = threadIdx.x;
  if (w < 64) {
    ge_cached a;
    ge_load_cached(a, sums + (size_t)w * 40);
    if (w < 32) {
      ge_cached r;
      ge_load_cached(r, sums + (size_t)(64 + w) * 40);
      ge_add_cc(a, a, r);
    }
    ge_store_cached(win + w * 40, a);
  }
}

// [8](sum_w 16^w W_w + C) == O over the 64 cached windows W (rows of 40)
// and the cached point C: the Horner chain, 255 doublings and 64
// additions, run by the quads of one warp (each the same chain)
DEV bool rlc_horner_quad(const int32_t *win, const int32_t *comb) {
  const int k = quad_k();
  ge_ext acc;
  ge_identity(acc);
  fe q;
  for (int w = 63; w >= 0; w--) {
    if (w < 63)
      for (int i = 0; i < 4; i++) geq_dbl(acc, k);
    geq_cached_part(q, win + w * 40, k);
    geq_add(acc, k, q);
  }
  geq_cached_part(q, comb, k);
  geq_add(acc, k, q);
  for (int i = 0; i < 3; i++) geq_dbl(acc, k);
  return ge_is_identity(acc);
}

__global__ void BOUNDS(64) rlc_ladder_kernel(
    const int32_t *__restrict__ sums, const int32_t *__restrict__ comb,
    const uint8_t *__restrict__ all_ok, uint8_t *__restrict__ out) {
  __shared__ int32_t win[64 * 40];
  rlc_add_r_windows(win, sums);
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool ok = rlc_horner_quad(win, comb);
    if (threadIdx.x == 0) out[0] = (all_ok[0] && ok) ? 1 : 0;
  }
}

// K7's combine: D shards' (96, 40) window sums, 32-byte sums of z*s mod L
// and ok bytes -> the verdict.  One block of 128 threads: the fold of the
// shards (a thread per window) and the scalar sum, then the comb and the
// ladder of the single-device verdict.
__global__ void BOUNDS(128) rlc_combine_ladder_kernel(
    const int32_t *__restrict__ sums, const uint8_t *__restrict__ zs,
    const uint8_t *__restrict__ ok, int D, uint8_t *__restrict__ out) {
  __shared__ int32_t folded[RLC_WINDOWS * 40];
  __shared__ int32_t win[64 * 40];
  __shared__ ge_cached comb[RLC_COMB_THREADS];
  __shared__ uint8_t zs_sum[32];
  __shared__ int all_ok;
  const int t = threadIdx.x;
  if (t < RLC_WINDOWS) {
    ge_cached acc, e;
    ge_load_cached(acc, sums + (size_t)t * 40);
    for (int d = 1; d < D; d++) {
      ge_load_cached(e, sums + ((size_t)d * RLC_WINDOWS + t) * 40);
      ge_add_cc(acc, acc, e);
    }
    ge_store_cached(folded + t * 40, acc);
  }
  if (t == RLC_WINDOWS) {
    int64_t cols[12], s24[24];
#pragma unroll
    for (int i = 0; i < 12; i++) cols[i] = 0;
    int okv = 1;
    for (int d = 0; d < D; d++) {
      uint64_t w4[4];
      int64_t l12[12];
      words_from_bytes<32>(w4, zs + (size_t)d * 32);
      sc_from_words<12, 4>(l12, w4);
#pragma unroll
      for (int i = 0; i < 12; i++) cols[i] += l12[i];
      okv &= ok[d] != 0;
    }
    sc_normalize<12>(s24, cols);
    sc_reduce(s24);
    sc_to_bytes(zs_sum, s24);
    all_ok = okv;
  }
  __syncthreads();
  rlc_add_r_windows(win, folded);
  rlc_base_comb(zs_sum, comb);
  if (t < 32) {
    const bool v = rlc_horner_quad(win, (const int32_t *)&comb[0]);
    if (t == 0) out[0] = (all_ok && v) ? 1 : 0;
  }
}

// an argument the entries refuse (cudaErrorInvalidValue)
#define RLC_BAD_ARGUMENT 1

// the shards of a card's B lanes from host arrays: lo, S + 1 offsets
// with 0 = lo[0] <= ... <= lo[S] = B, and slot, S slots; false where they
// do not describe shards of the B lanes
static bool rlc_shards(RlcShards &sh, const int *lo, const int *slot, int S,
                       int B) {
  if (S < 1 || S > RLC_MAX_SHARDS || lo[0] != 0 || lo[S] != B) return false;
  sh.n = S;
  sh.blk[0] = 0;
  for (int i = 0; i < S; i++) {
    if (lo[i + 1] < lo[i] || slot[i] < 0) return false;
    sh.lo[i] = lo[i];
    sh.slot[i] = slot[i];
    const int n = lo[i + 1] - lo[i];
    sh.blk[i + 1] = sh.blk[i] + (n + RLC_BLOCK_LANES - 1) / RLC_BLOCK_LANES;
  }
  sh.lo[S] = lo[S];
  return true;
}

// Stages 1-4 over B lanes cut into `shards`, stage 1 at lpb lanes a block
// (16 or 32), each lane hashing its NB host-padded SHA-512 blocks (B, NB,
// 32 words) of which active[b] count.  scratch: rtab B*640 int32, zh
// B*32 u8, zs B*12 int32, lane_ok B u8, partials 96*nblk*40 int32
// (nblk = shards.blk[shards.n]);
// outputs: the stacked sums (D, 96, 40) int32, zs_sum (D, 32) u8 and
// all_ok (D,) u8, of which each shard writes its slot
static int rlc_stages(const void *tab, const void *ok_a, const void *idx,
                      const void *rb, const void *sb, const void *blocks,
                      const void *active, int NB, const void *z, int B,
                      const RlcShards &shards, int lpb, void *rtab, void *zh,
                      void *zs, void *lane_ok, void *partials, void *sums,
                      void *zs_sum, void *all_ok, void *stream) {
  int err;
  if (B > 0) {
    const int grid = (B + lpb - 1) / lpb;
#define RLC_LANE_LAUNCH(LPB)                                                 \
  LAUNCH(rlc_lane_kernel<LPB>, grid, LANE_THREADS, stream,                   \
         (const uint8_t *)ok_a, (const int32_t *)idx, (const uint8_t *)rb,   \
         (const uint8_t *)sb, (const uint32_t *)blocks,                      \
         (const int32_t *)active, NB, (const uint8_t *)z, B,                 \
         (int32_t *)rtab, (uint8_t *)zh, (int32_t *)zs, (uint8_t *)lane_ok)
    if (lpb == 16)
      RLC_LANE_LAUNCH(16);
    else if (lpb == 32)
      RLC_LANE_LAUNCH(32);
    else
      return RLC_BAD_ARGUMENT;
#undef RLC_LANE_LAUNCH
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  const int nblk = shards.blk[shards.n];
  if (nblk > 0) {
    LAUNCH(rlc_window_partials_kernel, dim3(nblk, RLC_WINDOWS), RLC_THREADS,
           stream, (const int32_t *)tab, (const int32_t *)idx,
           (const uint8_t *)zh, (const int32_t *)rtab, (const uint8_t *)z,
           shards, (int32_t *)partials);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  LAUNCH(rlc_fold_kernel, dim3(RLC_WINDOWS, shards.n), RLC_THREADS, stream,
         (const int32_t *)partials, shards, nblk, (int32_t *)sums);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  LAUNCH(rlc_zs_sum_kernel, shards.n, ZS_THREADS, stream,
         (const int32_t *)zs, (const uint8_t *)lane_ok, shards,
         (uint8_t *)zs_sum, (uint8_t *)all_ok);
  RETURN_LAUNCH_ERROR();
}

// K7's sums on one card: stages 1-4 over the card's B lanes, which hold S
// shards, shard i the lanes [lo[i], lo[i + 1]) writing slot slot[i] (lo
// and slot are host arrays); scratch and outputs as rlc_stages.  The
// shards go RLC_MAX_SHARDS a pass, each pass over its shards' lanes (the
// passes reuse `partials`, in stream order).
extern "C" int ed25519_rlc_sums_launch(
    const void *tab, const void *ok_a, const void *idx, const void *rb,
    const void *sb, const void *blocks, const void *active, const void *z,
    int B, int NB, const void *lo, const void *slot, int S, int lpb,
    void *rtab, void *zh, void *zs, void *lane_ok, void *partials,
    void *sums, void *zs_sum, void *all_ok, void *stream) {
  const int *lo_ = (const int *)lo, *slot_ = (const int *)slot;
  if (S < 1 || lo_[0] != 0 || lo_[S] != B) return RLC_BAD_ARGUMENT;
  for (int g = 0; g < S; g += RLC_MAX_SHARDS) {
    const int n = S - g < RLC_MAX_SHARDS ? S - g : RLC_MAX_SHARDS;
    const size_t b0 = lo_[g];
    int glo[RLC_MAX_SHARDS + 1];
    for (int i = 0; i <= n; i++) glo[i] = lo_[g + i] - (int)b0;
    RlcShards shards;
    if (!rlc_shards(shards, glo, slot_ + g, n, glo[n]))
      return RLC_BAD_ARGUMENT;
    const int err = rlc_stages(
        tab, ok_a, (const int32_t *)idx + b0, (const uint8_t *)rb + 32 * b0,
        (const uint8_t *)sb + 32 * b0,
        (const uint32_t *)blocks + (size_t)NB * 32 * b0,
        (const int32_t *)active + b0, NB, (const uint8_t *)z + 16 * b0,
        glo[n], shards, lpb, (int32_t *)rtab + 640 * b0,
        (uint8_t *)zh + 32 * b0,
        (int32_t *)zs + 12 * b0, (uint8_t *)lane_ok + b0, partials, sums,
        zs_sum, all_ok, stream);
    if (err != 0) return err;
  }
  return 0;
}

// sums (D, 96, 40) int32, zs (D, 32) u8, ok (D,) u8 -> out 1 u8
extern "C" int ed25519_rlc_combine_launch(const void *sums, const void *zs,
                                          const void *ok, int D, void *out,
                                          void *stream) {
  if (D <= 0) return 0;
  LAUNCH(rlc_combine_ladder_kernel, 1, 128, stream, (const int32_t *)sums,
         (const uint8_t *)zs, (const uint8_t *)ok, D, (uint8_t *)out);
  RETURN_LAUNCH_ERROR();
}

// the single-device verdict: stages 1-4 as one shard in slot 0, then the
// comb and the ladder; scratch and outputs as rlc_stages with D = 1, then
// out 1 u8.  The comb's point (40 int32) goes to the start of `partials`,
// which the fold has read by then.
extern "C" int ed25519_rlc_gather_launch(
    const void *tab, const void *ok_a, const void *idx, const void *rb,
    const void *sb, const void *blocks, const void *active, const void *z,
    int B, int NB, int lpb, void *rtab, void *zh, void *zs, void *lane_ok,
    void *partials, void *sums, void *zs_sum, void *all_ok, void *out,
    void *stream) {
  if (B <= 0) return 0;
  const int lo[2] = {0, B}, slot[1] = {0};
  RlcShards shards;
  rlc_shards(shards, lo, slot, 1, B);
  int err = rlc_stages(tab, ok_a, idx, rb, sb, blocks, active, NB, z, B,
                       shards, lpb, rtab, zh, zs, lane_ok, partials, sums,
                       zs_sum, all_ok, stream);
  if (err != 0) return err;
  LAUNCH(rlc_comb_kernel, 1, RLC_COMB_THREADS, stream,
         (const uint8_t *)zs_sum, (int32_t *)partials);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  LAUNCH(rlc_ladder_kernel, 1, 64, stream, (const int32_t *)sums,
         (const int32_t *)partials, (const uint8_t *)all_ok, (uint8_t *)out);
  RETURN_LAUNCH_ERROR();
}
