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
// nothing, so the work is a series of launches on one stream (h = SHA-512
// mod L comes from the sha512_scalar kernel before these):
//   1. rlc_lane: per lane, decode R and write its [j](-R) table, z*h and
//      z*s mod L, and the lane-ok bit (padding lanes, z = 0, never veto);
//   2. rlc_window_partials: per (window, 128-lane block), gather each
//      lane's table entry for its digit and reduce with an add_cc tree in
//      shared memory (64 A windows from z*h digits, 32 R windows from the
//      128-bit z digits);
//   3. rlc_fold: per window, one block adds up the block partials: each
//      thread its strided share, then the same shared-memory tree;
//   4. rlc_zs_sum: one block sums z*s mod L and ANDs the lane-ok bits;
//   5. rlc_ladder: one thread runs the width-1 ladder over the window sums
//      and the cofactored identity test.
// ed25519_rlc_gather_launch runs 1-5 on one device.  The sharded verdict
// (K7) runs 1-4 once per shard, ed25519_rlc_sums_launch, each writing its
// 96 window sums, its sum z*s mod L and its ok byte into its slot of
// stacked outputs; then ed25519_rlc_combine_launch runs one block of
// rlc_combine_ladder: 96 threads each fold one window's D partials with
// add_cc in shard order, thread 0 sums the D scalars mod L and ANDs the
// oks, then runs stage 5.  An empty shard (B = 0) skips 1-2, and 3-4
// write the identity, 0 and 1.
// Bound: 32-bit integer multiplies, dominated by stage 1's R decode and
// table (~400 field multiplications per lane) and stage 2's ~96 add_cc
// per lane (11 field multiplications each); the combine adds 96 (D - 1)
// add_cc, and the ladder is one thread's serial chain either way.
#include "ed25519.cuh"

#define RLC_THREADS 128
#define RLC_WINDOWS 96

__global__ void rlc_lane_kernel(
    const uint8_t *__restrict__ ok_a, const int32_t *__restrict__ idx,
    const uint8_t *__restrict__ rb, const uint8_t *__restrict__ sb,
    const uint8_t *__restrict__ h, const uint8_t *__restrict__ z, int B,
    int32_t *__restrict__ rtab, uint8_t *__restrict__ zh,
    int32_t *__restrict__ zs, uint8_t *__restrict__ lane_ok) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t *zb = z + (size_t)b * 16;
  const uint8_t *s = sb + (size_t)b * 32;
  bool active = false;
  for (int i = 0; i < 16; i++) active |= zb[i] != 0;
  const bool ok_s = sc_lt_l(s);
  ge_ext r;
  const bool ok_r = ge_decompress_zip215(r, rb + (size_t)b * 32);
  ge_write_neg_table(rtab + (size_t)b * 640, r);
  int64_t t[12];
  sc_mul_mod_l(t, h + (size_t)b * 32, zb);
  sc_to_bytes(zh + (size_t)b * 32, t);
  sc_mul_mod_l(t, s, zb);
  for (int i = 0; i < 12; i++) zs[(size_t)b * 12 + i] = (int32_t)t[i];
  lane_ok[b] = ((ok_a[idx[b]] && ok_r && ok_s) || !active) ? 1 : 0;
}

DEV void tree_reduce_shared(ge_cached *sh) {
  const int tid = threadIdx.x;
  for (int s = RLC_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      ge_cached t;
      ge_add_cc(t, sh[tid], sh[tid + s]);
      sh[tid] = t;
    }
    __syncthreads();
  }
}

__global__ void rlc_window_partials_kernel(
    const int32_t *__restrict__ tab, const int32_t *__restrict__ idx,
    const uint8_t *__restrict__ zh, const int32_t *__restrict__ rtab,
    const uint8_t *__restrict__ z, int B, int32_t *__restrict__ partials) {
  __shared__ ge_cached sh[RLC_THREADS];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * RLC_THREADS + tid;
  const int w = blockIdx.y;
  ge_cached e;
  if (lane < B) {
    if (w < 64) {
      const int d = nibble(zh + (size_t)lane * 32, w);
      ge_load_cached(e, tab + (size_t)idx[lane] * 640 + 40 * d);
    } else {
      const int d = nibble(z + (size_t)lane * 16, w - 64);
      ge_load_cached(e, rtab + (size_t)lane * 640 + 40 * d);
    }
  } else {
    ge_identity_cached(e);
  }
  sh[tid] = e;
  __syncthreads();
  tree_reduce_shared(sh);
  if (tid == 0)
    ge_store_cached(partials + ((size_t)w * gridDim.x + blockIdx.x) * 40,
                    sh[0]);
}

// the cross-block fold: block w adds up window w's n block partials
__global__ void rlc_fold_kernel(const int32_t *__restrict__ partials, int n,
                                int32_t *__restrict__ sums) {
  __shared__ ge_cached sh[RLC_THREADS];
  const int tid = threadIdx.x;
  const int w = blockIdx.x;
  ge_cached acc;
  ge_identity_cached(acc);
  for (int j = tid; j < n; j += RLC_THREADS) {
    ge_cached e;
    ge_load_cached(e, partials + ((size_t)w * n + j) * 40);
    ge_add_cc(acc, acc, e);
  }
  sh[tid] = acc;
  __syncthreads();
  tree_reduce_shared(sh);
  if (tid == 0) ge_store_cached(sums + (size_t)w * 40, sh[0]);
}

#define ZS_THREADS 256

__global__ void rlc_zs_sum_kernel(const int32_t *__restrict__ zs,
                                  const uint8_t *__restrict__ lane_ok, int B,
                                  uint8_t *__restrict__ zs_sum,
                                  uint8_t *__restrict__ all_ok) {
  __shared__ int64_t sh[ZS_THREADS][12];
  __shared__ int sh_ok[ZS_THREADS];
  const int tid = threadIdx.x;
  int64_t acc[12];
  for (int i = 0; i < 12; i++) acc[i] = 0;
  int ok = 1;
  for (int b = tid; b < B; b += ZS_THREADS) {
    for (int i = 0; i < 12; i++) acc[i] += zs[(size_t)b * 12 + i];
    ok &= lane_ok[b];
  }
  for (int i = 0; i < 12; i++) sh[tid][i] = acc[i];
  sh_ok[tid] = ok;
  __syncthreads();
  for (int s = ZS_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int i = 0; i < 12; i++) sh[tid][i] += sh[tid + s][i];
      sh_ok[tid] &= sh_ok[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    int64_t s24[24];
    sc_normalize(s24, sh[0], 12);
    sc_reduce(s24);
    sc_to_bytes(zs_sum, s24);
    all_ok[0] = (uint8_t)sh_ok[0];
  }
}

// stage 5 over window sums in global or shared memory: 64 x 4 doublings,
// one base-niels add and the A (and, below window 32, R) window sums,
// then the cofactored identity test
DEV bool rlc_ladder(const int32_t *sums, const uint8_t *zs_sum) {
  ge_ext acc;
  ge_identity(acc);
  ge_niels bn;
  ge_cached c;
  for (int w = 63; w >= 0; w--) {
    for (int i = 0; i < 4; i++) ge_dbl(acc, acc);
    ge_base_niels(bn, nibble(zs_sum, w));
    ge_add_niels(acc, acc, bn);
    ge_load_cached(c, sums + (size_t)w * 40);
    ge_add_cached(acc, acc, c);
    if (w < 32) {
      ge_load_cached(c, sums + (size_t)(64 + w) * 40);
      ge_add_cached(acc, acc, c);
    }
  }
  ge_mul_by_cofactor(acc);
  return ge_is_identity(acc);
}

__global__ void rlc_ladder_kernel(const int32_t *__restrict__ sums,
                                  const uint8_t *__restrict__ zs_sum,
                                  const uint8_t *__restrict__ all_ok,
                                  uint8_t *__restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  out[0] = (all_ok[0] && rlc_ladder(sums, zs_sum)) ? 1 : 0;
}

// K7's combine: D shards' (96, 40) window sums, 32-byte sums of z*s mod L
// and ok bytes -> the verdict.  One block of RLC_WINDOWS threads.
__global__ void rlc_combine_ladder_kernel(const int32_t *__restrict__ sums,
                                          const uint8_t *__restrict__ zs,
                                          const uint8_t *__restrict__ ok,
                                          int D, uint8_t *__restrict__ out) {
  __shared__ int32_t sh[RLC_WINDOWS * 40];
  __shared__ uint8_t zs_sum[32];
  __shared__ int all_ok;
  const int w = threadIdx.x;
  if (w < RLC_WINDOWS) {
    ge_cached acc, e;
    ge_load_cached(acc, sums + (size_t)w * 40);
    for (int d = 1; d < D; d++) {
      ge_load_cached(e, sums + ((size_t)d * RLC_WINDOWS + w) * 40);
      ge_add_cc(acc, acc, e);
    }
    ge_store_cached(sh + w * 40, acc);
  }
  if (w == 0) {
    int64_t cols[12], t[12], s24[24];
    for (int i = 0; i < 12; i++) cols[i] = 0;
    int okv = 1;
    for (int d = 0; d < D; d++) {
      sc_from_bytes(t, 12, zs + (size_t)d * 32, 32);
      for (int i = 0; i < 12; i++) cols[i] += t[i];
      okv &= ok[d] != 0;
    }
    sc_normalize(s24, cols, 12);
    sc_reduce(s24);
    sc_to_bytes(zs_sum, s24);
    all_ok = okv;
  }
  __syncthreads();
  if (w == 0) out[0] = (all_ok && rlc_ladder(sh, zs_sum)) ? 1 : 0;
}

// Stages 1-4 for one batch or shard.  scratch: rtab B*640 int32, zh B*32
// u8, zs B*12 int32, lane_ok B u8, partials 96*ceil(B/128)*40 int32;
// outputs: sums 96*40 int32, zs_sum 32 u8, all_ok 1 u8 (a shard's slot of
// the stacked outputs)
extern "C" int ed25519_rlc_sums_launch(
    const void *tab, const void *ok_a, const void *idx, const void *rb,
    const void *sb, const void *h, const void *z, int B, void *rtab,
    void *zh, void *zs, void *lane_ok, void *partials, void *sums,
    void *zs_sum, void *all_ok, void *stream) {
  if (B < 0) return 0;
  const int nblk = (B + RLC_THREADS - 1) / RLC_THREADS;
  int err;
  if (B > 0) {
    LAUNCH(rlc_lane_kernel, nblk, RLC_THREADS, stream, (const uint8_t *)ok_a,
           (const int32_t *)idx, (const uint8_t *)rb, (const uint8_t *)sb,
           (const uint8_t *)h, (const uint8_t *)z, B, (int32_t *)rtab,
           (uint8_t *)zh, (int32_t *)zs, (uint8_t *)lane_ok);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    LAUNCH(rlc_window_partials_kernel, dim3(nblk, RLC_WINDOWS), RLC_THREADS,
           stream, (const int32_t *)tab, (const int32_t *)idx,
           (const uint8_t *)zh, (const int32_t *)rtab, (const uint8_t *)z,
           B, (int32_t *)partials);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  LAUNCH(rlc_fold_kernel, RLC_WINDOWS, RLC_THREADS, stream,
         (const int32_t *)partials, nblk, (int32_t *)sums);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  LAUNCH(rlc_zs_sum_kernel, 1, ZS_THREADS, stream, (const int32_t *)zs,
         (const uint8_t *)lane_ok, B, (uint8_t *)zs_sum, (uint8_t *)all_ok);
  RETURN_LAUNCH_ERROR();
}

// sums (D, 96, 40) int32, zs (D, 32) u8, ok (D,) u8 -> out 1 u8
extern "C" int ed25519_rlc_combine_launch(const void *sums, const void *zs,
                                          const void *ok, int D, void *out,
                                          void *stream) {
  if (D <= 0) return 0;
  LAUNCH(rlc_combine_ladder_kernel, 1, RLC_WINDOWS, stream,
         (const int32_t *)sums, (const uint8_t *)zs, (const uint8_t *)ok, D,
         (uint8_t *)out);
  RETURN_LAUNCH_ERROR();
}

// the single-device verdict: stages 1-4, then the ladder; scratch and
// outputs as ed25519_rlc_sums_launch, then out 1 u8
extern "C" int ed25519_rlc_gather_launch(
    const void *tab, const void *ok_a, const void *idx, const void *rb,
    const void *sb, const void *h, const void *z, int B, void *rtab,
    void *zh, void *zs, void *lane_ok, void *partials, void *sums,
    void *zs_sum, void *all_ok, void *out, void *stream) {
  if (B <= 0) return 0;
  int err = ed25519_rlc_sums_launch(tab, ok_a, idx, rb, sb, h, z, B, rtab,
                                    zh, zs, lane_ok, partials, sums, zs_sum,
                                    all_ok, stream);
  if (err != 0) return err;
  LAUNCH(rlc_ladder_kernel, 1, 1, stream, (const int32_t *)sums,
         (const uint8_t *)zs_sum, (const uint8_t *)all_ok, (uint8_t *)out);
  RETURN_LAUNCH_ERROR();
}
