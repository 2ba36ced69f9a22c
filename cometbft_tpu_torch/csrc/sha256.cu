// sha256_leaves, merkle_tree and merkle_level: the SHA-256 kernels of the
// merkle tree.
//
// Replace the two TPU programs of cometbft_tpu/ops/sha256.py that the
// merkle tree (crypto/merkle.py) runs at 2,048 leaves or more:
//
//   sha256_leaves  <- :115 sha256_blocks, the digests of host-padded
//                     leaves (B, NB, 16) big-endian words with a per-lane
//                     active-block count; writes 8 digest words per lane
//                     (the wrapper splits them into the JAX package's 32
//                     digest bytes where a caller asks for bytes);
//   merkle_tree    <- :135 merkle_inner_level applied level after level
//                     (cometbft_tpu/crypto/merkle.py:265): every level
//                     above the leaves, SHA-256(0x01 || left || right) per
//                     parent, in one C call;
//   merkle_tree_leaves <- :115 sha256_blocks over the leaves, then the
//                     levels of merkle_tree, in one C call whose first
//                     launch hashes the leaves straight into the shared
//                     memory its subtrees are built in (the tree's route
//                     from 2,048 leaves);
//   merkle_level   <- :135 merkle_inner_level, one level, the same kernel.
//
// Bound on the H100: 32-bit integer instructions.  sm_90 has 3-input
// logic (LOP3) and 3-input adds (IADD3), and a rotate is one funnel
// shift, so a round is about 14 instructions (Sigma0 and Sigma1 4 each,
// Ch and Maj 1 each, 4 adds) and a schedule step about 10 (sigma0 and
// sigma1 4 each, 2 adds): some 1,384 per compression for 64 bytes read,
// which take about 4x as long on the card's 16.7 T integer lanes per
// second as the bytes take at its 3.35 TB/s.  At the merkle tree's sizes
// (10,000 leaves, levels of 5,000 down to 1 parent) the kernels are far
// below a full card: a tree's floor is its chain of levels, two
// compressions each, one after another.
//
// Design: one thread per lane (sha256_leaves) or per parent, native
// uint32_t words, rotates by __funnelshift_r, round constants in
// __constant__ memory (sha256_consts.h, generated by ops/_build.py from
// ops/sha256.py, the plain versions' source), the round loop fully
// unrolled so the 16-word schedule window stays in registers.  The tree
// was one launch per level (14 for 10,000 leaves, each a Python call);
// now a block of merkle_subtree_kernel keeps an aligned run of 256
// children in shared memory and builds its subtree's 8 levels there with
// a barrier between levels, so a tree of up to 65,536 leaves takes two
// launches of one C call: the blocks' subtrees, then one block over their
// roots.  A parent's two blocks are assembled by shifts from its
// children's 16 words; the second block is the constant padding of a
// 65-byte message (0x80 at byte 1, bit length 520).  An odd tail child is
// promoted unchanged.  merkle_tree_leaves hashes the leaves in the first
// launch itself (a thread a leaf, into the block's run of 256 children),
// writes them to the head of the level buffer, which the proofs read,
// and builds the subtrees on from there, so the leaf digests never make
// a round trip through device memory and the tree is one C call of two
// launches.  active[b] acts as the JAX package's mask (block j counts
// where j < active), so the leaf kernels read only blocks
// [0, min(max(active, 0), NB)).
#include "launch.cuh"
#include "sha256_consts.h"

DEV uint32_t rotr32(uint32_t x, int n) {
#ifdef __CUDACC__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

DEV void sha256_compress(uint32_t s[8], const uint32_t block[16]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = block[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    if (t >= 16) {
      const uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      w[t & 15] += (rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3)) +
                   w[(t + 9) & 15] +
                   (rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10));
    }
    const uint32_t t1 = h + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                        ((e & f) ^ (~e & g)) + c_sha256_k[t] + w[t & 15];
    const uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// the digest of one host-padded leaf: blocks [0, min(max(active, 0), NB))
// of its NB blocks of 16 words
DEV void sha256_leaf(uint32_t s[8], const uint32_t *blocks, int active,
                     int NB) {
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = c_sha256_iv[i];
  const int na = active < 0 ? 0 : (active > NB ? NB : active);
  for (int j = 0; j < na; j++) sha256_compress(s, blocks + (size_t)j * 16);
}

__global__ void sha256_leaves_kernel(const uint32_t *__restrict__ blocks,
                                     const int32_t *__restrict__ active,
                                     int B, int NB,
                                     uint32_t *__restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t s[8];
  sha256_leaf(s, blocks + (size_t)b * NB * 16, active[b], NB);
  uint32_t *o = out + (size_t)b * 8;
#pragma unroll
  for (int i = 0; i < 8; i++) o[i] = s[i];
}

// one RFC-6962 inner node: SHA-256(0x01 || l || r) of two children's
// digest words; the first block is assembled by shifts from the children's
// 16 words, the second is the constant padding of a 65-byte message
DEV void merkle_inner(uint32_t s[8], const uint32_t *l, const uint32_t *r) {
  uint32_t blk[16];
  blk[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; k++) blk[k] = (l[k - 1] << 24) | (l[k] >> 8);
  blk[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; k++) blk[8 + k] = (r[k - 1] << 24) | (r[k] >> 8);
#pragma unroll
  for (int k = 0; k < 8; k++) s[k] = c_sha256_iv[k];
  sha256_compress(s, blk);
  blk[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
  for (int k = 1; k < 15; k++) blk[k] = 0;
  blk[15] = 65 * 8;
  sha256_compress(s, blk);
}

#define MERKLE_THREADS 128
#define MERKLE_RUN (2 * MERKLE_THREADS)  // children a block: 256
#define MERKLE_LEVELS 8   // levels a block builds: 256 children -> 1

// `levels` tree levels above a level of w nodes, of which this block holds
// the aligned run [lo, lo + cnt) in `nodes`: the first level into `out`,
// each next one right after the one before, as the tree's level buffer
// lays them out.  The block builds its subtree in `nodes` level after
// level, writing each level's slice to `out` too; a level's odd last node
// (only at the level's global right edge, since runs are aligned) is
// promoted unchanged.  Threads [0, MERKLE_THREADS) of the block hash.
DEV void merkle_subtree_levels(uint32_t (*nodes)[8], int w, int lo, int cnt,
                               int levels, uint32_t *out) {
  const int t = threadIdx.x;
  for (int l = 0; l < levels; l++) {
    const int pw = (w + 1) / 2, plo = lo / 2, pcnt = (cnt + 1) / 2;
    uint32_t s[8];
    if (t < pcnt) {
      if (2 * t + 1 < cnt) {
        merkle_inner(s, nodes[2 * t], nodes[2 * t + 1]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; k++) s[k] = nodes[2 * t][k];
      }
    }
    __syncthreads();   // every child read before a parent overwrites it
    if (t < pcnt) {
#pragma unroll
      for (int k = 0; k < 8; k++) {
        nodes[t][k] = s[k];
        out[(size_t)(plo + t) * 8 + k] = s[k];
      }
    }
    __syncthreads();
    out += (size_t)pw * 8;
    w = pw;
    lo = plo;
    cnt = pcnt;
  }
}

// `levels` tree levels above the level `in` of n nodes (n, 8 words), from
// `out` on: block b copies the aligned run of children [256 b, 256 b +
// 256) into shared memory and builds its subtree there
__global__ void BOUNDS(MERKLE_THREADS) merkle_subtree_kernel(
    const uint32_t *__restrict__ in, int n, int levels,
    uint32_t *__restrict__ out) {
  __shared__ uint32_t nodes[MERKLE_RUN][8];
  const int lo = blockIdx.x * MERKLE_RUN;
  const int cnt = n - lo < MERKLE_RUN ? n - lo : MERKLE_RUN;
  for (int i = threadIdx.x; i < cnt * 8; i += MERKLE_THREADS)
    (&nodes[0][0])[i] = in[(size_t)lo * 8 + i];
  __syncthreads();
  merkle_subtree_levels(nodes, n, lo, cnt, levels, out);
}

// The first launch of a tree with its leaves: block b hashes the leaves
// [256 b, 256 b + 256) of n (host-padded, (n, NB, 16) words) into shared
// memory, a thread a leaf (ahead of two a thread by 1-2 us at 10,000
// leaves on the H100, level at 2,048), copies them to `leaves` (the head
// of the level buffer) and builds `levels` levels of its subtree from
// `out` on, as merkle_subtree_kernel
__global__ void BOUNDS(MERKLE_RUN) merkle_leaves_kernel(
    const uint32_t *__restrict__ blocks, const int32_t *__restrict__ active,
    int NB, int n, int levels, uint32_t *__restrict__ leaves,
    uint32_t *__restrict__ out) {
  __shared__ uint32_t nodes[MERKLE_RUN][8];
  const int lo = blockIdx.x * MERKLE_RUN;
  const int cnt = n - lo < MERKLE_RUN ? n - lo : MERKLE_RUN;
  const int t = threadIdx.x;
  if (t < cnt) {
    uint32_t s[8];
    sha256_leaf(s, blocks + (size_t)(lo + t) * NB * 16, active[lo + t], NB);
#pragma unroll
    for (int k = 0; k < 8; k++) nodes[t][k] = s[k];
  }
  __syncthreads();
  for (int i = t; i < cnt * 8; i += MERKLE_RUN)
    leaves[(size_t)lo * 8 + i] = (&nodes[0][0])[i];
  merkle_subtree_levels(nodes, n, lo, cnt, levels, out);
}

extern "C" int sha256_leaves_launch(const void *blocks, const void *active,
                                    int B, int NB, void *out, void *stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  LAUNCH(sha256_leaves_kernel, (B + threads - 1) / threads, threads, stream,
         (const uint32_t *)blocks, (const int32_t *)active, B, NB,
         (uint32_t *)out);
  RETURN_LAUNCH_ERROR();
}

// children (n, 8) words -> parents ((n + 1) / 2, 8) words
extern "C" int merkle_level_launch(const void *children, int n, void *parents,
                                   void *stream) {
  if (n <= 0) return 0;
  LAUNCH(merkle_subtree_kernel, (n + MERKLE_RUN - 1) / MERKLE_RUN,
         MERKLE_THREADS, stream, (const uint32_t *)children, n, 1,
         (uint32_t *)parents);
  RETURN_LAUNCH_ERROR();
}

// the levels of a tree of n >= 1 leaves into its level buffer `levels`
// ((sum of the level widths, 8) words, leaves first, the root last): one
// launch per MERKLE_LEVELS levels, each block a subtree (two launches up
// to 65,536 leaves).  With leaf blocks (blocks non-null) the first launch
// hashes the leaves too; without, the leaves are already in the buffer.
static int merkle_levels(uint32_t *levels, int n, const uint32_t *blocks,
                         const int32_t *active, int NB, void *stream) {
  uint32_t *in = levels;
  int w = n;
  bool hash = blocks != nullptr;
  while (w > 1 || hash) {
    int k = 0, top = w;
    while (top > 1 && k < MERKLE_LEVELS) {
      top = (top + 1) / 2;
      k++;
    }
    const int grid = (w + MERKLE_RUN - 1) / MERKLE_RUN;
    if (hash)
      LAUNCH(merkle_leaves_kernel, grid, MERKLE_RUN, stream, blocks, active,
             NB, w, k, in, in + (size_t)w * 8);
    else
      LAUNCH(merkle_subtree_kernel, grid, MERKLE_THREADS, stream,
             (const uint32_t *)in, w, k, in + (size_t)w * 8);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    hash = false;
    for (int l = 0; l < k; l++) {
      in += (size_t)w * 8;
      w = (w + 1) / 2;
    }
  }
  return 0;
}

// every level of a tree of n leaves in one buffer, the leaves already
// written at its head
extern "C" int merkle_tree_launch(void *levels, int n, void *stream) {
  if (n <= 1) return 0;
  return merkle_levels((uint32_t *)levels, n, nullptr, nullptr, 0, stream);
}

// every level of a tree of n leaves, its leaves too: blocks (n, NB, 16)
// host-padded words and active (n,) -> levels, leaves first
extern "C" int merkle_tree_leaves_launch(const void *blocks,
                                         const void *active, int NB, int n,
                                         void *levels, void *stream) {
  if (n <= 0) return 0;
  return merkle_levels((uint32_t *)levels, n, (const uint32_t *)blocks,
                       (const int32_t *)active, NB, stream);
}
