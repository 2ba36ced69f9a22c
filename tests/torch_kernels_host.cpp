// Host build of the port's CUDA kernels (cometbft_tpu_torch/csrc), for
// tests/test_torch_kernels_host_*.py: their shared fixtures
// (tests/torch_kernels_host_fixtures.py) compile it once with
// -fsanitize=address,undefined, and the tests compare what it computes
// with the plain PyTorch versions.
//
// Every kernel and launch sequence runs as written: a block is blockDim.x
// host threads, each with its own threadIdx; blocks run one after another
// on the same threads (a launch starts its threads once), so a __shared__
// array is a static one; __syncthreads is a barrier over
// the block, and the quad exchange of ed25519.cuh (a shuffle among four
// threads on the card) goes through static slots between two barriers
// over the quad.
//
//   torch_kernels_host MODE DIR ARGS...
//
// reads DIR/<name>.bin and writes DIR/<name>.bin (raw little-endian
// arrays, the layouts of the kernels' C entry points):
//   tables N LPB        pub -> tab, ok; LPB validators a block
//   sha B NB            blocks, active -> h
//   verify B NB N       tab, ok_a, idx, rb, sb, blocks, active -> out
//   rlc B NB N LPB      tab, ok_a, idx, rb, sb, blocks, active, z -> out,
//                       sums (the 96 window sums); the lane stage at LPB
//                       lanes a block, hashing the lanes' blocks itself
//   ladder              sums (96 x 40), zs (32), ok (1) -> out (2): the
//                       single-device verdict's last launches (comb,
//                       ladder) and the combine entry over one shard
//   rlc_sharded B NB N D C LPB
//                       the same inputs cut into D contiguous shards of
//                       ceil(B/D) lanes (the last short, possibly empty),
//                       shard d on card d % C: per card, its shards' lanes
//                       side by side, one ed25519_rlc_sums call (lane
//                       stage at LPB lanes a block, hashing the lanes'
//                       blocks; RLC_MAX_SHARDS shards a pass) writing each
//                       shard's slot; then
//                       ed25519_rlc_combine -> out, sums (D x 96 window
//                       sums), zs (D x 32), ok (D)
//   sha256 B NB         blocks, active -> out (B x 8 digest words)
//   merkle N            children (N x 8 words) -> parents
//   merkle_tree N       leaves (N x 8 words) -> levels (every level of the
//                       tree, leaves first, the root last)
//   merkle_tree_leaves N NB
//                       blocks (N x NB x 16 words), active (N) -> levels
//                       (the leaves' digests, then every level above
//                       them)
//   blsg1 R N2          rows (R x 2 x 12 words), mask (R) -> out (3 x 32
//                       12-bit limbs); N2 the padded row count (blocks of
//                       G1_ROWS = 8 rows and G1_GROUPS = 2 additions at a
//                       time, so 64 rows take two launches and 512 three)
#include <algorithm>
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

static thread_local dim3 threadIdx, blockIdx;
static dim3 blockDim, gridDim;
static thread_local std::barrier<> *g_block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> g_quad_barriers;
static unsigned char g_quad_slots[1024][64];

static void __syncthreads() { g_block_barrier->arrive_and_wait(); }
static int cudaGetLastError() { return 0; }

// out[j] = thread j's value of `mine` (n bytes), for the quad of the
// calling thread
static void host_quad_gather(void *out, const void *mine, size_t n) {
  const unsigned t = threadIdx.x, q = t & ~3u;
  std::barrier<> &bar = *g_quad_barriers[t >> 2];
  memcpy(g_quad_slots[t], mine, n);
  bar.arrive_and_wait();
  for (unsigned j = 0; j < 4; j++)
    memcpy((unsigned char *)out + j * n, g_quad_slots[q + j], n);
  bar.arrive_and_wait();
}

#define __global__
#define __shared__ static
#define __constant__

template <class... P, class... A>
static void host_launch(dim3 grid, dim3 block, void (*kernel)(P...),
                        A... args) {
  gridDim = grid;
  blockDim = block;
  if (block.x > 1024) {
    fprintf(stderr, "block of %u threads\n", block.x);
    exit(2);
  }
  g_quad_barriers.clear();
  for (unsigned q = 0; q < block.x; q += 4)
    g_quad_barriers.emplace_back(
        new std::barrier<>((std::ptrdiff_t)std::min(4u, block.x - q)));
  // one set of threads runs every block in turn: a barrier a block, which
  // a thread leaves when it returns from the kernel, and one between
  // blocks that none leaves, so no thread starts a block before every
  // thread has finished the one before (the static __shared__ arrays)
  const unsigned n_blocks = grid.x * grid.y;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (unsigned b = 0; b < n_blocks; b++)
    bars.emplace_back(new std::barrier<>((std::ptrdiff_t)block.x));
  std::barrier<> step((std::ptrdiff_t)block.x);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; t++)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned b = 0; b < n_blocks; b++) {
        blockIdx = dim3(b % grid.x, b / grid.x);
        g_block_barrier = bars[b].get();
        kernel(args...);
        bars[b]->arrive_and_drop();
        step.arrive_and_wait();
      }
    });
  for (auto &th : threads) th.join();
}

// two shards a pass of ed25519_rlc_sums_launch (64 on the card), so that
// three or four shards of one card take two passes
#define RLC_MAX_SHARDS 2
// the G1 fold at 8 rows a block, two additions (12 threads) at a time
#define G1_ROWS 8
#define G1_GROUPS 2
#include "blsg1.cu"
#include "ed25519_rlc.cu"
#include "ed25519_tables.cu"
#include "ed25519_verify.cu"
#include "sha256.cu"
#include "sha512_scalar.cu"

static std::string g_dir;

template <class T>
static std::vector<T> load(const char *name, size_t n) {
  std::vector<T> v(n);
  FILE *f = fopen((g_dir + "/" + name + ".bin").c_str(), "rb");
  if (!f || fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "cannot read %zu items of %s\n", n, name);
    exit(2);
  }
  fclose(f);
  return v;
}

template <class T>
static void save(const char *name, const std::vector<T> &v) {
  FILE *f = fopen((g_dir + "/" + name + ".bin").c_str(), "wb");
  if (!f || fwrite(v.data(), sizeof(T), v.size(), f) != v.size()) {
    fprintf(stderr, "cannot write %s\n", name);
    exit(2);
  }
  fclose(f);
}

static int check(int err) {
  if (err != 0) {
    fprintf(stderr, "launch returned %d\n", err);
    exit(3);
  }
  return 0;
}

int main(int argc, char **argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: %s MODE DIR ARGS...\n", argv[0]);
    return 2;
  }
  const std::string mode = argv[1];
  g_dir = argv[2];
  const int a0 = atoi(argv[3]);
  const int a1 = argc > 4 ? atoi(argv[4]) : 0;
  const int a2 = argc > 5 ? atoi(argv[5]) : 0;
  if (mode == "tables") {
    const int N = a0, lpb = a1;
    auto pub = load<uint8_t>("pub", (size_t)N * 32);
    std::vector<int32_t> tab((size_t)N * 640);
    std::vector<uint8_t> ok(N);
    check(ed25519_tables_launch(pub.data(), N, lpb, tab.data(), ok.data(),
                                nullptr));
    save("tab", tab);
    save("ok", ok);
    return 0;
  }
  if (mode == "sha") {
    const int B = a0, NB = a1;
    auto blocks = load<uint32_t>("blocks", (size_t)B * NB * 32);
    auto active = load<int32_t>("active", B);
    std::vector<uint8_t> h((size_t)B * 32);
    check(sha512_scalar_launch(blocks.data(), active.data(), B, NB, h.data(),
                               nullptr));
    save("h", h);
    return 0;
  }
  if (mode == "sha256") {
    const int B = a0, NB = a1;
    auto blocks = load<uint32_t>("blocks", (size_t)B * NB * 16);
    auto active = load<int32_t>("active", B);
    std::vector<uint32_t> out((size_t)B * 8);
    check(sha256_leaves_launch(blocks.data(), active.data(), B, NB,
                               out.data(), nullptr));
    save("out", out);
    return 0;
  }
  if (mode == "merkle") {
    const int N = a0;
    auto children = load<uint32_t>("children", (size_t)N * 8);
    std::vector<uint32_t> parents((size_t)(N + 1) / 2 * 8);
    check(merkle_level_launch(children.data(), N, parents.data(), nullptr));
    save("parents", parents);
    return 0;
  }
  if (mode == "merkle_tree") {
    const int N = a0;
    size_t rows = N;
    for (int w = N; w > 1; rows += w) w = (w + 1) / 2;
    auto leaves = load<uint32_t>("leaves", (size_t)N * 8);
    std::vector<uint32_t> levels(rows * 8);
    std::copy(leaves.begin(), leaves.end(), levels.begin());
    check(merkle_tree_launch(levels.data(), N, nullptr));
    save("levels", levels);
    return 0;
  }
  if (mode == "merkle_tree_leaves") {
    const int N = a0, NB = a1;
    size_t rows = N;
    for (int w = N; w > 1; rows += w) w = (w + 1) / 2;
    auto blocks = load<uint32_t>("blocks", (size_t)N * NB * 16);
    auto active = load<int32_t>("active", N);
    std::vector<uint32_t> levels(rows * 8);
    check(merkle_tree_leaves_launch(blocks.data(), active.data(), NB, N,
                                    levels.data(), nullptr));
    save("levels", levels);
    return 0;
  }
  if (mode == "blsg1") {
    const int R = a0, N2 = a1;
    auto rows = load<uint32_t>("rows", (size_t)R * 2 * 12);
    auto mask = load<int32_t>("mask", R);
    std::vector<uint32_t> scratch((size_t)N2 * 3 * 12);
    std::vector<int32_t> out(3 * 32);
    check(aggregate_g1_masked_launch(rows.data(), mask.data(), R, N2,
                                     scratch.data(), N2, out.data(),
                                     nullptr));
    save("out", out);
    return 0;
  }
  if (mode == "ladder") {
    auto sums = load<int32_t>("sums", RLC_WINDOWS * 40);
    auto zs = load<uint8_t>("zs", 32);
    auto ok = load<uint8_t>("ok", 1);
    std::vector<int32_t> comb(40);
    std::vector<uint8_t> out(2);
    LAUNCH(rlc_comb_kernel, 1, RLC_COMB_THREADS, nullptr, zs.data(),
           comb.data());
    LAUNCH(rlc_ladder_kernel, 1, 64, nullptr, sums.data(), comb.data(),
           ok.data(), out.data());
    check(ed25519_rlc_combine_launch(sums.data(), zs.data(), ok.data(), 1,
                                     out.data() + 1, nullptr));
    save("out", out);
    return 0;
  }
  if (mode != "verify" && mode != "rlc" && mode != "rlc_sharded") {
    fprintf(stderr, "unknown mode %s\n", mode.c_str());
    return 2;
  }
  const int B = a0, NB = a1, N = a2;
  auto tab = load<int32_t>("tab", (size_t)N * 640);
  auto ok_a = load<uint8_t>("ok_a", N);
  auto idx = load<int32_t>("idx", B);
  auto rb = load<uint8_t>("rb", (size_t)B * 32);
  auto sb = load<uint8_t>("sb", (size_t)B * 32);
  auto blocks = load<uint32_t>("blocks", (size_t)B * NB * 32);
  auto active = load<int32_t>("active", B);
  if (mode == "verify") {
    std::vector<uint8_t> out(B);
    check(ed25519_verify_gather_launch(tab.data(), ok_a.data(), idx.data(),
                                       rb.data(), sb.data(), blocks.data(),
                                       active.data(), B, NB, out.data(),
                                       nullptr));
    save("out", out);
    return 0;
  }
  auto z = load<uint8_t>("z", (size_t)B * 16);
  if (mode == "rlc_sharded") {
    const int D = argc > 6 ? atoi(argv[6]) : 1;
    const int C = argc > 7 ? atoi(argv[7]) : 1;
    const int lpb = argc > 8 ? atoi(argv[8]) : 32;
    if (D < 1 || C < 1 || C > D) {
      fprintf(stderr, "rlc_sharded needs 1 <= C <= D\n");
      return 2;
    }
    const int step = (B + D - 1) / D;
    std::vector<int32_t> sums((size_t)D * RLC_WINDOWS * 40);
    std::vector<uint8_t> zs_sum((size_t)D * 32), all_ok(D), out(1);
    for (int c = 0; c < C; c++) {
      // the card's shards' lanes side by side
      std::vector<int> lo(1, 0), slot;
      std::vector<int32_t> cidx, cactive;
      std::vector<uint8_t> crb, csb, cz;
      std::vector<uint32_t> cblocks;
      for (int d = c; d < D; d += C) {
        const int s0 = std::min(B, d * step), s1 = std::min(B, s0 + step);
        cidx.insert(cidx.end(), idx.begin() + s0, idx.begin() + s1);
        cactive.insert(cactive.end(), active.begin() + s0,
                       active.begin() + s1);
        crb.insert(crb.end(), rb.begin() + (size_t)s0 * 32,
                   rb.begin() + (size_t)s1 * 32);
        csb.insert(csb.end(), sb.begin() + (size_t)s0 * 32,
                   sb.begin() + (size_t)s1 * 32);
        cz.insert(cz.end(), z.begin() + (size_t)s0 * 16,
                  z.begin() + (size_t)s1 * 16);
        cblocks.insert(cblocks.end(), blocks.begin() + (size_t)s0 * NB * 32,
                       blocks.begin() + (size_t)s1 * NB * 32);
        lo.push_back(lo.back() + s1 - s0);
        slot.push_back(d);
      }
      const int n = lo.back();
      int nblk = 0;
      for (size_t i = 0; i + 1 < lo.size(); i++)
        nblk += (lo[i + 1] - lo[i] + RLC_BLOCK_LANES - 1) / RLC_BLOCK_LANES;
      std::vector<uint8_t> zh((size_t)n * 32), lane_ok(n);
      std::vector<int32_t> rtab((size_t)n * 640), zs((size_t)n * 12),
          partials((size_t)RLC_WINDOWS * nblk * 40);
      check(ed25519_rlc_sums_launch(
          tab.data(), ok_a.data(), cidx.data(), crb.data(), csb.data(),
          cblocks.data(), cactive.data(), cz.data(), n, NB, lo.data(),
          slot.data(), (int)slot.size(), lpb, rtab.data(), zh.data(),
          zs.data(), lane_ok.data(),
          partials.data(), sums.data(), zs_sum.data(), all_ok.data(),
          nullptr));
    }
    check(ed25519_rlc_combine_launch(sums.data(), zs_sum.data(),
                                     all_ok.data(), D, out.data(), nullptr));
    save("out", out);
    save("sums", sums);
    save("zs", zs_sum);
    save("ok", all_ok);
    return 0;
  }
  const int lpb = argc > 6 ? atoi(argv[6]) : 32;
  const int nblk = (B + RLC_BLOCK_LANES - 1) / RLC_BLOCK_LANES;
  std::vector<uint8_t> zh((size_t)B * 32), lane_ok(B), zs_sum(32), all_ok(1),
      out(1);
  std::vector<int32_t> rtab((size_t)B * 640), zs((size_t)B * 12),
      partials((size_t)RLC_WINDOWS * nblk * 40), sums(RLC_WINDOWS * 40);
  check(ed25519_rlc_gather_launch(
      tab.data(), ok_a.data(), idx.data(), rb.data(), sb.data(),
      blocks.data(), active.data(), z.data(), B, NB, lpb, rtab.data(),
      zh.data(), zs.data(), lane_ok.data(), partials.data(), sums.data(),
      zs_sum.data(), all_ok.data(), out.data(), nullptr));
  save("out", out);
  save("sums", sums);
  return 0;
}
