// Cycles of the G1 fold's primitives (csrc/blsg1.cu) on the card: a
// dependent chain of n calls of one primitive per thread, timed with
// clock64 between two points of the chain, and n levels of the fold's
// six-thread addition over a block's rows.  Built and run by
// scripts/blsg1_core_bench.py.
// thread 0's cycles in each phase of the fold's additions, between the
// barriers (blsg1.cu:G1_STAMP): round 1, its store, round 2, its store,
// the combination
__shared__ long long st[5], st_last;
#define G1_STAMP(phase)                         \
  if (threadIdx.x == 0) {                       \
    const long long c = clock64();              \
    st[phase] += c - st_last;                   \
    st_last = c;                                \
  }
#include "blsg1.cu"

enum { FP_MUL, FP_ADD, FP_MUL12, G1_LEVEL, FP_MUL_CC };

// A candidate product: the same CIOS rows with PTX carry chains
// (mad.lo.cc / madc.hi.cc over 32-bit words) in place of 64-bit sums
#define MADC(op, d, x, y) \
  asm volatile(op " %0, %1, %2, %0;" : "+r"(d) : "r"(x), "r"(y))
DEV_NOINLINE fp fp_mul_cc(const fp a, const fp b) {
  uint32_t t[FP_N + 2];
#pragma unroll
  for (int i = 0; i < FP_N + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < FP_N; i++) {
    const uint32_t bi = b.w[i];
    MADC("mad.lo.cc.u32", t[0], a.w[0], bi);
#pragma unroll
    for (int j = 1; j < FP_N; j++) MADC("madc.lo.cc.u32", t[j], a.w[j], bi);
    asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[FP_N]));
    asm volatile("addc.u32 %0, 0, 0;" : "=r"(t[FP_N + 1]));
    MADC("mad.hi.cc.u32", t[1], a.w[0], bi);
#pragma unroll
    for (int j = 1; j < FP_N; j++)
      MADC("madc.hi.cc.u32", t[j + 1], a.w[j], bi);
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[FP_N + 1]));
    const uint32_t m = t[0] * c_bls_n0;
    MADC("mad.lo.cc.u32", t[0], m, c_bls_p[0]);
#pragma unroll
    for (int j = 1; j < FP_N; j++)
      MADC("madc.lo.cc.u32", t[j], m, c_bls_p[j]);
    asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[FP_N]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[FP_N + 1]));
    MADC("mad.hi.cc.u32", t[1], m, c_bls_p[0]);
#pragma unroll
    for (int j = 1; j < FP_N; j++)
      MADC("madc.hi.cc.u32", t[j + 1], m, c_bls_p[j]);
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[FP_N + 1]));
#pragma unroll
    for (int j = 0; j <= FP_N; j++) t[j] = t[j + 1];
  }
  return fp_reduce_once(t);
}

// which: the primitive; groups: additions a level runs (G1_LEVEL, at most
// G1_GROUPS, on a block of G1_THREADS threads)
__global__ void bench_kernel(int which, int n, int groups, uint32_t *out,
                             long long *cycles) {
  __shared__ g1p rows[2 * G1_GROUPS];
  if (threadIdx.x < 5) st[threadIdx.x] = 0;
  fp a, b;
  for (int i = 0; i < FP_N; i++) {  // below p: the top word is small
    a.w[i] = i + 1 < FP_N ? threadIdx.x * 2654435761u + i * 40503u : 7u;
    b.w[i] = i + 1 < FP_N ? i * 2246822519u + threadIdx.x : 5u;
  }
  if (which == G1_LEVEL) {
    for (int r = threadIdx.x; r < 2 * G1_GROUPS; r += blockDim.x)
      for (int c = 0; c < 3; c++) rows[r].c[c] = c == 1 ? b : a;
    __syncthreads();
  }
  __syncwarp();
  const long long t0 = clock64();
  if (which == FP_MUL) {
    for (int i = 0; i < n; i++) a = fp_mul(a, b);
  } else if (which == FP_ADD) {
    for (int i = 0; i < n; i++) a = fp_add(a, b);
  } else if (which == FP_MUL_CC) {
    for (int i = 0; i < n; i++) a = fp_mul_cc(a, b);
  } else if (which == FP_MUL12) {
    for (int i = 0; i < n; i++) a = fp_mul12(a);
  } else {
    int k, gi;
    g1_role(k, gi);
    if (threadIdx.x == 0) st_last = clock64();
    for (int i = 0; i < n; i++)
      g1_add_shared(rows, gi, G1_GROUPS, k, gi < groups);
    a = rows[threadIdx.x % (2 * G1_GROUPS)].c[0];
  }
  const long long t1 = clock64();
  if (which == FP_MUL_CC) {  // the candidate against the shipped product
    fp c = a, d = b;
    for (int i = 0; i < 16; i++) {
      const fp x = fp_mul(c, d), y = fp_mul_cc(c, d);
      for (int w = 0; w < FP_N; w++)
        if (x.w[w] != y.w[w])
          atomicAdd((unsigned long long *)cycles + gridDim.x + blockIdx.x,
                    1ull);
      c = d;
      d = x;
    }
  }
  for (int i = 0; i < FP_N; i++)
    out[(blockIdx.x * blockDim.x + threadIdx.x) * FP_N + i] = a.w[i];
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  if (which == G1_LEVEL && blockIdx.x == 0 && threadIdx.x < 5)
    cycles[2 * gridDim.x + threadIdx.x] = st[threadIdx.x];
}

// cycles: 2 * blocks + 5, the second block counting the candidate
// product's mismatched words, the last 5 block 0's phase sums (G1_LEVEL)
extern "C" int bench_launch(int which, int n, int groups, int blocks,
                            int threads, void *out, void *cycles) {
  bench_kernel<<<blocks, threads>>>(which, n, groups, (uint32_t *)out,
                                    (long long *)cycles);
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
