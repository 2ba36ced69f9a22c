// Cycles of the Ed25519 device core's primitives (csrc/ed25519.cuh) on the
// card: a dependent chain of n calls of one primitive per thread, timed
// with clock64 between two points of the chain.  Built and run by
// scripts/ed25519_core_bench.py.
#include "ed25519.cuh"

enum { FE_MUL, FE_SQ, GATHER4, GEQ_DBL, GEQ_ADD, GE_DBL };

__global__ void bench_kernel(int which, int n, int32_t *out,
                             long long *cycles) {
  fe a, b;
  for (int i = 0; i < 10; i++) {
    a.v[i] = (threadIdx.x * 7 + i * 1234567) & 0xffffff;
    b.v[i] = (i * 99991 + threadIdx.x) & 0xffffff;
  }
  ge_ext p;
  p.x = a;
  p.y = b;
  p.z = a;
  p.t = b;
  const int k = quad_k();
  __syncwarp();
  const long long t0 = clock64();
  if (which == FE_MUL) {
    for (int i = 0; i < n; i++) fe_mul(a, a, b);
  } else if (which == FE_SQ) {
    for (int i = 0; i < n; i++) fe_sq(a, a);
  } else if (which == GATHER4) {
    for (int i = 0; i < n; i++) {
      fe q[4];
      fe_gather4(q, a);
      fe_add(a, q[1], q[2]);
    }
  } else if (which == GEQ_DBL) {
    for (int i = 0; i < n; i++) geq_dbl(p, k);
    a = p.x;
  } else if (which == GEQ_ADD) {
    for (int i = 0; i < n; i++) geq_add(p, k, b);
    a = p.y;
  } else {
    for (int i = 0; i < n; i++) ge_dbl(p, p);
    a = p.z;
  }
  const long long t1 = clock64();
  for (int i = 0; i < 10; i++)
    out[(blockIdx.x * blockDim.x + threadIdx.x) * 10 + i] = a.v[i];
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

extern "C" int bench_launch(int which, int n, int blocks, int threads,
                            void *out, void *cycles) {
  bench_kernel<<<blocks, threads>>>(which, n, (int32_t *)out,
                                    (long long *)cycles);
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
