// Reproducer of an nvcc front-end fault that cometbft_tpu_torch/csrc
// guards against (see the note at the top of ed25519.cuh).
//
// fold_kernel is an RLC window fold: each thread starts from the identity
// (probe_identity_cached), adds its strided share of n cached points,
// then the block's shared-memory tree adds the 128 thread sums.
// probe_cache is a __noinline__ cache of an extended point.  Built as it
// is, it reads its input whole before it writes, as the rule in
// ed25519.cuh asks of any __noinline__ function; with -DEARLY_CACHE it
// writes its output before its last read of the input, as ge_cache was
// first written.  If the compiler gives the identity ge_ext (dead after
// the call) and the thread's sum (first written by the call) one stack
// slot, the early build reads a half-written point and every window sum
// is wrong.  Whether it does depends on the code around the call: against
// the header of the first port, whose group functions were all
// __noinline__, nvcc 12.9 shared the slot and the early build was wrong
// in every window; around the inlined core it may not.  With
// -DPER_THREAD_OUT each thread's sum before the tree is written out too.
#include "ed25519.cuh"

#define T 128

DEV_NOINLINE void probe_cache(ge_cached &c, const ge_ext &p) {
#ifdef EARLY_CACHE
  fe d2;
  fe_const(d2, FE_D2);
  fe_add(c.ypx, p.y, p.x);
  fe_sub(c.ymx, p.y, p.x);
  fe_add(c.z2, p.z, p.z);
  fe_mul(c.t2d, p.t, d2);
#else
  ge_cached r;
  ge_cache(r, p);
  c = r;
#endif
}

DEV void probe_identity_cached(ge_cached &c) {
  ge_ext id;
  ge_identity(id);
  probe_cache(c, id);
}

DEV void tree_reduce_shared(ge_cached *sh) {
  const int tid = threadIdx.x;
  for (int s = T / 2; s > 0; s >>= 1) {
    if (tid < s) {
      ge_cached t;
      ge_add_cc(t, sh[tid], sh[tid + s]);
      sh[tid] = t;
    }
    __syncthreads();
  }
}

__global__ void fold_kernel(const int32_t *__restrict__ in, int n,
                            int32_t *__restrict__ out,
                            int32_t *__restrict__ per_thread) {
  __shared__ ge_cached sh[T];
  const int tid = threadIdx.x;
  const int w = blockIdx.x;
  ge_cached acc;
  probe_identity_cached(acc);
  for (int j = tid; j < n; j += T) {
    ge_cached e;
    ge_load_cached(e, in + ((size_t)w * n + j) * 40);
    ge_add_cc(acc, acc, e);
  }
#ifdef PER_THREAD_OUT
  ge_store_cached(per_thread + ((size_t)w * T + tid) * 40, acc);
#endif
  sh[tid] = acc;
  __syncthreads();
  tree_reduce_shared(sh);
  if (tid == 0) ge_store_cached(out + (size_t)w * 40, sh[0]);
}

extern "C" int fold_launch(const void *in, int n, void *out, void *pt,
                           int windows) {
  fold_kernel<<<windows, T>>>((const int32_t *)in, n, (int32_t *)out,
                              (int32_t *)pt);
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
