// Launch and device-function macros shared by the port's CUDA sources.
//
// Each .cu file builds twice: with nvcc for the card, and with g++ for the
// host under the sanitizers (tests/torch_kernels_host.cpp, which defines
// dim3, threadIdx, blockIdx, __syncthreads, __global__, __shared__,
// __constant__, cudaGetLastError, host_launch and host_quad_gather before
// including a .cu file).  These macros name the one place where the two
// builds differ.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define DEV __device__ __forceinline__
#define DEV_NOINLINE __device__ __noinline__
// a constant table too large for __constant__ memory's 64 KB
#define DEV_TABLE __device__ const
#define BOUNDS(threads) __launch_bounds__(threads)
// kernel<<<grid, block, 0, stream>>>(args...)
#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#else
#define DEV static inline
#define DEV_NOINLINE static __attribute__((noinline))
#define DEV_TABLE const
#define BOUNDS(threads)
#define LAUNCH(kernel, grid, block, stream, ...) \
  host_launch((grid), (block), kernel, __VA_ARGS__)
#endif

// the C entry points report launch failures to the Python wrappers
#define RETURN_LAUNCH_ERROR() return (int)cudaGetLastError()
