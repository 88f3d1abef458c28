// The persistent grid shared by the port's kernels (included, not built on
// its own; a library's hash covers it, see build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// CTAs of a persistent grid for `kernel` at `threads` threads and `smem`
// bytes of dynamic shared memory per CTA: as many as fit on one SM (the
// occupancy calculator) times the current device's SMs, and no more than
// `need`.  *sms, when given, receives the SM count.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   int64_t need, unsigned* grid,
                                   int* sms = nullptr) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t most = (int64_t)n_sm * per_sm;
  *grid = (unsigned)(need < most ? need : most);
  if (sms) *sms = n_sm;
  return cudaSuccess;
}
