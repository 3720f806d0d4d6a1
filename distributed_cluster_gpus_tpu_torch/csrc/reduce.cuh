// Fixed-order sums shared by the SAC update's kernels (B5a, B5b, B5c).
//
// Every sum here is the halving tree of ops/physics.py::tree_sum_last: the
// n values, zero-padded to the next power of two p, are summed as
// x[i] + x[i + p/2] for i < p/2, then again on the first half, down to one
// value.  The plain torch versions call tree_sum_last on the same values,
// so with -fmad=false (kernels/build.py) a kernel's sums are bitwise equal
// to its plain version's.
#pragma once

#include <cuda_runtime.h>

namespace rd {

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The tree over x[0..p) in one thread's own memory (p a power of two).
__device__ __forceinline__ float tree_local(float* x, int p) {
  while (p > 1) {
    p >>= 1;
    for (int i = 0; i < p; ++i) x[i] = x[i] + x[i + p];
  }
  return x[0];
}

// The trees over `rows` rows of p entries each, stored with row stride
// `stride` >= p, by the whole block (every thread calls it); each row's sum
// ends in its first entry.
__device__ __forceinline__ void tree_rows(float* x, int rows, int p,
                                          int stride) {
  __syncthreads();
  while (p > 1) {
    const int h = p >> 1;
    for (int e = threadIdx.x; e < rows * h; e += blockDim.x) {
      const int r = e / h, i = e % h;
      x[r * stride + i] = x[r * stride + i] + x[r * stride + i + h];
    }
    p = h;
    __syncthreads();
  }
}

// "Last block" detection for a grid that writes one partial per block:
// each block's thread 0 calls this after writing its partial(s); it makes
// them visible device-wide and returns true in exactly one block, the last
// to arrive, which then reads every partial (with __ldcg, past the L1).
// `counter` must be 0 at the launch; the last block sets it back to 0 when
// it is done, so the wrappers keep one per device.
__device__ __forceinline__ bool arrive_last(unsigned* counter) {
  __threadfence();
  const unsigned prev = atomicAdd(counter, 1u);
  return prev == gridDim.x - 1;
}

}  // namespace rd
