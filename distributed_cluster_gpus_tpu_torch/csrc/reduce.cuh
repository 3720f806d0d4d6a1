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

// ---------------------------------------------------------------------------
// The same trees in registers and warp shuffles (B5a, B5b's actor term).
// A warp holds the values of a tree laid out element k at lane k % 32,
// register k / 32.  The halving tree's levels of distance >= 32 then pair a
// lane's registers r and r + d/32, and the levels below pair lanes l and
// l + d: register adds first, then shuffles.  The shuffles start at half the
// padded length (never at 16 for a shorter tree: the plain tree adds no
// zeros beyond its padded length, and -0.0 + 0.0 is +0.0).
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;

// A compile-time index handed to a leaf.
template <int V>
struct Int {
  static constexpr int value = V;
};

// Two trees taken side by side.
struct Pair {
  float a, b;
};

__device__ __forceinline__ float add(float x, float y) { return x + y; }
__device__ __forceinline__ Pair add(Pair x, Pair y) {
  return {x.a + y.a, x.b + y.b};
}

// The halving tree over leaf(Int<j>) for j in [0, P), P a compile-time
// power of two, taken depth first: T(base, S) = T(base, 2S) + T(base + S,
// 2S) with T(j, P) = leaf(j) adds exactly the pairs the halving tree adds
// (at width p an element holds the indices congruent to it mod p), with
// log2(P) partial sums live instead of P values.
template <int P, int S = 1, int Base = 0, class Leaf>
__device__ __forceinline__ auto tree_static(const Leaf& leaf) {
  if constexpr (S >= P) {
    return leaf(Int<Base>{});
  } else {
    return add(tree_static<P, 2 * S, Base>(leaf),
               tree_static<P, 2 * S, Base + S>(leaf));
  }
}

// The same tree over leaf(j), j in [0, R), for a run-time power of two
// R <= 256: the leaves visited in bit-reversed order, where the halving
// tree's pairs are adjacent, each pending subtree of 2^l leaves in slot l
// (compile-time slots, so registers); leaves are fetched eight at a time so
// their loads are in flight together.  `zero` is the padding value.
template <class T, class Leaf>
__device__ __forceinline__ T tree_stream(int R, T zero, const Leaf& leaf) {
  constexpr int kSlots = 9, kAhead = 8;
  int bits = 0;
  while ((1 << bits) < R) ++bits;
  T slot[kSlots];
  T v = zero;
  for (int j0 = 0; j0 < R; j0 += kAhead) {
    T x[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 + u;
      x[u] = j < R ? leaf(bits ? (int)(__brev((unsigned)j) >> (32 - bits)) : 0)
                   : zero;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 + u;
      if (j < R) {
        // leaf j closes as many subtrees as j has trailing ones: add them
        // (left + right, lowest level first) and leave the sum pending
        const int m = __ffs(~j) - 1;
        v = x[u];
#pragma unroll
        for (int l = 0; l < kSlots; ++l)
          if (l < m) v = add(slot[l], v);
#pragma unroll
        for (int l = 0; l < kSlots; ++l)
          if (l == m) slot[l] = v;
      }
    }
  }
  return v;  // after the last leaf, every level has been added
}

// The same tree over leaf(j), j in [0, R), R a run-time power of two <=
// 256: unrolled at compile time up to 16 leaves (a one-time tail runs a
// few dozen instructions instead of tree_stream's general merges), streamed
// above.
template <class T, class Leaf>
__device__ __forceinline__ T tree_regs(int R, T zero, const Leaf& leaf) {
  const auto at = [&](auto J) -> T { return leaf(decltype(J)::value); };
  switch (R) {
    case 1: return tree_static<1>(at);
    case 2: return tree_static<2>(at);
    case 4: return tree_static<4>(at);
    case 8: return tree_static<8>(at);
    case 16: return tree_static<16>(at);
    default: return tree_stream(R, zero, leaf);
  }
}

// The shuffle levels of a tree of p <= 32 lanes (p a power of two, the
// same in every lane): lane l < h takes x[l] + x[l + h] for h = p/2, ..., 1;
// the sum ends in lane 0.  Every lane of the warp calls it.
__device__ __forceinline__ float warp_tree(float x, int p) {
  for (int h = p >> 1; h > 0; h >>= 1) x = x + __shfl_down_sync(kFullMask, x, h);
  return x;
}

// tree_strided's register levels of distance 32 * RD, 32 * RD / 2, ..., 32
// (those inside [s, s * P / 2]), unrolled by recursion so every index is a
// constant.
template <int R, int RD>
__device__ __forceinline__ void register_levels(float (&x)[R], int s, int P) {
  if constexpr (RD >= 1) {
    if (32 * RD >= s && 32 * RD < s * P) {
#pragma unroll
      for (int r = 0; r + RD < R; ++r)
        if (r % (2 * RD) < RD) x[r] = x[r] + x[r + RD];
    }
    register_levels<R, RD / 2>(x, s, P);
  }
}

// The trees over x[g + base + s * m], m in [0, P), for every base < s and
// every segment start g (a multiple of s * P), of a warp's values laid out
// as above in the first `used` of R registers (s and P run-time powers of
// two): every level, of distance d = s * P / 2 down to s, as register adds
// (d >= 32) or shuffles, on every element whose offset in its segment mod 2d
// is below d.  The tree of g + base ends at that element.  Every lane of
// the warp calls it.
template <int R>
__device__ __forceinline__ void tree_strided(float (&x)[R], int s, int P,
                                             int used) {
  static_assert(R >= 1 && (R & (R - 1)) == 0, "R: a power of two");
  register_levels<R, R / 2>(x, s, P);
  for (int h = min(s * P, 32) >> 1; h >= s; h >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < used) x[r] = x[r] + __shfl_down_sync(kFullMask, x[r], h);
  }
}

}  // namespace rd
