// Fixed-order sums shared by the SAC update's kernels (B5a-B5d, B5f).
//
// Every sum here is the halving tree of ops/physics.py::tree_sum_last: the
// n values, zero-padded to the next power of two p, are summed as
// x[i] + x[i + p/2] for i < p/2, then again on the first half, down to one
// value.  The plain torch versions call tree_sum_last on the same values,
// so with -fmad=false (kernels/build.py) a kernel's sums are bitwise equal
// to its plain version's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rd {

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
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

// Two (four) trees taken side by side.
struct Pair {
  float a, b;
};
struct Quad {
  float a, b, c, d;
};

__device__ __forceinline__ float add(float x, float y) { return x + y; }
__device__ __forceinline__ Pair add(Pair x, Pair y) {
  return {x.a + y.a, x.b + y.b};
}
__device__ __forceinline__ Quad add(Quad x, Quad y) {
  return {x.a + y.a, x.b + y.b, x.c + y.c, x.d + y.d};
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

// ---------------------------------------------------------------------------
// Column trees over rows: a bias gradient, the tree over the R rows of each
// column of a bf16 gradient G (B5d's backward kernels, the heads'
// backward).  The rows come in tiles of kTileRows; a block's tile of one
// column group sits in shared memory (row stride `stride` floats), one warp
// a column.  Over more rows, P = pow2_at_least(R) > kTileRows, the tree's
// first levels, of distance >= kTileRows, add whole tiles elementwise (tile
// t + tile t + T/2 of T = P / kTileRows, then again on the first half):
// the last block of a column group to finish its tile takes them from G in
// device memory (tiled_column_tree), the rest of the tree inside one tile.
// ---------------------------------------------------------------------------

constexpr int kTileRows = 256;  // rows of a tile
constexpr int kMaxTiles = 16;   // R <= 4,096
// The arrival counts such a launch keeps, one a column group (blockIdx.x),
// in the caller's zeroed buffer of this many (kernels/build.py::counters,
// N_COUNTERS).  Every launch on a device shares that buffer, so such
// launches must run in order, on one stream: two in flight at once would
// mix their arrivals.
constexpr int kMaxCounters = 8192;

// The halving tree over the first P rows of column c of s (P a power of
// two <= kTileRows), by one warp: lane l holds rows l, l + 32, ...; the
// levels of distance >= 32 in registers, the rest by shuffles from the
// padded half.  The sum ends in lane 0.
__device__ __forceinline__ float column_tree(const float* s, int stride, int c,
                                             int P) {
  const int lane = threadIdx.x & 31;
  float v[kTileRows / 32];
#pragma unroll
  for (int k = 0; k < kTileRows / 32; ++k)
    v[k] = lane + 32 * k < P ? s[(lane + 32 * k) * stride + c] : 0.0f;
#pragma unroll
  for (int h = kTileRows / 64; h >= 1; h >>= 1)
    if (64 * h <= P) {
#pragma unroll
      for (int k = 0; k < h; ++k) v[k] = v[k] + v[k + h];
    }
  if (P < 32) return warp_tree(v[0], P);
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1)
    v[0] = v[0] + __shfl_down_sync(kFullMask, v[0], h);
  return v[0];
}

// Each thread's stores made visible device-wide, then one arrival a block
// on `counter`; true in every thread of the last of `n` blocks to arrive,
// which sets the count back to 0 (so the kernel replays in a CUDA graph).
// `flag` is a word of the block's shared memory that nothing reads until
// the next barrier after this returns (the caller's: a static __shared__
// here would count against a launch that takes all of it dynamically).
__device__ __forceinline__ bool block_arrives_last(unsigned* counter,
                                                   unsigned n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(counter, 1u) == n - 1;
    if (last) *counter = 0u;
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// Row r of every tile of column col of a bf16 G in device memory (read
// past the L1: other blocks wrote it), +0.0 past R, summed over the T tiles
// by the halving tree (depth first: T a compile-time power of two)
template <int T>
__device__ __forceinline__ float tile_levels(const __nv_bfloat16* G,
                                             long long ld, int R, int col,
                                             int r) {
  return tree_static<T>([&](auto t) {
    const int row = decltype(t)::value * kTileRows + r;
    return row < R ? __bfloat162float(__ushort_as_bfloat16(__ldcg(
                         reinterpret_cast<const unsigned short*>(G) +
                         (long long)row * ld + col)))
                   : 0.0f;
  });
}

// A thread's cells (row r, column c0 + c of a tile: e = r W + c at
// threadIdx.x + NT i) of a block of NT threads, each summed over its T
// tiles: every load in flight before the first add
template <int T, int W, int NT>
__device__ __forceinline__ void tile_cells(float (&v)[kTileRows * W / NT],
                                           const __nv_bfloat16* G, long long ld,
                                           int R, int N, int c0, int rows) {
#pragma unroll
  for (int i = 0; i < kTileRows * W / NT; ++i) {
    const int e = threadIdx.x + i * NT, col = c0 + e % W;
    v[i] = e < rows * W && col < N ? tile_levels<T>(G, ld, R, col, e / W) : 0.0f;
  }
}

// The tree over the R rows (R <= kMaxTiles * kTileRows, zero-padded to
// P = pow2_at_least(R)) of columns [c0, c0 + W) of a bf16 G (row stride ld,
// N columns) in device memory, by a block of exactly NT threads (NT a
// multiple of 32 W that divides kTileRows W).  Each (row r of a tile,
// column) first takes the tile levels over its T values in one thread
// (tile_levels), into s (kTileRows rows of stride W + 1), then warp c < W
// the tree inside the tile.  The sum of column c0 + c ends in lane 0 of
// warp c; the other warps return 0.
template <int W, int NT = 32 * W>
__device__ __forceinline__ float tiled_column_tree(const __nv_bfloat16* G,
                                                   long long ld, int R, int N,
                                                   int c0, float* s) {
  constexpr int kCells = kTileRows * W / NT;
  const int P = pow2_at_least(R);
  const int T = P > kTileRows ? P / kTileRows : 1;
  const int rows = P > kTileRows ? kTileRows : P;
  __syncthreads();  // s is free (an earlier group's trees are done)
  float v[kCells];
  switch (T) {
    case 1: tile_cells<1, W, NT>(v, G, ld, R, N, c0, rows); break;
    case 2: tile_cells<2, W, NT>(v, G, ld, R, N, c0, rows); break;
    case 4: tile_cells<4, W, NT>(v, G, ld, R, N, c0, rows); break;
    case 8: tile_cells<8, W, NT>(v, G, ld, R, N, c0, rows); break;
    default: tile_cells<kMaxTiles, W, NT>(v, G, ld, R, N, c0, rows); break;
  }
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < rows * W) s[(e / W) * (W + 1) + e % W] = v[i];
  }
  __syncthreads();
  const int c = threadIdx.x / 32;
  return c < W ? column_tree(s, W + 1, c, rows) : 0.0f;
}

}  // namespace rd
