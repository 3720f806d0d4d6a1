// B5f's backward fused with the actor heads' top-layer backward, on Hopper
// (sm_90a): the port of the gradient of `nn.log_softmax` under the masks
// that XLA fuses in the actor of `sac_train_step`
// (distributed_cluster_gpus_tpu/rl/nets.py:62-66, inside
// rl/sac.py:206-310) and of the heads' bf16 `Dense` bias gradients
// (rl/nets.py:58-61, `value_and_grad` at rl/sac.py:264).  The JAX package
// has no Pallas kernel.  The forward runs in the heads' product
// (csrc/dense.cu, actor_heads_gemm).
//
// For each row b of a head (n entries: the DC head's n_dc, the GPU-count
// head's n_g), from its float32 logits l, boolean mask and the incoming
// gradient g = dL/dlogp, the forward's
//   x_j  = mask_j ? l_j : -1e9,   m = max_j x_j (held constant under
//   differentiation, as flax's log_softmax stops its gradient),
//   e_j  = exp(x_j - m),   S = sum_j e_j
// give the logits' gradient (rl/nets.py::masked_log_softmax_backward)
//   dl_j = mask_j ? g_j + ((-T) / S) * e_j : 0,   T = sum_j g_j
// and the heads' Dense backward (rl/nets.py::dense_backward, no ReLU)
//   G = bf16(dl),   db = bf16(sum over the rows of float(G)).
// Every sum is ops/physics.py::tree_sum_last's halving tree (zero-padded
// to a power of two): S and T over a row's entries, db over the rows (over
// more than 256 rows, whole 256-row tiles first, rd::tiled_column_tree).
// `expf` is CUDA's accurate function (no fast math), the one torch's CUDA
// `exp` calls, so with -fmad=false the kernel is bitwise equal to its plain
// version (rl/nets.py::heads_backward_plain) on the card.
//
// Bound on the card: bytes (and launch latency).  It reads the logits, the
// masks and g and writes G of both heads, 11 B an entry (45 KB at B = 256
// and 8 + 8 entries), and the bias gradients.
// Design: one launch for both heads and both steps (it replaces B5f's
// backward and two standalone B5d backward launches).  A row's statistics
// are a segment of s = min(P, 32) lanes' work (P the head's padded size):
// entry j at lane j % s of the segment, register j / s, so m is a shuffle
// butterfly and S and T are tree_sum_last's tree (register levels, then
// shuffles from the segment's padded half), a warp taking 32 / s rows at
// once, and a lane loading several rows' entries (8 at most) before it
// works any of them out.  A block of 16 warps per (group of 8 columns of
// one head, 256-row tile) works out its tile's row statistics (from L2)
// and writes G and float(G) of its 8 columns, then one warp a column sums
// the tile (rd::column_tree) or, over several tiles, the group's last
// block to arrive (rd::block_arrives_last) takes the tiled tree from G.
// (A block per 32 rows of both heads, the last block taking every
// column's tree, was timed against it and is 3x slower: PERF.md §6.)
// The arrival counts are reset by the last block, so the kernel replays in
// a CUDA graph.  No host read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;  // a column group: one warp a column's tree
constexpr int kMaxN = 256;        // a head's entries
constexpr float kNegMask = -1e9f;
// a padding entry's place in the row's max: below every entry
#define kPad __int_as_float(0xff800000)

struct Head {
  const float* l;
  const uint8_t* m;
  const float* g;
  bf16* G;
  bf16* db;
  int n;
};

// torch's max on the card: NaN-propagating (the sign of a zero maximum
// does not reach the gradient: exp(+-0) = 1)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// One row of head h as a segment of s lanes holds it (s = min(P, 32), P =
// RJ s the padded size): entry j = sub + s k at lane sub of the segment,
// register k < RJ.
template <int RJ>
struct RowIn {
  float x[RJ], g[RJ];
  bool ok[RJ], mk[RJ];
};

// the row's loads (`in` false: a row past the rows, nothing loaded)
template <int RJ>
__device__ __forceinline__ void row_load(const Head& h, int row, bool in, int s,
                                         RowIn<RJ>& v) {
  const int sub = threadIdx.x & (s - 1);
#pragma unroll
  for (int k = 0; k < RJ; ++k) {
    const int j = sub + s * k;
    const long long o = (long long)row * h.n + j;
    v.ok[k] = in && j < h.n;
    v.mk[k] = v.ok[k] && __ldg(h.m + o) != 0;
    v.x[k] = v.mk[k] ? __ldg(h.l + o) : v.ok[k] ? kNegMask : kPad;
    v.g[k] = v.ok[k] ? __ldg(h.g + o) : 0.0f;
  }
}

// The logits' gradient dl of U loaded rows, their steps interleaved (U
// independent chains of shuffles, exponentials and divisions in flight):
// every lane of the warp calls it (its shuffles stay inside each segment:
// the levels below s)
template <int RJ, int U>
__device__ __forceinline__ void rows_grad(const RowIn<RJ> (&v)[U], int s,
                                          float (&dl)[U][RJ]) {
  const int head = (threadIdx.x & 31) & ~(s - 1);
  float m[U], ts[U][RJ], tg[U][RJ];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    m[u] = v[u].x[0];
#pragma unroll
    for (int k = 1; k < RJ; ++k) m[u] = max_nan(m[u], v[u].x[k]);
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    if (o < s)
#pragma unroll
      for (int u = 0; u < U; ++u)
        m[u] = max_nan(m[u], __shfl_xor_sync(rd::kFullMask, m[u], o));
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < RJ; ++k) {
      dl[u][k] = v[u].ok[k] ? expf(v[u].x[k] - m[u]) : 0.0f;  // e, for now
      ts[u][k] = dl[u][k];
      tg[u][k] = v[u].g[k];
    }
#pragma unroll
  for (int d = RJ / 2; d >= 1; d >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < d; ++k) {
        ts[u][k] = ts[u][k] + ts[u][k + d];
        tg[u][k] = tg[u][k] + tg[u][k + d];
      }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    if (o < s)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ts[u][0] = ts[u][0] + __shfl_down_sync(rd::kFullMask, ts[u][0], o);
        tg[u][0] = tg[u][0] + __shfl_down_sync(rd::kFullMask, tg[u][0], o);
      }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float S = __shfl_sync(rd::kFullMask, ts[u][0], head);
    const float T = __shfl_sync(rd::kFullMask, tg[u][0], head);
    const float ds = (-T) / S;
#pragma unroll
    for (int k = 0; k < RJ; ++k)
      dl[u][k] = v[u].mk[k] ? v[u].g[k] + ds * dl[u][k] : 0.0f;
  }
}

// rows a lane works at once: 4 entries' loads and chains in flight
template <int RJ>
constexpr int kAhead = RJ >= 4 ? 1 : 4 / RJ;

// A block's tile: rows m0 .. m0 + 255 of head h in passes of
// the block's warps (32 / s rows a warp a pass), kAhead passes at once;
// G and float(G) (+0.0 past R) of the group's columns c0 .. c0 + 7 into G
// and tree [256][kCols + 1]
template <int RJ>
__device__ __forceinline__ void group_tile(const Head& h, int m0, int R,
                                           int c0, float* tree) {
  constexpr int U = kAhead<RJ>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = RJ > 1 ? 32 : rd::pow2_at_least(h.n), rpw = 32 / s;
  const int passes = (rd::kTileRows + kWarps * rpw - 1) / (kWarps * rpw);
  for (int p0 = 0; p0 < passes; p0 += U) {
    RowIn<RJ> v[U];
    float dl[U][RJ];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = ((p0 + u) * kWarps + warp) * rpw + lane / s;
      row_load<RJ>(h, m0 + t, p0 + u < passes && t < rd::kTileRows && m0 + t < R,
                   s, v[u]);
    }
    rows_grad<RJ, U>(v, s, dl);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = ((p0 + u) * kWarps + warp) * rpw + lane / s, row = m0 + t;
#pragma unroll
      for (int k = 0; k < RJ; ++k) {
        const int j = (lane & (s - 1)) + s * k;
        if (p0 + u < passes && t < rd::kTileRows && j >= c0 && j < c0 + kCols &&
            j < h.n) {
          const bf16 b = __float2bfloat16_rn(dl[u][k]);
          if (row < R) h.G[(long long)row * h.n + j] = b;
          tree[t * (kCols + 1) + j - c0] = row < R ? __bfloat162float(b) : 0.0f;
        }
      }
    }
  }
}

// the instance of a head's padded size: RJ = P / 32 registers a lane
#define BY_WIDTH(h, CALL)                             \
  switch (rd::pow2_at_least((h).n)) {                 \
    case 64: CALL(2); break;                          \
    case 128: CALL(4); break;                         \
    case 256: CALL(8); break;                         \
    default: CALL(1); break;                          \
  }

__global__ void __launch_bounds__(kThreads)
    heads_backward_kernel(Head h0, Head h1, unsigned* counters, int R) {
  __shared__ float tree[rd::kTileRows * (kCols + 1)];
  const int g0 = (h0.n + kCols - 1) / kCols;
  const bool second = (int)blockIdx.x >= g0;
  const Head h = second ? h1 : h0;
  const int c0 = ((int)blockIdx.x - (second ? g0 : 0)) * kCols;
  const int m0 = blockIdx.y * rd::kTileRows;
#define TILE(RJ) group_tile<RJ>(h, m0, R, c0, tree)
  BY_WIDTH(h, TILE)
#undef TILE
  const int c = threadIdx.x >> 5;
  float sum = 0.0f;
  if (gridDim.y == 1) {
    __syncthreads();
    if (c < kCols) sum = rd::column_tree(tree, kCols + 1, c, rd::pow2_at_least(R));
  } else {
    if (!rd::block_arrives_last(counters + blockIdx.x, gridDim.y,
                                reinterpret_cast<int*>(tree)))
      return;
    sum = rd::tiled_column_tree<kCols, kThreads>(h.G, h.n, R, h.n, c0, tree);
  }
  if ((threadIdx.x & 31) == 0 && c < kCols && c0 + c < h.n)
    h.db[c0 + c] = __float2bfloat16_rn(sum);
}

#undef BY_WIDTH

}  // namespace

// Plain C entry point (bound with ctypes).  For both heads (k = 0: the DC
// head, n0 entries; k = 1: the GPU-count head, n1): logits float32 [R, n],
// mask bool [R, n], g float32 [R, n] (dL/dlogp), all contiguous; writes G
// bf16 [R, n] (contiguous) and db bf16 [n].  1 <= R <= 4,096, n <= 256;
// counters: zeroed uint32, one a column group (rd::kMaxCounters), left at
// 0.  Returns the launch's cudaError_t, or -1 for a shape the kernel does
// not take.
extern "C" int heads_backward_launch(const void* l0, const void* m0,
                                     const void* g0, void* G0, void* db0,
                                     int n0, const void* l1, const void* m1,
                                     const void* g1, void* G1, void* db1,
                                     int n1, void* counters, int R,
                                     void* stream) {
  const int groups = (n0 + kCols - 1) / kCols + (n1 + kCols - 1) / kCols;
  if (R < 1 || R > rd::kMaxTiles * rd::kTileRows || n0 < 1 || n1 < 1 ||
      n0 > kMaxN || n1 > kMaxN || groups > rd::kMaxCounters ||
      counters == nullptr)
    return -1;
  const Head h0{reinterpret_cast<const float*>(l0),
                reinterpret_cast<const uint8_t*>(m0),
                reinterpret_cast<const float*>(g0), reinterpret_cast<bf16*>(G0),
                reinterpret_cast<bf16*>(db0), n0};
  const Head h1{reinterpret_cast<const float*>(l1),
                reinterpret_cast<const uint8_t*>(m1),
                reinterpret_cast<const float*>(g1), reinterpret_cast<bf16*>(G1),
                reinterpret_cast<bf16*>(db1), n1};
  const dim3 grid(groups, (R + rd::kTileRows - 1) / rd::kTileRows);
  heads_backward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      h0, h1, reinterpret_cast<unsigned*>(counters), R);
  return (int)cudaGetLastError();
}
