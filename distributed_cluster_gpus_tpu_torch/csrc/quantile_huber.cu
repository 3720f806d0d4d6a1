// B5a, the quantile-Huber loss and its gradient, on Hopper (sm_90a): the
// port of the XLA-fused `quantile_huber_loss` (distributed_cluster_gpus_tpu/
// rl/sac.py:178), called once per twin at :242-243, and of its gradient
// under jax.value_and_grad.  The JAX package has no Pallas kernel; this
// replaces the jnp [B, N, M] broadcast, the Huber select, the weight, the
// means and their transposes.
//
// What it computes, for both twins at once (q [B, 2, N], target [B, M],
// taus [N], kappa):
//   td  = target[b, j] - q[b, t, i]
//   h   = |td| <= kappa ? 0.5 * (td * td) : kappa * (|td| - 0.5 * kappa)
//   w   = |taus[i] - (td < 0 ? 1 : 0)|
//   row = tree_i( tree_j(w * h) / M )             per (b, t)
//   loss = tree_b(row[., 0]) / B + tree_b(row[., 1]) / B
//   grad[b, t, i] = -((tree_j(w * dh) / M) / B),  dh = |td| <= kappa ? td
//                                                   : (td > 0 ? kappa : -kappa)
// with every sum the fixed halving tree that the plain version
// (rl/sac.py::quantile_huber_loss) takes with tree_sum_last, in the same
// order: over j, then i, then b.  Built with -fmad=false, so it is bitwise
// equal to the plain version on the card.  The gradient is written in the
// forward (the loss is the last op of the critic's graph).
//
// Folded in from the update's plain-torch tail (rl/sac.py:242-243 take the
// taken action's quantiles; `jnp.mean(q)` is the q_mean metric):
//   * the taken action: q may hold every joint action, [B, 2, A, N] (the
//     heads critic's output), read at a = a_dc[b] * n_g + a_g[b]; the
//     gradient then has q's shape, zero but at the taken action (the
//     scatter of the taken quantiles' gradient into the heads);
//   * q_mean = (tree_b(tree_i(q[b, 0, i])) + tree_b(tree_i(q[b, 1, i])))
//     / (2 B N) of the taken quantiles, beside the loss in the batch tail;
//   * the loss and q_mean written where the caller says (the update's
//     metric buffers).
//
// Bound on the card: operations, barely.  A call reads q (2BN floats),
// target (BM) and taus and writes grad (2BN) and the loss: 80 KB at the
// published B = 256, N = M = 32; it does ~2BNM x 20 float32 operations
// (10.5M, 0.16 us at 67 TFLOP/s).  So a call is its launch, one wave and
// the batch tail's latency.  Design: one warp per (b, t), every lane busy:
// lane i holds quantile i (and i + 32 when N > 32), the target row sits in
// the warp's registers (lane l: j = l, l + 32) and each leaf takes its
// target by a shuffle; the tree over j is a register tree unrolled for the
// padded M (one instance per power of two, chosen at the launch), taken
// depth first so only log2(M) partial sums are live; the tree over i is a
// register add (N > 32) and shuffles from the padded half.  No shared
// memory.  A block holds kRows batch rows; after one barrier it counts one
// arrival (a fence and an atomic), and the last block's warp 0 sums
// both twins' B rows by the same tree (rd::tree_regs over each lane's
// registers, then shuffles) and resets the count, so the kernel replays in
// a CUDA graph.  One launch per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kMaxQ = 64;    // N and M at most (padded to a power of two)
constexpr int kMaxB = 4096;  // batch rows at most
constexpr int kRows = 2;     // batch rows a block, a warp per twin of each
constexpr int kThreads = 64 * kRows;

// The taken action of each batch row, where q holds every joint action.
struct Take {
  const int* a_dc;  // null: q holds the taken action alone (A = 1)
  const int* a_g;
  int A, n_g;
};

template <int Mp>
__global__ void __launch_bounds__(kThreads)
    quantile_huber_kernel(const float* __restrict__ q,
                          const float* __restrict__ target,
                          const float* __restrict__ taus, float* loss,
                          float* q_mean, float* __restrict__ grad,
                          float* partial, unsigned* counter, Take take, int B,
                          int N, int M, float kappa, float half_kappa) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = warp & 1;
  const int b = blockIdx.x * kRows + (warp >> 1);
  const float fM = (float)M, fB = (float)B;
  if (b < B) {
    const int Np = rd::pow2_at_least(N);
    const float* trow = target + (long long)b * M;
    const float t_lo = lane < M ? trow[lane] : 0.0f;
    const float t_hi = Mp > 32 && lane + 32 < M ? trow[lane + 32] : 0.0f;
    const int a = take.a_dc == nullptr ? 0 : take.a_dc[b] * take.n_g + take.a_g[b];
    const long long row0 = ((long long)b * 2 + t) * take.A * N;
    const long long qrow = row0 + (long long)a * N;
    if (take.A > 1) {
      // the gradient of the actions not taken: zero (a row of A N floats,
      // the taken action's N written below)
      for (long long e = lane; e < (long long)take.A * N; e += 32)
        if (e < (long long)a * N || e >= (long long)(a + 1) * N)
          grad[row0 + e] = 0.0f;
    }
    // quantile i's mean over j of w * h (0 for a padding quantile) and the
    // quantile itself; its gradient written on the way
    auto quantile = [&](int i) -> rd::Pair {
      const bool in = i < N;
      const float qv = in ? q[qrow + i] : 0.0f;
      const float tau = in ? taus[i] : 0.0f;
      const rd::Pair s = rd::tree_static<Mp>([&](auto J) -> rd::Pair {
        constexpr int j = decltype(J)::value;
        const float tj =
            __shfl_sync(rd::kFullMask, j < 32 ? t_lo : t_hi, j & 31);
        if (j >= M) return {0.0f, 0.0f};
        const float td = tj - qv;
        const float a = fabsf(td);
        const bool small = a <= kappa;
        const float h = small ? 0.5f * (td * td) : kappa * (a - half_kappa);
        const float w = fabsf(tau - (td < 0.0f ? 1.0f : 0.0f));
        return {w * h, w * (small ? td : (td > 0.0f ? kappa : -kappa))};
      });
      if (in) grad[qrow + i] = -((s.b / fM) / fB);
      return {in ? s.a / fM : 0.0f, qv};
    };
    rd::Pair row = quantile(lane);
    if (Np > 32) row = rd::add(row, quantile(lane + 32));  // distance 32
    const float rl = rd::warp_tree(row.a, Np < 32 ? Np : 32);
    const float rq = rd::warp_tree(row.b, Np < 32 ? Np : 32);
    if (lane == 0) {
      partial[t * B + b] = rl;
      partial[(2 + t) * B + b] = rq;
    }
  }
  __syncthreads();  // the block's partials, then one arrival for them
  if (warp != 0) return;
  bool last = false;
  if (lane == 0) last = rd::arrive_last(counter);
  if (!__shfl_sync(rd::kFullMask, last, 0)) return;
  __syncwarp();  // the other lanes' loads after lane 0 saw the count
  // the last block's warp 0: both twins' trees over b, element k at lane
  // k % 32, register k / 32
  // (and, for q_mean, the taken quantiles' trees over b, per twin, beside
  // them: one pass of loads)
  const int Bp = rd::pow2_at_least(B);
  const bool qm = q_mean != nullptr;
  const rd::Quad s = rd::tree_regs(
      Bp > 32 ? Bp >> 5 : 1, rd::Quad{0.0f, 0.0f, 0.0f, 0.0f},
      [&](int r) -> rd::Quad {
        const int k = lane + 32 * r;
        if (k >= B) return {0.0f, 0.0f, 0.0f, 0.0f};
        const float l0 = __ldcg(partial + k), l1 = __ldcg(partial + B + k);
        if (!qm) return {l0, l1, 0.0f, 0.0f};
        return {l0, l1, __ldcg(partial + 2 * B + k),
                __ldcg(partial + 3 * B + k)};
      });
  const int p = Bp < 32 ? Bp : 32;
  const float s0 = rd::warp_tree(s.a, p), s1 = rd::warp_tree(s.b, p);
  const float m0 = rd::warp_tree(s.c, p), m1 = rd::warp_tree(s.d, p);
  if (lane == 0) {
    *loss = s0 / fB + s1 / fB;
    if (q_mean != nullptr) *q_mean = (m0 + m1) / (float)(2 * B * N);
    *counter = 0u;  // ready for the next launch on this stream
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B, 2, A, N] (A = 1: the
// taken action's quantiles alone, a_dc and a_g null; else every joint
// action, a = a_dc[b] * n_g + a_g[b] from int32 [B] a_dc, a_g), target
// [B, M], taus [N], grad like q, float32 contiguous; loss one float, q_mean
// one float or null; partial 4B floats of scratch; counter one uint32, 0
// at the launch and left at 0.  Returns the cudaError_t of the launch, or
// -1 for shapes the kernel does not take.
extern "C" int quantile_huber_launch(const void* q, const void* target,
                                     const void* taus, void* loss,
                                     void* q_mean, void* grad, void* partial,
                                     void* counter, const void* a_dc,
                                     const void* a_g, int A, int n_g, int B,
                                     int N, int M, float kappa,
                                     float half_kappa, void* stream) {
  if (B < 1 || B > kMaxB || N < 1 || N > kMaxQ || M < 1 || M > kMaxQ ||
      A < 1 || (A > 1 && (a_dc == nullptr || a_g == nullptr || n_g < 1)))
    return -1;
  const Take take{A > 1 ? (const int*)a_dc : nullptr, (const int*)a_g, A, n_g};
  decltype(&quantile_huber_kernel<1>) kernel;
  switch (rd::pow2_at_least(M)) {  // the tree over j unrolled for its width
    case 1: kernel = quantile_huber_kernel<1>; break;
    case 2: kernel = quantile_huber_kernel<2>; break;
    case 4: kernel = quantile_huber_kernel<4>; break;
    case 8: kernel = quantile_huber_kernel<8>; break;
    case 16: kernel = quantile_huber_kernel<16>; break;
    case 32: kernel = quantile_huber_kernel<32>; break;
    default: kernel = quantile_huber_kernel<64>; break;
  }
  kernel<<<(B + kRows - 1) / kRows, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)target, (const float*)taus, (float*)loss,
      (float*)q_mean, (float*)grad, (float*)partial, (unsigned*)counter, take,
      B, N, M, kappa, half_kappa);
  return (int)cudaGetLastError();
}
