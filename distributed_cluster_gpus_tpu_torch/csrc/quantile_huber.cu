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
// with every sum the fixed halving tree (reduce.cuh) that the plain version
// (rl/sac.py::quantile_huber_loss) takes with tree_sum_last, in the same
// order: over j, then i, then b.  Built with -fmad=false, so it is bitwise
// equal to the plain version on the card.  The gradient is written in the
// forward (the loss is the last op of the critic's graph); the autograd
// binding scales it by the incoming gradient.
//
// Bound on the card: operations, barely.  A call reads q (2BN floats),
// target (BM) and taus and writes grad (2BN) and the loss: 80 KB at the
// published B = 256, N = M = 32; it does ~2BNM x 20 float32 operations
// (10.5M, 0.16 us at 67 TFLOP/s).  Design: one block per batch row, one
// thread per (twin, quantile), each thread folding its M terms by the tree
// in its own memory; the block sums a twin's N quantile means by the tree in
// shared memory; the last block to finish (an atomic count) sums the B rows
// by the tree.  One launch per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kMaxQ = 64;      // N and M at most (padded to a power of two)
constexpr int kMaxB = 4096;    // rows the last block sums in shared memory
constexpr int kThreads = 2 * kMaxQ;

__global__ void __launch_bounds__(kThreads)
    quantile_huber_kernel(const float* __restrict__ q,
                          const float* __restrict__ target,
                          const float* __restrict__ taus, float* loss,
                          float* __restrict__ grad, float* partial,
                          unsigned* counter, int B, int N, int M,
                          float kappa, float half_kappa) {
  __shared__ float rows[2 * kMaxQ];
  __shared__ float sums[2 * kMaxB];
  __shared__ bool last;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Np = rd::pow2_at_least(N), Mp = rd::pow2_at_least(M);
  const float fM = (float)M, fB = (float)B;
  if (tid < 2 * Np) {
    const int t = tid / Np, i = tid % Np;
    float row = 0.0f;
    if (i < N) {
      float e[kMaxQ], d[kMaxQ];
      const float qv = q[((long long)b * 2 + t) * N + i];
      const float tau = taus[i];
      for (int j = 0; j < Mp; ++j) {
        if (j < M) {
          const float td = target[(long long)b * M + j] - qv;
          const float a = fabsf(td);
          const bool small = a <= kappa;
          const float h = small ? 0.5f * (td * td) : kappa * (a - half_kappa);
          const float w = fabsf(tau - (td < 0.0f ? 1.0f : 0.0f));
          e[j] = w * h;
          d[j] = w * (small ? td : (td > 0.0f ? kappa : -kappa));
        } else {
          e[j] = 0.0f;
          d[j] = 0.0f;
        }
      }
      row = rd::tree_local(e, Mp) / fM;
      grad[((long long)b * 2 + t) * N + i] = -((rd::tree_local(d, Mp) / fM) / fB);
    }
    rows[t * Np + i] = row;
  }
  rd::tree_rows(rows, 2, Np, Np);
  if (tid == 0) {
    partial[b] = rows[0];
    partial[B + b] = rows[Np];
    last = rd::arrive_last(counter);
  }
  __syncthreads();
  if (!last) return;
  const int Bp = rd::pow2_at_least(B);
  for (int e = tid; e < 2 * Bp; e += blockDim.x) {
    const int t = e / Bp, k = e % Bp;
    sums[e] = k < B ? __ldcg(partial + t * B + k) : 0.0f;
  }
  rd::tree_rows(sums, 2, Bp, Bp);
  if (tid == 0) {
    *loss = sums[0] / fB + sums[Bp] / fB;
    *counter = 0u;  // ready for the next launch on this stream
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B, 2, N], target [B, M],
// taus [N], grad [B, 2, N] float32 contiguous; loss one float; partial 2B
// floats of scratch; counter one uint32, 0 at the launch and left at 0.  Returns the cudaError_t of
// the launch, or -1 for shapes the kernel does not take.
extern "C" int quantile_huber_launch(const void* q, const void* target,
                                     const void* taus, void* loss, void* grad,
                                     void* partial, void* counter, int B,
                                     int N, int M, float kappa,
                                     float half_kappa, void* stream) {
  if (B < 1 || B > kMaxB || N < 1 || N > kMaxQ || M < 1 || M > kMaxQ)
    return -1;
  quantile_huber_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)target, (const float*)taus, (float*)loss,
      (float*)grad, (float*)partial, (unsigned*)counter, B, N, M, kappa,
      half_kappa);
  return (int)cudaGetLastError();
}
