// B5b, the exact marginalization over joint actions, on Hopper (sm_90a):
// the port of the XLA-fused critic target and actor term of
// `sac_train_step` (distributed_cluster_gpus_tpu/rl/sac.py:223-236 and the
// `actor_loss_fn` at :251-266), with `_joint_policy` (:187) and the
// Lagrangian `effective_reward` (rl/cmdp.py:59).  The JAX package has no
// Pallas kernel; this replaces the jnp broadcasts, exp, twin min and the
// sums over the n_dc x n_g joint actions (A of them, a = a_dc * n_g + a_g).
//
// marginal_target (no gradient), per batch row b:
//   r_eff   = r - tree_k(lam[k] * max(0, costs[b, k] - targets[k]))
//   logpi   = logp_dc[b, a / n_g] + logp_g[b, a % n_g],   pi = exp(logpi)
//   v1[i]   = tree_a(pi * (min(q[b, 0, a, i], q[b, 1, a, i]) - alpha * logpi))
//   target_q[b, i] = r_eff + (gamma * (1 - done[b])) * v1[i]
// marginal_actor (forward and the gradient the backward scales):
//   qm[a]   = tree_i(min over twins) / N
//   H[b]    = -tree_a(pi * logpi),   val[b] = tree_a(pi * qm) + alpha * H[b]
//   loss    = -(tree_b(val) / B)
//   g[a]    = pi * (qm - alpha * (logpi + 1))             (dval / dlogpi)
//   dlogp_dc[b, d] = -(tree_g(g[d * n_g + g]) / B)
//   dlogp_g[b, g]  = -(tree_d(g[d * n_g + g]) / B)
// Every sum is the fixed halving tree (reduce.cuh), in the order the plain
// versions (rl/sac.py::marginal_target, ::marginal_actor) take with
// tree_sum_last; built with -fmad=false, both are bitwise equal to them on
// the card.  A masked action (logit -1e9) has pi = exp(-1e9 - lse) = 0, so
// pi * anything finite stays 0 (pi * logpi is -0), in the value and in the
// gradient; a head with every action masked is uniform, as its masked
// log-softmax makes it.  q [B, 2, A, N] is read through its strides, so the
// one-hot critic's [B, A, 2, N] product needs no transpose.
//
// Bound on the card: bytes.  Each call reads q once (B * 2 * A * N floats,
// 4 MB at the published B = 256, A = 64, N = 32, 1.25 us at 3.35 TB/s) and
// does ~4 operations per element of it.  Design: one block per batch row;
// its A x N products or twin minima go to shared memory and the block sums
// them by the tree; the actor's last block to finish (an atomic count) sums
// the B row values.  One launch per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 8192;  // padded A x padded N floats in shared memory
constexpr int kMaxA = 256;      // padded joint actions
constexpr int kMaxHead = 64;    // padded head size
constexpr int kMaxCosts = 16;
constexpr int kMaxB = kMaxTile;  // rows the actor's last block sums

struct QView {
  const float* q;
  long long sb, st, sa;  // strides (floats) of the batch, twin, action axes
  __device__ __forceinline__ float min2(int b, int a, int i) const {
    const float* p = q + b * sb + a * sa + i;
    const float x = p[0], y = p[st];
    // torch.minimum on the card: NaN-propagating, else fminf
    return x != x ? x : (y != y ? y : fminf(x, y));
  }
};

__device__ __forceinline__ void joint_policy(const float* logp_dc,
                                             const float* logp_g, int b,
                                             int n_dc, int n_g, int Ap,
                                             float* logpi, float* pi) {
  const int A = n_dc * n_g;
  for (int a = threadIdx.x; a < Ap; a += blockDim.x) {
    if (a < A) {
      const float l = logp_dc[b * n_dc + a / n_g] + logp_g[b * n_g + a % n_g];
      logpi[a] = l;
      pi[a] = expf(l);
    } else {
      logpi[a] = 0.0f;
      pi[a] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    marginal_target_kernel(QView qv, const float* __restrict__ logp_dc,
                           const float* __restrict__ logp_g,
                           const float* __restrict__ r,
                           const float* __restrict__ costs,
                           const float* __restrict__ lam,
                           const float* __restrict__ targets,
                           const float* __restrict__ done,
                           const float* __restrict__ alpha_p, float gamma,
                           float* __restrict__ target_q,
                           float* __restrict__ r_eff_out, int n_dc, int n_g,
                           int N, int n_costs) {
  __shared__ float tile[kMaxTile];  // [N][Ap]: the products, summed over a
  __shared__ float logpi[kMaxA], pi[kMaxA];
  __shared__ float s_reff;
  const int b = blockIdx.x, A = n_dc * n_g, Ap = rd::pow2_at_least(A);
  const float alpha = *alpha_p;
  if (threadIdx.x == 0) {
    float v[kMaxCosts];
    const int Kp = rd::pow2_at_least(n_costs);
    for (int k = 0; k < Kp; ++k) {
      if (k < n_costs) {
        const float x = costs[b * n_costs + k] - targets[k];
        v[k] = lam[k] * (x != x ? x : fmaxf(x, 0.0f));
      } else {
        v[k] = 0.0f;
      }
    }
    s_reff = r[b] - rd::tree_local(v, Kp);
  }
  joint_policy(logp_dc, logp_g, b, n_dc, n_g, Ap, logpi, pi);
  __syncthreads();
  for (int e = threadIdx.x; e < N * Ap; e += blockDim.x) {
    const int i = e / Ap, a = e % Ap;
    tile[e] = a < A ? pi[a] * (qv.min2(b, a, i) - alpha * logpi[a]) : 0.0f;
  }
  rd::tree_rows(tile, N, Ap, Ap);
  const float reff = s_reff;
  const float disc = gamma * (1.0f - done[b]);
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    target_q[b * N + i] = reff + disc * tile[i * Ap];
  if (threadIdx.x == 0) r_eff_out[b] = reff;
}

__global__ void __launch_bounds__(kThreads)
    marginal_actor_kernel(QView qv, const float* __restrict__ logp_dc,
                          const float* __restrict__ logp_g,
                          const float* __restrict__ alpha_p,
                          float* __restrict__ loss, float* __restrict__ ent,
                          float* __restrict__ d_dc, float* __restrict__ d_g,
                          float* partial, unsigned* counter, int B, int n_dc,
                          int n_g, int N) {
  __shared__ float tile[kMaxTile];  // [A][Np] twin minima; later the rows
  __shared__ float logpi[kMaxA], pi[kMaxA], pl[kMaxA], pq[kMaxA], g[kMaxA];
  __shared__ bool last;
  const int b = blockIdx.x, A = n_dc * n_g, Ap = rd::pow2_at_least(A);
  const int Np = rd::pow2_at_least(N);
  const float alpha = *alpha_p, fN = (float)N, fB = (float)B;
  joint_policy(logp_dc, logp_g, b, n_dc, n_g, Ap, logpi, pi);
  for (int e = threadIdx.x; e < A * Np; e += blockDim.x) {
    const int a = e / Np, i = e % Np;
    tile[e] = i < N ? qv.min2(b, a, i) : 0.0f;
  }
  rd::tree_rows(tile, A, Np, Np);
  for (int a = threadIdx.x; a < Ap; a += blockDim.x) {
    if (a < A) {
      const float qm = tile[a * Np] / fN;
      pl[a] = pi[a] * logpi[a];
      pq[a] = pi[a] * qm;
      g[a] = pi[a] * (qm - alpha * (logpi[a] + 1.0f));
    } else {
      pl[a] = 0.0f;
      pq[a] = 0.0f;
    }
  }
  __syncthreads();
  // the gradient: per DC over the GPU-count head, per GPU count over DCs
  const int Gp = rd::pow2_at_least(n_g), Dp = rd::pow2_at_least(n_dc);
  for (int k = threadIdx.x; k < n_dc + n_g; k += blockDim.x) {
    float v[kMaxHead];
    if (k < n_dc) {
      for (int j = 0; j < Gp; ++j) v[j] = j < n_g ? g[k * n_g + j] : 0.0f;
      d_dc[b * n_dc + k] = -(rd::tree_local(v, Gp) / fB);
    } else {
      const int c = k - n_dc;
      for (int j = 0; j < Dp; ++j) v[j] = j < n_dc ? g[j * n_g + c] : 0.0f;
      d_g[b * n_g + c] = -(rd::tree_local(v, Dp) / fB);
    }
  }
  rd::tree_rows(pl, 1, Ap, Ap);
  rd::tree_rows(pq, 1, Ap, Ap);
  if (threadIdx.x == 0) {
    const float h = -pl[0];
    ent[b] = h;
    partial[b] = pq[0] + alpha * h;
    last = rd::arrive_last(counter);
  }
  __syncthreads();
  if (!last) return;
  const int Bp = rd::pow2_at_least(B);
  for (int k = threadIdx.x; k < Bp; k += blockDim.x)
    tile[k] = k < B ? __ldcg(partial + k) : 0.0f;
  rd::tree_rows(tile, 1, Bp, Bp);
  if (threadIdx.x == 0) {
    *loss = -(tile[0] / fB);
    *counter = 0u;  // ready for the next launch on this stream
  }
}

int check_view(int A, int N, int n_dc, int n_g) {
  const int Ap = rd::pow2_at_least(A), Np = rd::pow2_at_least(N);
  if (n_dc < 1 || n_g < 1 || N < 1 || Ap > kMaxA) return -1;
  if (rd::pow2_at_least(n_dc) > kMaxHead || rd::pow2_at_least(n_g) > kMaxHead)
    return -1;
  if ((long long)Ap * Np > kMaxTile) return -1;
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes).  q: the [B, 2, A, N] float32
// quantiles with strides (sb, st, sa) in floats and unit stride over N;
// logp_dc [B, n_dc], logp_g [B, n_g], r/done [B], costs [B, n_costs],
// lam/targets [n_costs] float32 contiguous; alpha one float on the device.
// Return the cudaError_t of the launch, or -1 for shapes they do not take.
extern "C" int marginal_target_launch(
    const void* q, long long sb, long long st, long long sa,
    const void* logp_dc, const void* logp_g, const void* r, const void* costs,
    const void* lam, const void* targets, const void* done, const void* alpha,
    float gamma, void* target_q, void* r_eff, int B, int n_dc, int n_g, int N,
    int n_costs, void* stream) {
  if (B < 1 || check_view(n_dc * n_g, N, n_dc, n_g) ||
      (long long)N * rd::pow2_at_least(n_dc * n_g) > kMaxTile ||
      n_costs < 1 || rd::pow2_at_least(n_costs) > kMaxCosts)
    return -1;
  QView qv{(const float*)q, sb, st, sa};
  marginal_target_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      qv, (const float*)logp_dc, (const float*)logp_g, (const float*)r,
      (const float*)costs, (const float*)lam, (const float*)targets,
      (const float*)done, (const float*)alpha, gamma, (float*)target_q,
      (float*)r_eff, n_dc, n_g, N, n_costs);
  return (int)cudaGetLastError();
}

// loss one float, ent [B], d_dc [B, n_dc], d_g [B, n_g]; partial B floats
// of scratch, counter one uint32, 0 at the launch and left at 0.
extern "C" int marginal_actor_launch(
    const void* q, long long sb, long long st, long long sa,
    const void* logp_dc, const void* logp_g, const void* alpha, void* loss,
    void* ent, void* d_dc, void* d_g, void* partial, void* counter, int B,
    int n_dc, int n_g, int N, void* stream) {
  if (B < 1 || B > kMaxB || check_view(n_dc * n_g, N, n_dc, n_g) ||
      (long long)(n_dc * n_g) * rd::pow2_at_least(N) > kMaxTile)
    return -1;
  QView qv{(const float*)q, sb, st, sa};
  marginal_actor_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      qv, (const float*)logp_dc, (const float*)logp_g, (const float*)alpha,
      (float*)loss, (float*)ent, (float*)d_dc, (float*)d_g, (float*)partial,
      (unsigned*)counter, B, n_dc, n_g, N);
  return (int)cudaGetLastError();
}
