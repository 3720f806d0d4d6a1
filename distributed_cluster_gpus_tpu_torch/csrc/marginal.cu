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
// does ~4 operations per element of it.  One launch per call, one block per
// batch row.  The target (redesigned for the H100 after the actor term):
// lane i holds quantile i, so each twin's quantiles of an action are one
// coalesced 128-byte load; warp w owns the actions a = w (mod W), so every
// level of the tree over A of distance >= W stays in that warp's
// registers, taken depth first as the leaves load, and only the last
// log2(W) levels cross warps, through shared memory in one warp; the
// row's pi and alpha log pi are put in shared memory once (one barrier),
// and r_eff, the discount and the write of target_q stay on the lane that
// writes.  The actor term: each twin-min row of N quantiles is one warp's
// coalesced load (16-byte loads where the rows are aligned) and its tree
// over N stays in registers and shuffles (eight actions a warp in flight),
// whose sum one lane turns into the action's terms; the trees over A and
// the per-head gradient trees are one warp's registers and shuffles, so a
// row costs one block barrier; the shared memory is the row's terms, sized
// at the launch.  Each row's warp counts its arrival (a fence and an
// atomic); the last one sums the B row values by the tree in its registers
// and shuffles and resets the count, so the kernel replays in a CUDA
// graph.  Both take A <= 1,024 joint actions of heads of up to 256 entries
// (the update's envelope, kernels/envelope.py).
//
// Folded in from the update's plain-torch tail (rl/sac.py:268-273, :293,
// :304-310 and rl/cmdp.py:65, their port's sites rl/sac.py:458-513): both
// read log alpha and take alpha = exp(log alpha) themselves; the target's
// rows count their arrivals too, and the last block's warp 0 takes the
// batch means of r_eff and of each cost's violation max(0, costs[b, k] -
// target[k]) by the tree over b, then the PID step on the multipliers
// (integral += err; lam = min(max(kp err + ki integral + kd (err -
// prev_err), 0), lam_max); prev_err = err, rl/cmdp.py::update_lagrange's
// order), writing the CMDP state in place and the metrics: every block
// read lam before it arrived, so the writes follow every read.  The actor
// term's batch tail also takes the temperature's loss and its gradient,
// written out by hand (x_b = H[b] + target_entropy):
//   entropy    = tree_b(H) / B
//   alpha_loss = tree_b(alpha * x_b) / B
//   d alpha_loss / d log alpha = tree_b(x_b * (1 / B)) * alpha
// the reverse of jax.value_and_grad of mean(exp(log alpha) * x) (the
// mean's cotangent 1 / B, the product's, the sum over b, exp's).

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kMaxA = 1024;     // padded joint actions
constexpr int kMaxHead = 256;   // padded head size
constexpr int kMaxCosts = 16;
constexpr int kMaxB = 8192;  // the actor's batch rows at most
constexpr int kMaxN = 8192;  // quantiles (the actor's tree over N: 256 a lane)

__device__ __forceinline__ float min_nan(float x, float y) {
  // torch.minimum on the card: NaN-propagating, else fminf
  return x != x ? x : (y != y ? y : fminf(x, y));
}

struct QView {
  const float* q;
  long long sb, st, sa;  // strides (floats) of the batch, twin, action axes
  __device__ __forceinline__ float min2(int b, int a, int i) const {
    const float* p = q + b * sb + a * sa + i;
    return min_nan(p[0], p[st]);
  }
};

// The target's batch tail: the means over the batch and the PID step
// (counter null: no tail).
struct PidTail {
  unsigned* counter;
  const float *target, *kp, *ki, *kd, *lam_max;
  float *lam, *integral, *prev_err;       // the CMDP state, in place
  float *r_eff_mean, *lam_out, *viol_out;  // the metrics
};

// The tree over b of leaf(b) (0 past B), by one warp: element k at lane k %
// 32, register k / 32; the sum in lane 0.
template <class Leaf>
__device__ __forceinline__ float batch_tree(int B, const Leaf& leaf) {
  const int lane = threadIdx.x & 31, Bp = rd::pow2_at_least(B);
  const float sum = rd::tree_regs(Bp > 32 ? Bp >> 5 : 1, 0.0f, [&](int r) {
    const int k = lane + 32 * r;
    return k < B ? leaf(k) : 0.0f;
  });
  return rd::warp_tree(sum, Bp < 32 ? Bp : 32);
}

// By the target's last block, its W warps side by side (warp w the trees
// c = w, w + W, ...): r_eff's batch mean (c = n_costs), each cost's mean
// violation and its PID step (rl/cmdp.py::update_lagrange, op for op)
// Constraint c's PID inputs (its target, gains and memories)
struct PidIn {
  float tgt, kp, ki, kd, lmax, integral, prev;
};

__device__ __forceinline__ PidIn pid_in(const PidTail& t, int c) {
  return {t.target[c], t.kp[c], t.ki[c], t.kd[c], t.lam_max[c],
          t.integral[c], t.prev_err[c]};
}

// `mine`: constraint `warp`'s inputs, read by every block at its start (so
// the last block finds them in registers)
__device__ __forceinline__ void pid_tail(const PidTail& t, const PidIn& mine,
                                         const float* r_eff,
                                         const float* costs, int B,
                                         int n_costs, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fB = (float)B;
  for (int c = warp; c <= n_costs; c += W) {
    if (c == n_costs) {
      const float rm = batch_tree(B, [&](int k) { return __ldcg(r_eff + k); });
      if (lane == 0) *t.r_eff_mean = rm / fB;
      continue;
    }
    const PidIn in = c == warp ? mine : pid_in(t, c);
    const float s = batch_tree(B, [&](int k) {
      const float x = costs[k * n_costs + c] - in.tgt;
      return x != x ? x : fmaxf(x, 0.0f);
    });
    if (lane == 0) {
      const float err = s / fB;
      const float integral = in.integral + err;
      const float deriv = err - in.prev;
      const float x = in.kp * err + in.ki * integral + in.kd * deriv;
      const float lam = min_nan(x != x ? x : fmaxf(x, 0.0f), in.lmax);
      t.lam[c] = lam;
      t.integral[c] = integral;
      t.prev_err[c] = err;
      t.lam_out[c] = lam;
      t.viol_out[c] = err;
    }
  }
}

// The target: a block of W warps per batch row b.  Each block first puts
// the row's joint policy in shared memory (pi[a] and alpha * logpi[a], one
// barrier).  Then lane i holds quantile i (+ 32 per further pass over N):
// twin t's N quantiles of action a are one coalesced 128-byte load of the
// warp.  Warp w owns the actions a = w + W j, j < J = Ap / W: the halving
// tree's levels over Ap of distance >= W pair two actions of one warp (a
// and a + d, d a multiple of W), so they are the tree over j in the lane's
// registers, taken as the leaves load (rd::tree_regs: depth first up to 16
// leaves, streamed above, eight loads in flight); the last log2(W) levels,
// over w, run in warp 0 from shared memory.  W divides Ap (the plan takes
// W <= Ap), so no level adds padding the plain tree does not.  Each lane
// of warp 0 then takes r_eff's tree over the costs, gamma * (1 - done) and
// writes target_q[b, i].
template <int W>
__global__ void __launch_bounds__(32 * W)
    marginal_target_kernel(QView qv, const float* __restrict__ logp_dc,
                           const float* __restrict__ logp_g,
                           const float* __restrict__ r,
                           const float* __restrict__ costs,
                           const float* __restrict__ lam,
                           const float* __restrict__ targets,
                           const float* __restrict__ done,
                           const float* __restrict__ log_alpha, float gamma,
                           float* __restrict__ target_q, float* r_eff_out,
                           PidTail tail, int B, int n_dc, int n_g, int N,
                           int n_costs) {
  extern __shared__ float smem[];  // pi [Ap], alpha logpi [Ap], sums [W][32]
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int A = n_dc * n_g, Ap = rd::pow2_at_least(A), J = Ap / W;
  float* s_pi = smem;
  float* s_al = smem + Ap;
  float* s_w = smem + 2 * Ap;
  PidIn mine{};
  if (tail.counter != nullptr && warp < n_costs) mine = pid_in(tail, warp);
  {
    const float alpha = expf(*log_alpha);
    for (int a = threadIdx.x; a < A; a += 32 * W) {
      const float l = logp_dc[b * n_dc + a / n_g] + logp_g[b * n_g + a % n_g];
      s_pi[a] = expf(l);
      s_al[a] = alpha * l;
    }
  }
  float reff = 0.0f, disc = 0.0f;
  if (warp == 0) {  // r_eff and the discount, on every lane that writes
    float v[kMaxCosts];
    const int Kp = rd::pow2_at_least(n_costs);
#pragma unroll
    for (int k = 0; k < kMaxCosts; ++k) {
      const float x = k < n_costs ? costs[b * n_costs + k] - targets[k] : 0.0f;
      v[k] = k < n_costs ? lam[k] * (x != x ? x : fmaxf(x, 0.0f)) : 0.0f;
    }
#pragma unroll
    for (int h = kMaxCosts / 2; h >= 1; h >>= 1)
      if (2 * h <= Kp) {
#pragma unroll
        for (int k = 0; k < h; ++k) v[k] = v[k] + v[k + h];
      }
    reff = r[b] - v[0];
    disc = gamma * (1.0f - done[b]);
  }
  __syncthreads();
  const float* qb = qv.q + b * qv.sb;
  for (int i0 = 0; i0 < N; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < N;
    float v = rd::tree_regs(J, 0.0f, [&](int j) {
      const int a = warp + W * j;
      if (a >= A || !in) return 0.0f;
      const float* p = qb + a * qv.sa + i;
      return s_pi[a] * (min_nan(p[0], p[qv.st]) - s_al[a]);
    });
    if (W > 1) {
      s_w[warp * 32 + lane] = v;
      __syncthreads();
      if (warp == 0)
        v = rd::tree_static<W>(
            [&](auto w) { return s_w[decltype(w)::value * 32 + lane]; });
      __syncthreads();  // s_w free for the next pass
    }
    if (warp == 0 && in) target_q[b * N + i] = reff + disc * v;
  }
  if (threadIdx.x == 0) r_eff_out[b] = reff;
  if (tail.counter == nullptr) return;
  // this row's read of lam (warp 0's r_eff) is done: one arrival a block,
  // by thread 0 after its write of r_eff (the flag in s_w, free after the
  // passes); the last block's warps take the batch tail, the count reset
  // for the next launch
  int* flag = reinterpret_cast<int*>(s_w);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last_row = atomicAdd(tail.counter, 1u) == gridDim.x - 1;
    if (last_row) *tail.counter = 0u;
    *flag = last_row;
  }
  __syncthreads();
  if (!*flag) return;
  pid_tail(tail, mine, r_eff_out, costs, B, n_costs, W);
}

// The actor term: a block per batch row, kActorWarps warps.  Phase 1, all
// warps: each action's twin-min row is one warp's tree over N (at N = 32
// with 16-byte aligned rows, eight actions a warp at once, a float4 per
// lane: quantiles 4l..4l+3 of one of four actions, the levels of distance
// 16, 8 and 4 shuffles within eight lanes, 2 and 1 in the registers; else
// one action at a time, quantile i at lane i % 32, register i / 32); its
// sum goes to one lane, which takes the action's terms
// (pi log pi, pi qm, the gradient g) into shared memory, the
// log-probabilities loaded beside the quantiles.  Phase 2, warp 0 alone
// (actor_row): the trees over A (action a at lane a % 32, register a / 32)
// and the per-head gradient trees over the padded [Dp, Gp] layout, in
// registers and shuffles; then its arrival, and the last row's warp sums
// the B row values.
constexpr int kActorWarps = 8;
constexpr int kActorAhead = 8;   // actions a warp loads at once (N = 32)
constexpr int kMaxRA = kMaxA / 32;  // registers of the trees over A
// registers of the padded [Dp, Gp] layout: Dp Gp <= 2,048 for A <= 1,024
// (Dp Gp = 4,096 would need more than n_dc > Dp / 2 times n_g > Gp / 2)
constexpr int kMaxRE = 64;

// Phase 2 and the batch tail, by warp 0 of row b's block, with RA / RE
// registers for the trees over A / the padded heads (Ap <= 32 RA, Dp Gp
// <= 32 RE); DC x G, where not 0, are the heads' sizes fixed at compile
// time (powers of two), so every loop and guard folds.
// The actor term's temperature outputs (entropy null: none).
struct TempTail {
  float target_entropy;
  float *entropy, *alpha_loss, *alpha_grad;
};

template <int RA, int RE, int DC = 0, int G = 0>
__device__ __forceinline__ void actor_row(
    const float* s_pl, const float* s_pq, const float* s_g, float alpha,
    float* __restrict__ loss, float* ent,
    float* __restrict__ d_dc, float* __restrict__ d_g, float* partial,
    unsigned* counter, const TempTail& temp, int b, int B, int n_dc_run,
    int n_g_run) {
  const int lane = threadIdx.x & 31;
  const int n_dc = DC ? DC : n_dc_run, n_g = G ? G : n_g_run;
  const int A = n_dc * n_g, Ap = rd::pow2_at_least(A);
  const float fB = (float)B;
  const int ra = Ap > 32 ? Ap >> 5 : 1;
  // the trees over A, one after the other (registers: the widest layout's)
  auto over_a = [&](const float* src) {
    float x[RA];
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int a = lane + 32 * r;
      x[r] = r < ra && a < A ? src[a] : 0.0f;
    }
    rd::tree_strided(x, 1, Ap, ra);
    return x[0];
  };
  const float pl = over_a(s_pl), pq = over_a(s_pq);
  // the gradient at e = d * Gp + c, zero in the padding: per DC over the
  // GPU counts (segments of Gp), per GPU count over the DCs (stride Gp)
  const int Gp = rd::pow2_at_least(n_g), Dp = rd::pow2_at_least(n_dc);
  const int E = Dp * Gp, re = E > 32 ? E >> 5 : 1;
  int gbits = 0;
  while ((1 << gbits) < Gp) ++gbits;
#pragma unroll 1
  for (int head = 0; head < 2; ++head) {  // one head's registers at a time
    float v[RE];
#pragma unroll
    for (int r = 0; r < RE; ++r) {
      const int e = lane + 32 * r, d = e >> gbits, c = e & (Gp - 1);
      v[r] = r < re && e < E && d < n_dc && c < n_g ? s_g[d * n_g + c] : 0.0f;
    }
    if (head == 0) {
      rd::tree_strided(v, 1, Gp, re);
#pragma unroll
      for (int r = 0; r < RE; ++r) {
        const int e = lane + 32 * r, d = e >> gbits, c = e & (Gp - 1);
        if (r < re && e < E && c == 0 && d < n_dc)
          d_dc[b * n_dc + d] = -(v[r] / fB);
      }
    } else {
      rd::tree_strided(v, Gp, Dp, re);
#pragma unroll
      for (int r = 0; r < RE; ++r) {
        const int e = lane + 32 * r;
        if (r < re && e < n_g) d_g[b * n_g + e] = -(v[r] / fB);
      }
    }
  }
  bool last = false;
  if (lane == 0) {
    const float h = -pl;
    ent[b] = h;
    partial[b] = pq + alpha * h;
    last = rd::arrive_last(counter);
  }
  if (!__shfl_sync(rd::kFullMask, last, 0)) return;
  __syncwarp();  // the other lanes' loads after lane 0 saw the count
  // the last row's warp: the tree over b, element k at lane k % 32,
  // register k / 32
  // (and, with the temperature, of H, alpha x_b and x_b (1 / B), x_b =
  // H[b] + target_entropy, beside it: one pass of loads)
  const int Bp = rd::pow2_at_least(B), p = Bp < 32 ? Bp : 32;
  const bool tt = temp.entropy != nullptr;
  const float inv_b = 1.0f / fB, te = temp.target_entropy;
  const rd::Quad s = rd::tree_regs(
      Bp > 32 ? Bp >> 5 : 1, rd::Quad{0.0f, 0.0f, 0.0f, 0.0f},
      [&](int r) -> rd::Quad {
        const int k = lane + 32 * r;
        if (k >= B) return {0.0f, 0.0f, 0.0f, 0.0f};
        const float v = __ldcg(partial + k);
        if (!tt) return {v, 0.0f, 0.0f, 0.0f};
        const float h = __ldcg(ent + k), xb = h + te;
        return {v, h, alpha * xb, xb * inv_b};
      });
  const float sv = rd::warp_tree(s.a, p), sh = rd::warp_tree(s.b, p);
  const float xl = rd::warp_tree(s.c, p), xg = rd::warp_tree(s.d, p);
  if (tt && lane == 0) {
    *temp.entropy = sh / fB;
    *temp.alpha_loss = xl / fB;
    *temp.alpha_grad = xg * alpha;
  }
  if (lane == 0) {
    *loss = -(sv / fB);
    *counter = 0u;  // ready for the next launch on this stream
  }
}

template <int RA, int RE, int DC = 0, int G = 0>
__global__ void __launch_bounds__(32 * kActorWarps, 1)
    marginal_actor_kernel(QView qv, const float* __restrict__ logp_dc,
                          const float* __restrict__ logp_g,
                          const float* __restrict__ log_alpha,
                          float* __restrict__ loss, float* ent,
                          float* __restrict__ d_dc, float* __restrict__ d_g,
                          float* partial, unsigned* counter, TempTail temp,
                          int B, int n_dc, int n_g, int N, int vec) {
  extern __shared__ float smem[];  // pi log pi, pi qm, g: [Ap] each
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int A = n_dc * n_g, Ap = rd::pow2_at_least(A);
  const int Np = rd::pow2_at_least(N);
  const float fN = (float)N, alpha = expf(*log_alpha);
  float* s_pl = smem;
  float* s_pq = smem + Ap;
  float* s_g = smem + 2 * Ap;
  // joint action a's log-probability, and its terms once qm[a] is known
  auto logpi = [&](int a) {
    return logp_dc[b * n_dc + a / n_g] + logp_g[b * n_g + a % n_g];
  };
  auto terms = [&](int a, float qm, float l) {
    const float p = expf(l);
    s_pl[a] = p * l;
    s_pq[a] = p * qm;
    s_g[a] = p * (qm - alpha * (l + 1.0f));
  };
  // ---- phase 1: qm[a] = tree_i(min over twins) / N, and the terms
  if (vec) {  // N = 32, 16-byte rows: 4 actions a float4 load
    for (int a0 = warp * kActorAhead; a0 < A; a0 += kActorWarps * kActorAhead) {
      const int au = a0 + lane;  // lane u < kActorAhead takes action a0 + u
      const bool mine = lane < kActorAhead && au < A;
      const float l = mine ? logpi(au) : 0.0f;
      float s[2];
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        const int a = a0 + 4 * grp + (lane >> 3);
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y = x;
        if (a < A) {
          const float* p = qv.q + b * qv.sb + a * qv.sa + 4 * (lane & 7);
          x = __ldg(reinterpret_cast<const float4*>(p));
          y = __ldg(reinterpret_cast<const float4*>(p + qv.st));
        }
        float m[4] = {min_nan(x.x, y.x), min_nan(x.y, y.y), min_nan(x.z, y.z),
                      min_nan(x.w, y.w)};
#pragma unroll
        for (int h = 4; h >= 1; h >>= 1) {  // distances 16, 8, 4
#pragma unroll
          for (int v = 0; v < 4; ++v)
            m[v] = m[v] + __shfl_down_sync(rd::kFullMask, m[v], h);
        }
        s[grp] = (m[0] + m[2]) + (m[1] + m[3]);  // distances 2, 1
      }
      // action a0 + u's sum sits in lane 8 (u % 4) of group u / 4
      const float x0 = __shfl_sync(rd::kFullMask, s[0], 8 * (lane & 3));
      const float x1 = __shfl_sync(rd::kFullMask, s[1], 8 * (lane & 3));
      if (mine) terms(au, (lane < 4 ? x0 : x1) / fN, l);
    }
  } else {  // any N: one action a warp at a time
    for (int a = warp; a < A; a += kActorWarps) {
      const float l = lane == 0 ? logpi(a) : 0.0f;
      float s = rd::tree_regs(Np > 32 ? Np >> 5 : 1, 0.0f, [&](int r) {
        const int i = lane + 32 * r;
        return i < N ? qv.min2(b, a, i) : 0.0f;
      });
      s = rd::warp_tree(s, Np < 32 ? Np : 32);
      if (lane == 0) terms(a, s / fN, l);
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // ---- phase 2, one warp, its registers sized for the shape (the
  // launch picks the instance: a wide shape's registers do not cost the
  // published one's occupancy)
  actor_row<RA, RE, DC, G>(s_pl, s_pq, s_g, alpha, loss, ent, d_dc, d_g,
                           partial, counter, temp, b, B, n_dc, n_g);
}

int check_view(int A, int N, int n_dc, int n_g) {
  if (n_dc < 1 || n_g < 1 || N < 1 || N > kMaxN ||
      rd::pow2_at_least(A) > kMaxA)
    return -1;
  if (rd::pow2_at_least(n_dc) > kMaxHead || rd::pow2_at_least(n_g) > kMaxHead)
    return -1;
  return 0;
}

template <int W>
int target_launch(const QView& qv, const void* logp_dc, const void* logp_g,
                  const void* r, const void* costs, const void* lam,
                  const void* targets, const void* done, const void* log_alpha,
                  float gamma, void* target_q, void* r_eff,
                  const PidTail& tail, int B, int n_dc, int n_g, int N,
                  int n_costs, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * rd::pow2_at_least(n_dc * n_g) + 32 * W);
  marginal_target_kernel<W><<<B, 32 * W, smem, stream>>>(
      qv, (const float*)logp_dc, (const float*)logp_g, (const float*)r,
      (const float*)costs, (const float*)lam, (const float*)targets,
      (const float*)done, (const float*)log_alpha, gamma, (float*)target_q,
      (float*)r_eff, tail, B, n_dc, n_g, N, n_costs);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  q: the [B, 2, A, N] float32
// quantiles with strides (sb, st, sa) in floats and unit stride over N;
// logp_dc [B, n_dc], logp_g [B, n_g], r/done [B], costs [B, n_costs],
// lam/targets [n_costs] float32 contiguous; log alpha one float on the
// device.  Return the cudaError_t of the launch, or -1 for shapes they do
// not take.  The target's warps a row, W, come from kernels/sac_update.py::
// target_warps: a power of two, at most 32 and at most the padded A, with
// at most 256 actions a warp.  Its batch tail, where `counter` is not null
// (one uint32, 0 at the launch and left 0): pid = the PID's target, kp,
// ki, kd, lam_max [n_costs] read, its lam, integral, prev_err [n_costs]
// written in place, and the metrics r_eff_mean (one float), lam_out and
// viol_out [n_costs].
extern "C" int marginal_target_launch(
    const void* q, long long sb, long long st, long long sa,
    const void* logp_dc, const void* logp_g, const void* r, const void* costs,
    const void* lam, const void* targets, const void* done,
    const void* log_alpha, float gamma, void* target_q, void* r_eff, int B,
    int n_dc, int n_g, int N, int n_costs, int W, void* counter,
    const uint64_t* pid, void* stream) {
  const int Ap = rd::pow2_at_least(n_dc * n_g);
  if (B < 1 || check_view(n_dc * n_g, N, n_dc, n_g) || n_costs < 1 ||
      n_costs > kMaxCosts || W < 1 || W > 32 || (W & (W - 1)) || W > Ap ||
      Ap / W > 256 || (counter != nullptr && B > kMaxB))
    return -1;
  PidTail tail{};
  if (counter != nullptr) {
    tail.counter = (unsigned*)counter;
    tail.target = (const float*)pid[0];
    tail.kp = (const float*)pid[1];
    tail.ki = (const float*)pid[2];
    tail.kd = (const float*)pid[3];
    tail.lam_max = (const float*)pid[4];
    tail.lam = (float*)pid[5];
    tail.integral = (float*)pid[6];
    tail.prev_err = (float*)pid[7];
    tail.r_eff_mean = (float*)pid[8];
    tail.lam_out = (float*)pid[9];
    tail.viol_out = (float*)pid[10];
  }
  const QView qv{(const float*)q, sb, st, sa};
  cudaStream_t s = (cudaStream_t)stream;
#define TARGET(w)                                                             \
  case w:                                                                     \
    return target_launch<w>(qv, logp_dc, logp_g, r, costs, lam, targets, done, \
                            log_alpha, gamma, target_q, r_eff, tail, B, n_dc, \
                            n_g, N, n_costs, s);
  switch (W) {
    TARGET(1) TARGET(2) TARGET(4) TARGET(8) TARGET(16) TARGET(32)
  }
#undef TARGET
  return -1;
}

// loss one float, ent [B], d_dc [B, n_dc], d_g [B, n_g]; partial B floats
// of scratch, counter one uint32, 0 at the launch and left at 0; the
// temperature's outputs, one float each (entropy null: none).
extern "C" int marginal_actor_launch(
    const void* q, long long sb, long long st, long long sa,
    const void* logp_dc, const void* logp_g, const void* log_alpha,
    void* loss, void* ent, void* d_dc, void* d_g, void* partial,
    void* counter, float target_entropy, void* entropy, void* alpha_loss,
    void* alpha_grad, int B, int n_dc, int n_g, int N, void* stream) {
  if (B < 1 || B > kMaxB || check_view(n_dc * n_g, N, n_dc, n_g)) return -1;
  QView qv{(const float*)q, sb, st, sa};
  const int A = n_dc * n_g;
  const size_t smem = sizeof(float) * 3 * rd::pow2_at_least(A);
  // 16-byte loads of the twin rows where they are aligned
  const int vec = N == 32 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                  sb % 4 == 0 && st % 4 == 0 && sa % 4 == 0;
  const int Ap = rd::pow2_at_least(A);
  const int E = rd::pow2_at_least(n_dc) * rd::pow2_at_least(n_g);
  auto kernel = marginal_actor_kernel<kMaxRA, kMaxRE>;
  if (n_dc == 8 && n_g == 8)  // the published heads
    kernel = marginal_actor_kernel<2, 2, 8, 8>;
  else if (Ap <= 64 && E <= 64)
    kernel = marginal_actor_kernel<2, 2>;
  else if (Ap <= 256 && E <= 256)
    kernel = marginal_actor_kernel<8, 8>;
  if (entropy != nullptr && (alpha_loss == nullptr || alpha_grad == nullptr))
    return -1;
  const TempTail temp{target_entropy, (float*)entropy, (float*)alpha_loss,
                      (float*)alpha_grad};
  kernel<<<B, 32 * kActorWarps, smem, (cudaStream_t)stream>>>(
      qv, (const float*)logp_dc, (const float*)logp_g,
      (const float*)log_alpha, (float*)loss, (float*)ent, (float*)d_dc,
      (float*)d_g, (float*)partial, (unsigned*)counter, temp, B, n_dc, n_g,
      N, vec);
  return (int)cudaGetLastError();
}
