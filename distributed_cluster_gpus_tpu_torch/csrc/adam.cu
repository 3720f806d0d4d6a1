// B5c, clipped Adam with the Polyak target and the temperature clamp, on
// Hopper (sm_90a): the port of the XLA-fused optimizer step of
// `sac_train_step` (distributed_cluster_gpus_tpu/rl/sac.py:279-288 and
// :300-302): optax's `clip_by_global_norm(5.0)` then `adam(3e-4)` (`_tx`,
// :117) applied to each parameter group, the critic's Polyak target
// `(1 - tau) * t + tau * o`, and log alpha's `min(., log(alpha_max))`.  The
// JAX package has no Pallas kernel.
//
// What it computes for each group of a table (the update's four: critic,
// actor, encoder, log alpha), each held in one flat float32 buffer of n
// elements (p, its gradient g, the moments mu and nu, the step count; g
// float32, or bf16 widened exactly as it is read: the networks' hand-written
// gradients are staged in bf16):
//   ss     = sum g^2: the buffer read as [K, R, 256, 4] (zero-padded), each
//            thread (k, j) folding its R float4s' squares in order, each
//            block's 256 partials and then the K block sums by the halving
//            tree (rl/optim.py::sum_squares, the same order)
//   gn     = sqrt(ss);  g = gn < max_norm ? g : (g / gn) * max_norm
//   mu     = c1 * g + b1 * mu;   nu = c2 * (g * g) + b2 * nu
//   count  = count + 1 (saturating);  bc = 1 - (float)pow((double)b, count)
//            (x64, the float64 clock's run: optax under jax_enable_x64,
//            bc = (float)(1 - pow(b64, count)) with b64 the double decay)
//   u      = (mu / bc1) / (sqrt(nu / bc2 + 0) + eps);  p = p + u * (-lr)
//   target = (1 - tau) * target + tau * p     (when a target is given)
//   p      = min(p, clamp)                    (when clamped)
//   shadow = bf16(p), target shadow = bf16(target)   (where given)
//   exp_out = exp(p)                          (where given: log alpha's
//                                              group writes the alpha metric)
// which is rl/optim.py::clip_adam_update (optax's order) op for op; built
// with -fmad=false, the two are bitwise equal on the card.
//
// B5g, the casts XLA fuses into the JAX package's `sac_train_step`
// (rl/sac.py:206-310: flax's bf16 `Dense` rounds each parameter to bf16
// before its product, and the cast's transpose widens each bf16 gradient
// for optax), runs inside these two launches: the gradient's widening as
// the passes read it, and the shadows the next update's products read
// (bf16(p) after the step, bf16(target) after the Polyak step: the casts at
// that update's head, of the parameters it starts from) as the elementwise
// pass writes p and the target.  kernels/param_pack.py fills the shadows
// once outside the update (csrc/param_pack.cu).
//
// Bound on the card: bytes.  A step reads g (2 B in bf16), p, mu, nu (and
// the target) and writes p, mu, nu, the shadow (and the target and its
// shadow): 28 B per element, 38 with the target; the four groups' 502,097
// parameters move 16.9 MB, 5.0 us at 3.35 TB/s.
// Design: two launches for all the groups, from a table of groups in the
// launch's parameters, every block knowing its group from the table's
// block offsets.  (1) The norm: a block per 1,024 elements of a group's
// gradient (float4 loads, ~490 blocks at the published sizes), each writing
// its partial; the group's first block also steps the count and computes
// the two bias corrections (the float64 powers, once a group).  (2) The
// elementwise pass: a block per 1,024 elements again, a float4 of each of
// p, g, mu, nu (and the target) per thread, loaded first; meanwhile every
// block sums its group's K partials by the tree (K <= 282 at the published
// sizes: a read from L2 and a tree in shared memory, no grid-wide
// handshake), so the loads from device memory overlap the norm.  No host
// read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kMaxBlocks = 1024;  // partials per group (the tree's width)
constexpr int kMaxGroups = 8;
constexpr int kInt32Max = 2147483647;

struct Group {
  float *p, *mu, *nu, *target;
  const void* g;  // float32, or bf16 where g_bf16
  __nv_bfloat16 *shadow, *tshadow;  // bf16(p), bf16(target), or null
  float* exp_out;                   // exp(p), or null
  int* count;
  long long n;
  int first_block, K, R, has_target, has_clamp, g_bf16;
  float clamp;
};

struct Table {
  Group grp[kMaxGroups];
  int n_groups;
  float c1, b1, c2, b2, eps, neg_lr, max_norm, omt, tau;
  int x64;          // the bias corrections in double (AdamConfig.x64)
  double b1d, b2d;  // the double decays (x64)
};

__device__ __forceinline__ int group_of(const Table& t, int block) {
  int k = 0;
  while (k + 1 < t.n_groups && block >= t.grp[k + 1].first_block) ++k;
  return k;
}

// the float4 at float index e of x (elements at or past n read 0)
__device__ __forceinline__ float4 load4(const float* x, long long e,
                                        long long n) {
  if (e + kVec <= n) return *reinterpret_cast<const float4*>(x + e);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < n) v.x = x[e];
  if (e + 1 < n) v.y = x[e + 1];
  if (e + 2 < n) v.z = x[e + 2];
  return v;
}

__device__ __forceinline__ void store4(float* x, long long e, long long n,
                                       float4 v) {
  if (e + kVec <= n) {
    *reinterpret_cast<float4*>(x + e) = v;
    return;
  }
  if (e < n) x[e] = v.x;
  if (e + 1 < n) x[e + 1] = v.y;
  if (e + 2 < n) x[e + 2] = v.z;
}

// the gradient's four elements at e, widened from bf16 where it is bf16
// (exact: the bf16 bits are the float's upper half)
__device__ __forceinline__ float4 load_g(const Group& G, long long e) {
  if (!G.g_bf16) return load4(reinterpret_cast<const float*>(G.g), e, G.n);
  const uint16_t* h = reinterpret_cast<const uint16_t*>(G.g);
  uint32_t w[kVec] = {0u, 0u, 0u, 0u};
  if (e + kVec <= G.n) {
    const uint2 u = *reinterpret_cast<const uint2*>(h + e);
    w[0] = u.x << 16;
    w[1] = u.x & 0xffff0000u;
    w[2] = u.y << 16;
    w[3] = u.y & 0xffff0000u;
  } else {
    for (int i = 0; i < kVec; ++i)
      if (e + i < G.n) w[i] = (uint32_t)h[e + i] << 16;
  }
  return make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                     __uint_as_float(w[2]), __uint_as_float(w[3]));
}

// bf16(v[i]) into the shadow at e (round to nearest even, as torch's
// `.to(bfloat16)` and csrc/param_pack.cu)
__device__ __forceinline__ void store_bf16(__nv_bfloat16* x, long long e,
                                           long long n, const float* v) {
  if (e + kVec <= n) {
    alignas(8) __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                                      __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(x + e) = *reinterpret_cast<const uint2*>(h);
    return;
  }
  for (int i = 0; i < kVec; ++i)
    if (e + i < n) x[e + i] = __float2bfloat16_rn(v[i]);
}

__global__ void __launch_bounds__(kThreads)
    adam_norm_kernel(const __grid_constant__ Table t,
                     float* __restrict__ partial, float* __restrict__ bc) {
  __shared__ float s[kThreads];
  const int gi = group_of(t, blockIdx.x);
  const Group& G = t.grp[gi];
  const int k = blockIdx.x - G.first_block;
  if (k == 0 && threadIdx.x == 32) {
    // the group's new count and its bias corrections, while the other warps
    // load (nothing else reads the count until the next update)
    const int c0 = *G.count;
    const int c = c0 < kInt32Max ? c0 + 1 : c0;
    *G.count = c;
    if (t.x64) {
      bc[2 * gi] = (float)(1.0 - pow(t.b1d, (double)c));
      bc[2 * gi + 1] = (float)(1.0 - pow(t.b2d, (double)c));
    } else {
      bc[2 * gi] = 1.0f - (float)pow((double)t.b1, (double)c);
      bc[2 * gi + 1] = 1.0f - (float)pow((double)t.b2, (double)c);
    }
  }
  float acc = 0.0f;
  for (int r = 0; r < G.R; ++r) {
    const long long e =
        ((long long)(k * G.R + r) * kThreads + threadIdx.x) * kVec;
    const float4 v = load_g(G, e);
    if (r == 0) {
      acc = v.x * v.x;
    } else {
      acc = acc + v.x * v.x;
    }
    acc = acc + v.y * v.y;
    acc = acc + v.z * v.z;
    acc = acc + v.w * v.w;
  }
  s[threadIdx.x] = acc;
  rd::tree_rows(s, 1, kThreads, kThreads);
  if (threadIdx.x == 0) partial[blockIdx.x] = s[0];
}

__global__ void __launch_bounds__(kThreads)
    adam_apply_kernel(const __grid_constant__ Table t,
                      const float* __restrict__ partial,
                      const float* __restrict__ bc) {
  __shared__ float s[kMaxBlocks];
  const int gi = group_of(t, blockIdx.x);
  const Group& G = t.grp[gi];
  const long long e0 =
      ((long long)(blockIdx.x - G.first_block) * kThreads + threadIdx.x) * kVec;
  const long long stride = (long long)G.K * kThreads * kVec;
  // this thread's first elements, loaded before the norm is known
  float4 g4, p4, m4, v4, t4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e0 < G.n) {
    g4 = load_g(G, e0);
    p4 = load4(G.p, e0, G.n);
    m4 = load4(G.mu, e0, G.n);
    v4 = load4(G.nu, e0, G.n);
    if (G.has_target) t4 = load4(G.target, e0, G.n);
  }
  // the group's norm: its K partials by the tree (zero-padded to a power
  // of two), in every block of the group
  const int P = rd::pow2_at_least(G.K);
  for (int i = threadIdx.x; i < P; i += kThreads)
    s[i] = i < G.K ? partial[G.first_block + i] : 0.0f;
  rd::tree_rows(s, 1, P, P);
  const float gn = sqrtf(s[0]), bc1 = bc[2 * gi], bc2 = bc[2 * gi + 1];
  const bool keep = gn < t.max_norm;
  for (long long e = e0; e < G.n; e += stride) {
    if (e != e0) {
      g4 = load_g(G, e);
      p4 = load4(G.p, e, G.n);
      m4 = load4(G.mu, e, G.n);
      v4 = load4(G.nu, e, G.n);
      if (G.has_target) t4 = load4(G.target, e, G.n);
    }
    float gs[kVec] = {g4.x, g4.y, g4.z, g4.w};
    float ps[kVec] = {p4.x, p4.y, p4.z, p4.w};
    float ms[kVec] = {m4.x, m4.y, m4.z, m4.w};
    float vs[kVec] = {v4.x, v4.y, v4.z, v4.w};
    float ts[kVec] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float gi_ = gs[i];
      if (!keep) gi_ = (gi_ / gn) * t.max_norm;
      const float m = t.c1 * gi_ + t.b1 * ms[i];
      const float v = t.c2 * (gi_ * gi_) + t.b2 * vs[i];
      const float u = (m / bc1) / (sqrtf(v / bc2 + 0.0f) + t.eps);
      float pn = ps[i] + u * t.neg_lr;
      if (G.has_target) ts[i] = t.omt * ts[i] + t.tau * pn;
      if (G.has_clamp) pn = pn != pn ? pn : fminf(pn, G.clamp);
      ps[i] = pn;
      ms[i] = m;
      vs[i] = v;
    }
    store4(G.p, e, G.n, make_float4(ps[0], ps[1], ps[2], ps[3]));
    store4(G.mu, e, G.n, make_float4(ms[0], ms[1], ms[2], ms[3]));
    store4(G.nu, e, G.n, make_float4(vs[0], vs[1], vs[2], vs[3]));
    if (G.has_target)
      store4(G.target, e, G.n, make_float4(ts[0], ts[1], ts[2], ts[3]));
    if (G.shadow != nullptr) store_bf16(G.shadow, e, G.n, ps);
    if (G.exp_out != nullptr)
      store4(G.exp_out, e, G.n,
             make_float4(expf(ps[0]), expf(ps[1]), expf(ps[2]), expf(ps[3])));
    if (G.tshadow != nullptr) store_bf16(G.tshadow, e, G.n, ts);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  For each of n_groups groups:
// ptrs[9k..9k+8] = p, g, mu, nu, target (or 0), count (one int32), shadow
// (or 0), target shadow (or 0), exp_out (or 0) on the device, the float32
// buffers 16-byte aligned, the bf16 ones 8-byte aligned; ns[k] its n; KR[2k], KR[2k+1]
// its K blocks and R float4s a thread (rl/optim.py::norm_layout);
// flags[k] bit 0 a target, bit 1 a clamp, bit 2 a bf16 gradient; clamps[k]
// the clamp.  `consts`
// holds (1-b1, b1, 1-b2, b2, eps, -lr, max_norm, 1-tau, tau) as float32;
// `decays` (b1, b2) as double, read when `x64` is set.
// Scratch: `partial` (the sum of the K floats), `bc` (2 n_groups floats).
// Returns the first failing launch's cudaError_t, or -1 for a bad table.
extern "C" int adam_launch(const uint64_t* ptrs, const long long* ns,
                           const int* KR, const int* flags,
                           const float* clamps, int n_groups,
                           const float* consts, int x64,
                           const double* decays, void* partial, void* bc,
                           void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return -1;
  Table t;
  t.n_groups = n_groups;
  int blocks = 0;
  for (int k = 0; k < n_groups; ++k) {
    Group& G = t.grp[k];
    const uint64_t* q = ptrs + 9 * k;
    G.p = reinterpret_cast<float*>(q[0]);
    G.g = reinterpret_cast<const void*>(q[1]);
    G.mu = reinterpret_cast<float*>(q[2]);
    G.nu = reinterpret_cast<float*>(q[3]);
    G.target = reinterpret_cast<float*>(q[4]);
    G.count = reinterpret_cast<int*>(q[5]);
    G.shadow = reinterpret_cast<__nv_bfloat16*>(q[6]);
    G.tshadow = reinterpret_cast<__nv_bfloat16*>(q[7]);
    G.exp_out = reinterpret_cast<float*>(q[8]);
    G.n = ns[k];
    G.K = KR[2 * k];
    G.R = KR[2 * k + 1];
    G.has_target = flags[k] & 1;
    G.has_clamp = (flags[k] >> 1) & 1;
    G.g_bf16 = (flags[k] >> 2) & 1;
    G.clamp = clamps[k];
    G.first_block = blocks;
    if (G.n < 1 || G.K < 1 || G.K > kMaxBlocks || G.R < 1 ||
        (long long)G.K * G.R * kThreads * kVec < G.n ||
        (long long)(G.K - 1) * G.R * kThreads * kVec >= G.n ||
        (G.has_target && G.target == nullptr) ||
        (G.tshadow != nullptr && !G.has_target))
      return -1;
    for (int i = 0; i < 5; ++i)
      if (q[i] % (i == 1 && G.g_bf16 ? 8 : 16) != 0) return -1;
    if (q[6] % 8 != 0 || q[7] % 8 != 0 || q[8] % 16 != 0) return -1;
    blocks += G.K;
  }
  t.c1 = consts[0];
  t.b1 = consts[1];
  t.c2 = consts[2];
  t.b2 = consts[3];
  t.eps = consts[4];
  t.neg_lr = consts[5];
  t.max_norm = consts[6];
  t.omt = consts[7];
  t.tau = consts[8];
  t.x64 = x64 != 0;
  t.b1d = decays[0];
  t.b2d = decays[1];
  cudaStream_t s = (cudaStream_t)stream;
  adam_norm_kernel<<<blocks, kThreads, 0, s>>>(
      t, reinterpret_cast<float*>(partial), reinterpret_cast<float*>(bc));
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  adam_apply_kernel<<<blocks, kThreads, 0, s>>>(
      t, reinterpret_cast<const float*>(partial),
      reinterpret_cast<const float*>(bc));
  return (int)cudaGetLastError();
}
