// B5c, clipped Adam with the Polyak target and the temperature clamp, on
// Hopper (sm_90a): the port of the XLA-fused optimizer step of
// `sac_train_step` (distributed_cluster_gpus_tpu/rl/sac.py:279-288 and
// :300-302): optax's `clip_by_global_norm(5.0)` then `adam(3e-4)` (`_tx`,
// :117) applied to one parameter group, the critic's Polyak target
// `(1 - tau) * t + tau * o`, and log alpha's `min(., log(alpha_max))`.  The
// JAX package has no Pallas kernel.
//
// What it computes for one group held in one flat float32 buffer of n
// elements (p, its gradient g, the moments mu and nu, the step count):
//   ss     = sum g^2: the buffer read as [K, R, 256] (zero-padded), each
//            thread (k, j) folding its R squares in order, each block's 256
//            partials and then the K block sums by the halving tree
//   gn     = sqrt(ss);  g = gn < max_norm ? g : (g / gn) * max_norm
//   mu     = c1 * g + b1 * mu;   nu = c2 * (g * g) + b2 * nu
//   count  = count + 1 (saturating);  bc = 1 - (float)pow((double)b, count)
//   u      = (mu / bc1) / (sqrt(nu / bc2 + 0) + eps);  p = p + u * (-lr)
//   target = (1 - tau) * target + tau * p     (when a target is given)
//   p      = min(p, clamp)                    (when clamped)
// which is rl/optim.py::clip_adam_update (optax's order) op for op; built
// with -fmad=false, the two are bitwise equal on the card.
//
// Bound on the card: bytes.  A step reads g, p, mu, nu (and the target) and
// writes p, mu, nu (and the target): 28 B per element, 36 with the target;
// the critic's 287,808 parameters move 10.4 MB, all four groups 15.4 MB
// (4.6 us at 3.35 TB/s).  Design: two launches.  The first sums the squares
// in K <= 64 blocks of 256 threads into K partials and writes the new
// count to scratch; the second, a grid-stride pass, has every block sum the
// K partials by the same tree (64 floats), then update its elements; the
// first block stores the new count.  No host read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 64;
constexpr int kInt32Max = 2147483647;

struct Consts {
  float c1, b1, c2, b2, eps, neg_lr, max_norm, omt, tau, clamp;
  int has_target, has_clamp;
};

__global__ void __launch_bounds__(kThreads)
    adam_norm_kernel(const float* __restrict__ g, long long n, int R,
                     float* __restrict__ partial, const int* count,
                     int* count_new) {
  __shared__ float s[kThreads];
  const long long base = (long long)blockIdx.x * R * kThreads + threadIdx.x;
  float acc = 0.0f;
  for (int r = 0; r < R; ++r) {
    const long long e = base + (long long)r * kThreads;
    const float x = e < n ? g[e] : 0.0f;
    acc = acc + x * x;
  }
  s[threadIdx.x] = acc;
  rd::tree_rows(s, 1, kThreads, kThreads);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s[0];
    if (blockIdx.x == 0) {
      const int c = *count;
      *count_new = c < kInt32Max ? c + 1 : c;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_apply_kernel(float* __restrict__ p, const float* __restrict__ g,
                      float* __restrict__ mu, float* __restrict__ nu,
                      float* __restrict__ target, long long n,
                      const float* __restrict__ partial, int K,
                      const int* __restrict__ count_new, int* count,
                      Consts c) {
  __shared__ float s[kMaxBlocks];
  for (int k = threadIdx.x; k < kMaxBlocks; k += blockDim.x)
    s[k] = k < K ? partial[k] : 0.0f;
  rd::tree_rows(s, 1, kMaxBlocks, kMaxBlocks);
  const float gn = sqrtf(s[0]);
  const bool keep = gn < c.max_norm;
  const int t = *count_new;
  const float bc1 = 1.0f - (float)pow((double)c.b1, (double)t);
  const float bc2 = 1.0f - (float)pow((double)c.b2, (double)t);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float gi = g[e];
    if (!keep) gi = (gi / gn) * c.max_norm;
    const float m = c.c1 * gi + c.b1 * mu[e];
    const float v = c.c2 * (gi * gi) + c.b2 * nu[e];
    const float u = (m / bc1) / (sqrtf(v / bc2 + 0.0f) + c.eps);
    float pn = p[e] + u * c.neg_lr;
    if (c.has_target) target[e] = c.omt * target[e] + c.tau * pn;
    if (c.has_clamp) pn = pn != pn ? pn : fminf(pn, c.clamp);
    p[e] = pn;
    mu[e] = m;
    nu[e] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = t;
}

}  // namespace

// Plain C entry point (bound with ctypes).  p, g, mu, nu (and target, or
// null) are n float32 on the device; count one int32; partial 64 floats and
// count_new one int32 of scratch.  `consts` holds (1-b1, b1, 1-b2, b2, eps,
// -lr, max_norm, 1-tau, tau, clamp) as float32, `flags` bit 0 a target, bit
// 1 a clamp.  K blocks of R squares per thread: rl/optim.py::norm_layout.
// Returns the first failing launch's cudaError_t, or -1 for a bad layout.
extern "C" int adam_launch(void* p, const void* g, void* mu, void* nu,
                           void* target, long long n, const void* count,
                           void* partial, void* count_new, int K, int R,
                           const float* consts, int flags, int apply_blocks,
                           void* stream) {
  if (n < 1 || K < 1 || K > kMaxBlocks || R < 1 ||
      (long long)K * R * kThreads < n || apply_blocks < 1)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  adam_norm_kernel<<<K, kThreads, 0, s>>>((const float*)g, n, R,
                                          (float*)partial, (const int*)count,
                                          (int*)count_new);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  Consts c{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5],
           consts[6], consts[7], consts[8], consts[9], flags & 1,
           (flags >> 1) & 1};
  adam_apply_kernel<<<apply_blocks, kThreads, 0, s>>>(
      (float*)p, (const float*)g, (float*)mu, (float*)nu, (float*)target, n,
      (const float*)partial, K, (const int*)count_new, (int*)count, c);
  return (int)cudaGetLastError();
}
