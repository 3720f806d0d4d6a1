// B5f's backward, the gradient of the masked log-softmax of the actor's
// two heads, on Hopper (sm_90a): the port of the gradient of
// `nn.log_softmax` under the masks that XLA fuses in the actor of
// `sac_train_step` (distributed_cluster_gpus_tpu/rl/nets.py:62-66, inside
// rl/sac.py:206-310).  The JAX package has no Pallas kernel.  The forward
// runs in the heads' product (csrc/dense.cu, actor_heads_gemm), which
// repeats the arithmetic below op for op.
//
// For each row b of a head (n entries: the DC head's n_dc, the GPU-count
// head's n_g), from its float32 logits l and boolean mask, the forward is
//   x_j  = mask_j ? l_j : -1e9
//   m    = max_j x_j                     (held constant under
//                                          differentiation, as flax's
//                                          log_softmax stops its gradient)
//   e_j  = exp(x_j - m);  S = sum_j e_j  (the halving tree of
//                                          ops/physics.py::tree_sum_last,
//                                          zero-padded to a power of two)
//   logp_j = (x_j - m) - log(S)
// and, given the incoming gradient g = dL/dlogp, this kernel writes
//   dl_j = mask_j ? g_j + ((-T) / S) * e_j : 0,   T = sum_j g_j (the tree)
// which is rl/nets.py::masked_log_softmax_backward op for op.  `expf` is
// CUDA's accurate function (no fast math), the one torch's CUDA `exp`
// calls, so with -fmad=false the kernel is bitwise equal to its plain
// version on the card.
// Bound on the card: bytes (and launch latency).  It reads the logits, the
// masks and g and writes the logits' gradient of both heads: 13 B an
// entry, 53 KB at B = 256 and 8 + 8 entries.
// Design: a thread per (row, head), both heads in one launch, each row's
// entries in registers (n <= 64).  No host read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr float kNegMask = -1e9f;

struct Head {
  const float* logits;
  const uint8_t* mask;
  const float* g;
  float* out;
  int n;
};

// x - m of one row into sh[0..n), e = exp(sh) zero-padded to P into e;
// returns S, the tree's sum of e
__device__ __forceinline__ float shifted(const Head& h, int row, float* sh,
                                         float* e, int P) {
  float m = 0.0f;
  for (int j = 0; j < h.n; ++j) {
    const float x = h.mask[row * h.n + j] ? h.logits[row * h.n + j] : kNegMask;
    sh[j] = x;
    // torch's max: NaN wins, else the larger
    if (j == 0 || x != x || (m == m && x > m)) m = x;
  }
  for (int j = 0; j < P; ++j) {
    if (j < h.n) {
      sh[j] = sh[j] - m;
      e[j] = expf(sh[j]);
    } else {
      e[j] = 0.0f;
    }
  }
  float t[kMaxN];
  for (int j = 0; j < P; ++j) t[j] = e[j];
  return rd::tree_local(t, P);
}

__global__ void __launch_bounds__(kThreads)
    log_softmax_backward_kernel(Head h0, Head h1, int B) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * B) return;
  const Head& h = i < B ? h0 : h1;
  const int row = i < B ? i : i - B;
  const int P = rd::pow2_at_least(h.n);
  float sh[kMaxN], e[kMaxN];
  const float S = shifted(h, row, sh, e, P);
  float* out = h.out + row * h.n;
  float t[kMaxN];
  for (int j = 0; j < P; ++j) t[j] = j < h.n ? h.g[row * h.n + j] : 0.0f;
  const float dS = (-rd::tree_local(t, P)) / S;
  for (int j = 0; j < h.n; ++j)
    out[j] = h.mask[row * h.n + j] ? h.g[row * h.n + j] + dS * e[j] : 0.0f;
}

}  // namespace

// Plain C entry point (bound with ctypes).  For both heads (k = 0: the DC
// head, n0 entries; k = 1: the GPU-count head, n1): logits float32 [B, n],
// mask bool [B, n], g float32 [B, n] (dL/dlogp), out float32 [B, n] (the
// gradient of the logits), all contiguous.  n <= 64.  Returns the launch's
// cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int log_softmax_backward_launch(const void* l0, const void* m0,
                                           const void* g0, void* out0, int n0,
                                           const void* l1, const void* m1,
                                           const void* g1, void* out1, int n1,
                                           int B, void* stream) {
  if (B < 1 || n0 < 1 || n1 < 1 || n0 > kMaxN || n1 > kMaxN ||
      g0 == nullptr || g1 == nullptr)
    return -1;
  Head h0{reinterpret_cast<const float*>(l0), reinterpret_cast<const uint8_t*>(m0),
          reinterpret_cast<const float*>(g0), reinterpret_cast<float*>(out0), n0};
  Head h1{reinterpret_cast<const float*>(l1), reinterpret_cast<const uint8_t*>(m1),
          reinterpret_cast<const float*>(g1), reinterpret_cast<float*>(out1), n1};
  const int blocks = (2 * B + kThreads - 1) / kThreads;
  log_softmax_backward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      h0, h1, B);
  return (int)cudaGetLastError();
}
