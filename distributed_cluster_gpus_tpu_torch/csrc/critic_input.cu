// B5e, the one-hot critic's input rows, on Hopper (sm_90a): the port of the
// concat and cast XLA fuses ahead of `QuantileCritic`'s first product
// (distributed_cluster_gpus_tpu/rl/nets.py:85-87, `jnp.concatenate([latent,
// eye(n_dc)[a_dc], eye(n_g)[a_g]]).astype(bf16)`), and of its `all_actions`
// tiling of every joint action (:98-112: `repeat(latent, A)` against
// `tile(arange(A) // n_g)` and `tile(arange(A) % n_g)`).  The JAX package
// has no Pallas kernel.
//
// What it computes, from lat (float32 [B, L]) into x0 (bf16 [rows, L + n_dc
// + n_g]):
//   all actions (rows = B * A, A = n_dc * n_g): row b * A + a holds
//     bf16(lat[b]), a one at L + a / n_g and a one at L + n_dc + a % n_g;
//   taken actions (rows = B): row b holds bf16(lat[b]), a one at
//     L + a_dc[b] and a one at L + n_dc + a_g[b] (no one where an action
//     lies outside its head).
// The round to bf16 is to nearest even, as `astype` and torch's `.to` round,
// so x0 is bitwise rl/nets.py::critic_input's and the JAX package's.
// Bound on the card: bytes.  It writes rows x (L + n_dc + n_g) bf16 and
// reads lat once: 8.9 MB for the all-actions rows at the published shape
// (16,384 x 272), 2.7 us at 3.35 TB/s.
// Design: a thread per 8 consecutive entries of a row (one 16-byte store;
// element by element when the width is not a multiple of 8); the latent
// rows are read through the cache (each read A times for all actions).  No
// host read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

template <int W>
__global__ void __launch_bounds__(kThreads)
    critic_input_kernel(const float* __restrict__ lat,
                        const int* __restrict__ a_dc,
                        const int* __restrict__ a_g,
                        __nv_bfloat16* __restrict__ x0, int rows, int L,
                        int n_dc, int n_g) {
  const int width = L + n_dc + n_g;
  const long long per_row = width / W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)rows * per_row) return;
  const long long row = i / per_row;
  const int col = (int)(i % per_row) * W;
  long long b;
  int adc, ag;
  if (a_dc == nullptr) {  // every joint action
    const int A = n_dc * n_g;
    b = row / A;
    const int a = (int)(row % A);
    adc = a / n_g;
    ag = a % n_g;
  } else {
    b = row;
    adc = a_dc[row];
    ag = a_g[row];
  }
  alignas(16) __nv_bfloat16 v[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = col + k;
    float f;
    if (j < L) {
      f = lat[b * L + j];
    } else if (j < L + n_dc) {
      f = (j - L == adc) ? 1.0f : 0.0f;
    } else {
      f = (j - L - n_dc == ag) ? 1.0f : 0.0f;
    }
    v[k] = __float2bfloat16_rn(f);
  }
  __nv_bfloat16* out = x0 + row * width + col;
  if (W == kVec) {
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) out[k] = v[k];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  lat float32 [B, L] contiguous;
// a_dc, a_g int32 [B] (taken actions) or both 0 (all actions); x0 bf16
// [rows, L + n_dc + n_g] contiguous, rows = B or B * n_dc * n_g.  Returns the
// launch's cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int critic_input_launch(const void* lat, const void* a_dc,
                                   const void* a_g, void* x0, int B, int L,
                                   int n_dc, int n_g, void* stream) {
  if (B < 1 || L < 0 || n_dc < 1 || n_g < 1 || (a_dc == nullptr) != (a_g == nullptr))
    return -1;
  const long long rows = a_dc == nullptr ? (long long)B * n_dc * n_g : B;
  const int width = L + n_dc + n_g;
  const bool vec = width % kVec == 0 && reinterpret_cast<uintptr_t>(x0) % 16 == 0;
  const long long items = rows * width / (vec ? kVec : 1);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (rows > 2147483647LL || blocks > 2147483647LL) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  auto* l = reinterpret_cast<const float*>(lat);
  auto* ad = reinterpret_cast<const int*>(a_dc);
  auto* ag = reinterpret_cast<const int*>(a_g);
  auto* x = reinterpret_cast<__nv_bfloat16*>(x0);
  if (vec)
    critic_input_kernel<kVec><<<(int)blocks, kThreads, 0, s>>>(l, ad, ag, x, (int)rows, L, n_dc, n_g);
  else
    critic_input_kernel<1><<<(int)blocks, kThreads, 0, s>>>(l, ad, ag, x, (int)rows, L, n_dc, n_g);
  return (int)cudaGetLastError();
}
