// Per-chunk arrival tables on Hopper (sm_90a): the port of the XLA-fused
// region `WorkloadProgram.tables` (distributed_cluster_gpus_tpu/workload/
// compiler.py:218-384, with ops/arrivals.py:122-198).  The JAX package has
// no Pallas kernel; this replaces the fused jnp code.
//
// What it computes, for S streams (flat order ingress*2 + jtype) and n
// table entries per stream, exactly as the plain torch version
// `arrival_tables_reference` (kernels/arrival_tables.py) does:
//   * per (stream s, entry i): the jax.random key chain
//       k = fold_in(fold_in(arr_key, s), c0[s] + i); (k_size, k_gap) = split(k)
//     (threefry-2x32, 20 rounds, partitionable jax semantics), the job size
//     (Pareto(1.8) for inference, max(0.1, LogNormal(ln 5e4, 0.4)) for
//     training) and the gap increment: Exp(1)/rate (poisson) or Exp(1)
//     (sinusoid inversion, where the fold carries the cumulative Exp sum);
//   * per stream: the sequential LEFT fold carry += inc[i] (never a
//     parallel scan: chunk invariance depends on this association);
//   * per (s, i): tnext = fold (poisson), epoch + 30-step bisection of the
//     integrated sinusoid rate (sin_inv), or +inf (off).
//
// Bound on the card (H100 SXM, 3.35 TB/s, S=16, n=4096): the output is
// 3 * 4 * S * n = 0.79 MB (0.23 us of memory time); the integer work is
// about 8 threefry blocks (~170 integer ops each) per entry, ~2e7 ops, a
// few us; the floor is the dependent float32 fold, 4096 adds per stream at
// ~4 cycles each, ~9 us at 1.75 GHz.  Design: one thread per entry for the
// draws (kernel 1); one block per stream for the fold and the inversion
// (kernel 2) - the block stages a tile of increments in shared memory with
// coalesced loads, thread 0 folds the tile from shared memory, and all
// threads then write the fold and run the bisections for the tile.
//
// Built with -fmad=false: no product may be contracted into an FMA, so
// every float32 expression rounds as the plain version's separate torch
// ops round.  The erf_inv polynomial is the one place that wants fused
// multiply-adds (XLA's polynomial uses them); it calls fmaf explicitly.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kFamOff = 0;
constexpr int kFamPoisson = 1;
constexpr int kFamSinInv = 2;
constexpr int kTile = 2048;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define TF_ROUND(r)      \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;

// threefry-2x32 block on counter (c0, c1) under key (k0, k1)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t c0,
                                         uint32_t c1, uint32_t& o0,
                                         uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

// fold_in(k, d) and split(k)[d] are the same block on counter (0, d)
__device__ __forceinline__ void child(uint32_t k0, uint32_t k1, uint32_t d,
                                      uint32_t& o0, uint32_t& o1) {
  threefry(k0, k1, 0u, d, o0, o1);
}

__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1) {
  uint32_t o0, o1;
  threefry(k0, k1, 0u, 0u, o0, o1);
  return o0 ^ o1;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float erfinv_xla(float x) {
  const float small_c[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                            -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                            -0.00417768164f, 0.246640727f, 1.50140941f};
  const float large_c[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                            -0.00367342844f, 0.00573950773f, -0.0076224613f,
                            0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -log1pf(-(x * x));
  const bool small = w < 5.0f;
  w = small ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = small ? small_c[0] : large_c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, w, small ? small_c[i] : large_c[i]);
  if (fabsf(x) == 1.0f) return x * 3.402823466e+38f;
  return p * x;
}

__device__ __forceinline__ float pymod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

// kernel 1: one thread per (stream, entry) - keys, size, gap increment
__global__ void draws_kernel(const int64_t* __restrict__ arr_key,
                             const int* __restrict__ c0,
                             const int* __restrict__ family,
                             const float* __restrict__ sparams, int S, int n,
                             float* __restrict__ sizes,
                             float* __restrict__ inc,
                             int* __restrict__ aux_key,
                             float* __restrict__ aux_u) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)S * n) return;
  const int s = (int)(idx / n);
  const int i = (int)(idx - (long long)s * n);
  const int fam = family[s];
  if (fam == kFamOff) {
    sizes[idx] = 0.0f;
    inc[idx] = 0.0f;
    return;
  }
  const float rate = sparams[4 * s + 0];
  uint32_t ks0, ks1, k0, k1, a0, a1, b0, b1;
  child((uint32_t)arr_key[0], (uint32_t)arr_key[1], (uint32_t)s, ks0, ks1);
  child(ks0, ks1, (uint32_t)(c0[s] + i), k0, k1);
  child(k0, k1, 0u, a0, a1);  // k_size
  child(k0, k1, 1u, b0, b1);  // k_gap
  // sample_job_size: (k_u, k_n) = split(k_size)
  uint32_t u0, u1, z0, z1;
  float size;
  if ((s & 1) == 0) {
    child(a0, a1, 0u, u0, u1);
    const float u = fmaxf(1e-9f, 1.0f - unit_float(bits32(u0, u1)));
    size = 1.0f / powf(u, 0.555555582f);
  } else {
    child(a0, a1, 1u, z0, z1);
    const float un = fmaxf(-0.99999994f,
                           unit_float(bits32(z0, z1)) * 2.0f + -0.99999994f);
    const float z = erfinv_xla(un) * 1.41421354f;
    const float mu = logf(50000.0f);
    size = fmaxf(0.1f, expf(mu + 0.4f * z));
  }
  sizes[idx] = size;
  const float ug = unit_float(bits32(b0, b1));
  const float e = -log1pf(-ug);
  if (fam == kFamPoisson) {
    inc[idx] = rate > 0.0f ? e * (1.0f / fmaxf(rate, 1e-30f)) : CUDART_INF_F;
  } else {
    inc[idx] = e;
  }
  if (aux_key != nullptr) {
    aux_key[2 * idx] = (int)b0;
    aux_key[2 * idx + 1] = (int)b1;
    aux_u[idx] = ug;
  }
}

__device__ __forceinline__ float sin_inv_gap(float rate, float amp_s,
                                             float period, float anchor,
                                             float s) {
  const float a = fabsf(amp_s);
  const float w = 6.28318548f / period;
  const float phase0 = w * pymod(anchor, period);
  const float cos0 = cosf(phase0);
  const float coef = rate * amp_s / w;
  float lo = s / fmaxf(rate * (1.0f + a), 1e-30f);
  float hi = fminf(s / fmaxf(rate * (1.0f - a), 1e-9f),
                   (s / fmaxf(rate * period, 1e-30f) + 1.0f) * period);
  for (int it = 0; it < 30; ++it) {
    const float mid = 0.5f * (lo + hi);
    const float g = rate * mid + coef * (cos0 - cosf(phase0 + w * mid));
    if (g < s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return 0.5f * (lo + hi);
}

// kernel 2: one block per stream - sequential fold, then tnext per entry
__global__ void fold_kernel(const int* __restrict__ family,
                            const float* __restrict__ sparams,
                            const float* __restrict__ t0,
                            const float* __restrict__ cum0,
                            const float* __restrict__ epoch, int n,
                            float* __restrict__ cum,
                            float* __restrict__ tnext) {
  __shared__ float tile[kTile];
  __shared__ float carry_s;
  const int s = blockIdx.x;
  const int fam = family[s];
  const float rate = sparams[4 * s + 0];
  const float amp = sparams[4 * s + 1];
  const float period = sparams[4 * s + 2];
  const float phase = sparams[4 * s + 3];
  const float ep = epoch[s];
  const float anchor = ep + phase;
  float* row = cum + (long long)s * n;
  float* trow = tnext + (long long)s * n;
  if (threadIdx.x == 0) carry_s = fam == kFamSinInv ? cum0[s] : t0[s];
  for (int base = 0; base < n; base += kTile) {
    const int len = min(kTile, n - base);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) tile[j] = row[base + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      float c = carry_s;
      for (int j = 0; j < len; ++j) {
        c = c + tile[j];
        tile[j] = c;
      }
      carry_s = c;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const float f = tile[j];
      row[base + j] = f;
      float tn;
      if (fam == kFamPoisson) {
        tn = f;
      } else if (fam == kFamSinInv) {
        const float d = rate > 0.0f ? sin_inv_gap(rate, amp, period, anchor, f)
                                    : CUDART_INF_F;
        tn = ep + d;
      } else {
        tn = CUDART_INF_F;
      }
      trow[base + j] = tn;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `cum` doubles as the increment
// scratch between the two kernels.  aux_key/aux_u may be null; when given
// they receive each entry's k_gap key words and its uniform draw.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int arrival_tables_launch(const int64_t* arr_key, const int* c0,
                                     const float* t0, const float* cum0,
                                     const float* epoch, const int* family,
                                     const float* sparams, int S, int n,
                                     float* sizes, float* tnext, float* cum,
                                     int* aux_key, float* aux_u,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long total = (long long)S * n;
  const int blocks = (int)((total + threads - 1) / threads);
  draws_kernel<<<blocks, threads, 0, st>>>(arr_key, c0, family, sparams, S, n,
                                          sizes, cum, aux_key, aux_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_kernel<<<S, threads, 0, st>>>(family, sparams, t0, cum0, epoch, n, cum,
                                     tnext);
  return (int)cudaGetLastError();
}
