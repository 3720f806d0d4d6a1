// B5d, the epilogues of the SAC update's bf16 Dense layers, forward and
// backward, on Hopper (sm_90a): the port of what XLA fuses around the
// products of flax's bf16 `Dense` in `sac_train_step`
// (distributed_cluster_gpus_tpu/rl/sac.py:206-310; the layers at
// rl/nets.py:37-39, 58-61, 93-95, 149-150): the bias add, the ReLU and the
// float32 copy of a network's last layer, and in the gradient the ReLU's
// mask, the cast of a float32 incoming gradient to bf16 and the bias
// gradient.  The products themselves stay bf16 `torch.matmul` (cuBLAS,
// float32 accumulation), as the JAX package leaves them to XLA's dot.  The
// JAX package has no Pallas kernel.
//
// Forward epilogue, in place on the product y [R, N] (bf16), bias b [N]:
//   y = bf16(float(y) + float(b))        (torch's bf16 add)
//   y = y > 0 ? y : 0                     (when the layer has a ReLU)
//   out32 = float(y)                      (when given: [R, N], row stride ld)
// Backward, from the incoming gradient g [R, N] (bf16, or float32 with row
// stride ld at a network's last layer) and optionally a second bf16 one g2
// (the actor's hidden layer feeds both heads):
//   G  = bf16(g)  or  bf16(float(g) + float(g2))
//   G  = y > 0 ? G : 0                   (when the layer has a ReLU; y is
//                                          the layer's bf16 output)
//   db = bf16(sum over the R rows of float(G)), by the halving tree of
//        ops/physics.py::tree_sum_last (rows zero-padded to a power of two
//        P; row i + row i + P/2 per level)
// which is rl/nets.py::dense_epilogue / dense_backward op for op; built
// with -fmad=false the two are bitwise equal on the card.  G then feeds the
// two products dW = x^T G and dX = G W^T (torch.matmul).
//
// Bound on the card: bytes.  The forward reads and writes y (4 B an
// element, 8 with the float32 copy): 16.8 MB for a 16,384 x 256 layer of the
// all-actions critic, 5.0 us at 3.35 TB/s.  The backward reads g (2 or 4 B)
// and y and writes G: ~0.4 MB for a 256 x 256 layer.
// Design: forward, a thread per 8 consecutive columns of a row (16-byte
// loads and stores; element by element when N is not a multiple of 8 or a
// pointer is not aligned).  Backward, a block per 4 columns: 256 threads,
// 4 columns x 64 row lanes (a column's bias gradient is a tree over all of
// its rows, so one block owns whole columns; the time of a call grows with
// the rows a thread handles, so the tile is narrow); up to 256 rows (the
// update's batch) a thread loads all of its 4 rows' inputs before it
// writes any G; beyond 256 rows each thread folds the rows q, q + 256,
// q + 512, ... by the same halving tree in its registers, which is the
// first log2(P/256) levels of the tree over P.  The block then halves the
// (at most 256) partials of each column in shared memory.  No host read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;        // forward: columns a thread handles
constexpr int kCols = 4;       // backward: columns a block handles
constexpr int kRowLanes = kThreads / kCols;
constexpr int kPartials = 256;  // backward: the tree's rows kept in shared
constexpr int kMaxLocal = 64;   // backward: rows a thread folds (R <= 16,384)

__device__ __forceinline__ __nv_bfloat16 epilogue(__nv_bfloat16 y,
                                                  __nv_bfloat16 b, int relu) {
  __nv_bfloat16 r = __float2bfloat16_rn(__bfloat162float(y) + __bfloat162float(b));
  if (relu && !(__bfloat162float(r) > 0.0f)) r = __float2bfloat16_rn(0.0f);
  return r;
}

template <bool kVectors>
__global__ void __launch_bounds__(kThreads)
    dense_fwd_kernel(__nv_bfloat16* __restrict__ y,
                     const __nv_bfloat16* __restrict__ bias,
                     float* __restrict__ out32, long long ld32, int R, int N,
                     int relu) {
  const int w = kVectors ? kVec : 1;
  const long long per_row = N / w;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)R * per_row) return;
  const long long row = i / per_row;
  const int col = (int)(i % per_row) * w;
  __nv_bfloat16* yr = y + row * N + col;
  if (kVectors) {
    uint4 u = *reinterpret_cast<const uint4*>(yr);
    const uint4 bu = *reinterpret_cast<const uint4*>(bias + col);
    __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&u);
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bu);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = epilogue(v[k], bv[k], relu);
    *reinterpret_cast<uint4*>(yr) = u;
    if (out32 != nullptr) {
      float* o = out32 + row * ld32 + col;
      *reinterpret_cast<float4*>(o) =
          make_float4(__bfloat162float(v[0]), __bfloat162float(v[1]),
                      __bfloat162float(v[2]), __bfloat162float(v[3]));
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(__bfloat162float(v[4]), __bfloat162float(v[5]),
                      __bfloat162float(v[6]), __bfloat162float(v[7]));
    }
  } else {
    const __nv_bfloat16 r = epilogue(*yr, bias[col], relu);
    *yr = r;
    if (out32 != nullptr) out32[row * ld32 + col] = __bfloat162float(r);
  }
}

// one element of G from its raw inputs (the incoming gradient g as float,
// the second one g2 (0 when there is none), the layer's output y (1 when
// there is no ReLU)): G's bf16 value
__device__ __forceinline__ __nv_bfloat16 grad_of(float g, int g_f32, int two,
                                                 float g2, float y) {
  __nv_bfloat16 v = __float2bfloat16_rn(g);  // exact for a bf16 g
  if (!g_f32 && two) v = __float2bfloat16_rn(g + g2);
  if (!(y > 0.0f)) v = __float2bfloat16_rn(0.0f);
  return v;
}

struct Raw {
  float g, g2, y;
};

// the raw inputs of element (row, col); rows at or past R and columns past
// N read as a zero gradient
__device__ __forceinline__ Raw raw_at(const void* g, int g_f32, long long ldg,
                                      const __nv_bfloat16* __restrict__ g2,
                                      const __nv_bfloat16* __restrict__ y,
                                      long long row, int col, int R, int N) {
  Raw r{0.0f, 0.0f, 1.0f};
  if (row >= R || col >= N) return r;
  r.g = g_f32 ? reinterpret_cast<const float*>(g)[row * ldg + col]
              : __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(g)[row * ldg + col]);
  if (g2 != nullptr) r.g2 = __bfloat162float(g2[row * N + col]);
  if (y != nullptr) r.y = __bfloat162float(y[row * N + col]);
  return r;
}

// G's element as float, written to G when it lies inside [R, N]
__device__ __forceinline__ float put(const Raw& r, int g_f32, int two,
                                     __nv_bfloat16* __restrict__ G,
                                     long long row, int col, int R, int N) {
  const __nv_bfloat16 v = grad_of(r.g, g_f32, two, r.g2, r.y);
  if (row < R && col < N) G[row * N + col] = v;
  return __bfloat162float(v);
}

__global__ void __launch_bounds__(kThreads)
    dense_bwd_kernel(const void* __restrict__ g, int g_f32, long long ldg,
                     const __nv_bfloat16* __restrict__ g2,
                     const __nv_bfloat16* __restrict__ y,
                     __nv_bfloat16* __restrict__ G,
                     __nv_bfloat16* __restrict__ db, int R, int N) {
  __shared__ float s[kPartials * kCols];
  const int c = threadIdx.x % kCols, lane = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + c;
  const int two = g2 != nullptr;
  const int P = rd::pow2_at_least(R);
  const int Q = P < kPartials ? P : kPartials;
  const int M = P / Q;
  if (M == 1) {
    // every row of this thread loaded first (one round trip to memory),
    // then G written and the partials stored
    constexpr int kPer = kPartials / kRowLanes;
    Raw r[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      r[k] = raw_at(g, g_f32, ldg, g2, y, lane + k * kRowLanes, col, R, N);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = lane + k * kRowLanes;
      if (q < Q) s[q * kCols + c] = put(r[k], g_f32, two, G, q, col, R, N);
    }
  } else {
    for (int q = lane; q < Q; q += kRowLanes) {
      float x[kMaxLocal];
      for (int m = 0; m < M; ++m) {
        const long long row = q + (long long)m * Q;
        x[m] = put(raw_at(g, g_f32, ldg, g2, y, row, col, R, N), g_f32, two,
                   G, row, col, R, N);
      }
      s[q * kCols + c] = rd::tree_local(x, M);
    }
  }
  for (int h = Q >> 1; h >= 1; h >>= 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < h * kCols; e += kThreads) {
      const int i = e / kCols, cc = e % kCols;
      s[i * kCols + cc] = s[i * kCols + cc] + s[(i + h) * kCols + cc];
    }
  }
  __syncthreads();
  if (threadIdx.x < kCols && col < N) db[col] = __float2bfloat16_rn(s[c]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns its launch's
// cudaError_t, or -1 for a shape the kernel does not take.
//
// Forward epilogue, in place on y (bf16 [R, N], contiguous) with bias (bf16
// [N]); relu 0/1; out32 (float32, [R, N] at row stride ld32, unit column
// stride) or 0.
extern "C" int dense_fwd_launch(void* y, const void* bias, void* out32,
                                long long ld32, int R, int N, int relu,
                                void* stream) {
  if (R < 1 || N < 1) return -1;
  const bool vec = N % kVec == 0 && aligned16(y) && aligned16(bias) &&
                   (out32 == nullptr || (aligned16(out32) && ld32 % 4 == 0));
  const long long items = (long long)R * N / (vec ? kVec : 1);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  auto* yy = reinterpret_cast<__nv_bfloat16*>(y);
  auto* bb = reinterpret_cast<const __nv_bfloat16*>(bias);
  auto* oo = reinterpret_cast<float*>(out32);
  if (vec)
    dense_fwd_kernel<true><<<(int)blocks, kThreads, 0, s>>>(yy, bb, oo, ld32, R, N, relu);
  else
    dense_fwd_kernel<false><<<(int)blocks, kThreads, 0, s>>>(yy, bb, oo, ld32, R, N, relu);
  return (int)cudaGetLastError();
}

// Backward: g the incoming gradient ([R, N] at row stride ldg, unit column
// stride; float32 when g_f32, else bf16), g2 a second bf16 one ([R, N]
// contiguous, only with a bf16 g) or 0, y the layer's bf16 output ([R, N]
// contiguous) when it has a ReLU, else 0; writes G (bf16 [R, N],
// contiguous) and db (bf16 [N]).  R <= 16,384.
extern "C" int dense_bwd_launch(const void* g, int g_f32, long long ldg,
                                const void* g2, const void* y, void* G,
                                void* db, int R, int N, void* stream) {
  if (R < 1 || N < 1 || ldg < N || (g_f32 && g2 != nullptr) ||
      rd::pow2_at_least(R) > kPartials * kMaxLocal)
    return -1;
  const int blocks = (N + kCols - 1) / kCols;
  dense_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, g_f32, ldg, reinterpret_cast<const __nv_bfloat16*>(g2),
      reinterpret_cast<const __nv_bfloat16*>(y),
      reinterpret_cast<__nv_bfloat16*>(G), reinterpret_cast<__nv_bfloat16*>(db),
      R, N);
  return (int)cudaGetLastError();
}
