// B6b, the replay sample, on Hopper (sm_90a): the port of the XLA-fused
// `replay_sample` (distributed_cluster_gpus_tpu/rl/replay.py:212): a uniform
// draw over the ring's valid rows by the inverse CDF, then the gather of the
// sampled rows of every field.  The JAX package has no Pallas kernel; this
// replaces the float32 cumsum over the ring, the uniform draw, the
// searchsorted and the eleven gathers.
//
// What it computes, for a ring of C rows and a batch of Bs draws:
//   total  = number of valid rows (an exact int32 scan: JAX's float32 cumsum
//            is exact too, since C < 2^24)
//   u_s    = unit_float(threefry bits of draw s) * max(total, 1)   (float32)
//   r_s    = floor(u_s);  idx_s = the row of rank r_s among the valid rows,
//            or C - 1 when r_s >= total (JAX's clip of searchsorted's C:
//            an empty ring, or u_s rounded up to the total)
//   out[field][s] = ring[field][idx_s]   for the 11 row fields
// searchsorted(cdf, u, 'right') counts the cdf entries <= u; with an
// integer cdf that is the first row whose cdf exceeds floor(u), the row of
// rank floor(u).  The bits are jax.random.uniform(key, (Bs,))'s: element s
// from the threefry block on counter (0, s) under the sample's key
// (threefry.cuh), bit for bit.
//
// Bound on the card: bytes.  A draw reads the ring's validity bytes (C, 200
// KB at the CLI's ring) and the Bs sampled rows (about 450 B each at the
// paper fleet's obs_dim 49) and writes them: ~0.43 MB, 0.13 us at 3.35
// TB/s.  Design: ONE block of 1024 threads (the draws need the whole scan):
// each thread counts the valid bytes of a contiguous run of rows, the block
// scans the counts in shared memory, each draw finds its run by binary
// search over the scanned counts and walks that run to its row, then the
// block copies the rows as 4-byte words where a field's row is a multiple of
// 4 bytes (bytes otherwise).  No host read: the key's words are launch
// arguments computed on the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBatch = 4096;
constexpr int kMaxFields = 16;

struct Fields {
  const uint8_t* src[kMaxFields];
  uint8_t* dst[kMaxFields];
  int row_bytes[kMaxFields];
  int n;
};

__global__ void __launch_bounds__(kThreads)
    replay_sample_kernel(const Fields f, const uint8_t* __restrict__ valid,
                         int C, int Bs, uint32_t k0, uint32_t k1,
                         int* __restrict__ idx_out) {
  __shared__ int incl[kThreads];
  __shared__ int s_idx[kMaxBatch];
  const int tid = threadIdx.x;
  const int per = (C + kThreads - 1) / kThreads;
  const int lo = min(C, tid * per), hi = min(C, lo + per);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += valid[i] != 0;
  incl[tid] = c;
  __syncthreads();
  // inclusive scan of the per-thread counts (Hillis-Steele)
  for (int off = 1; off < kThreads; off <<= 1) {
    const int v = tid >= off ? incl[tid - off] : 0;
    __syncthreads();
    incl[tid] += v;
    __syncthreads();
  }
  const int total = incl[kThreads - 1];
  const float scale = fmaxf((float)total, 1.0f);
  for (int s = tid; s < Bs; s += kThreads) {
    uint32_t o0, o1;
    tf::threefry(k0, k1, 0u, (uint32_t)s, o0, o1);
    const float u = tf::unit_float(o0 ^ o1) * scale;
    const int r = (int)u;  // u >= 0 and below 2^24: the floor, exactly
    int row = C - 1;
    if (r < total) {
      // the first run whose inclusive count exceeds r
      int a = 0, b = kThreads - 1;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (incl[m] > r) b = m; else a = m + 1;
      }
      // its rank within run a: r less the valid rows before the run
      int k = r - (a > 0 ? incl[a - 1] : 0);
      const int rlo = min(C, a * per), rhi = min(C, rlo + per);
      for (int i = rlo; i < rhi; ++i) {
        if (valid[i]) {
          if (k == 0) { row = i; break; }
          --k;
        }
      }
    }
    s_idx[s] = row;
    idx_out[s] = row;
  }
  __syncthreads();
  for (int k = 0; k < f.n; ++k) {
    const int rb = f.row_bytes[k];
    if ((rb & 3) == 0) {
      const int words = rb >> 2;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(f.src[k]);
      uint32_t* dst = reinterpret_cast<uint32_t*>(f.dst[k]);
      for (int e = tid; e < Bs * words; e += kThreads)
        dst[e] = src[(long long)s_idx[e / words] * words + e % words];
    } else {
      for (int e = tid; e < Bs * rb; e += kThreads)
        f.dst[k][e] = f.src[k][(long long)s_idx[e / rb] * rb + e % rb];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): `src`/`dst` hold n_fields device
// pointers (the ring's rows and the batch's, in rl/replay.py's ROW_FIELDS
// order), `row_bytes` each field's bytes per row; `valid` the ring's C
// validity bytes; (k0, k1) the sample key's words; idx [Bs] int32.  Launches
// one block on `stream`.  Returns the cudaError_t of the launch, -1 for a
// bad field table, -2 for a batch or ring the kernel does not take.
extern "C" int replay_sample_launch(const uint64_t* src, const uint64_t* dst,
                                    const int* row_bytes, int n_fields,
                                    const void* valid, int C, int Bs,
                                    uint32_t k0, uint32_t k1, void* idx,
                                    void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return -1;
  if (C < 1 || C >= (1 << 24) || Bs < 1 || Bs > kMaxBatch) return -2;
  Fields f;
  f.n = n_fields;
  for (int k = 0; k < n_fields; ++k) {
    f.src[k] = reinterpret_cast<const uint8_t*>(src[k]);
    f.dst[k] = reinterpret_cast<uint8_t*>(dst[k]);
    f.row_bytes[k] = row_bytes[k];
    if (row_bytes[k] < 1) return -1;
  }
  replay_sample_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      f, reinterpret_cast<const uint8_t*>(valid), C, Bs, k0, k1,
      reinterpret_cast<int*>(idx));
  return (int)cudaGetLastError();
}
