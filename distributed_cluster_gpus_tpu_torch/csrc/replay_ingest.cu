// B6a, the replay ingest window, on Hopper (sm_90a): the port of the
// XLA-fused `_add_window` of the replay ring (distributed_cluster_gpus_tpu/
// rl/replay.py:165, through `replay_add_chunk`, :103), "slotring" layout.
// The JAX package has no Pallas kernel; this replaces the jnp argsort +
// gather + dynamic_update_slice chain.
//
// What it computes, for one window of N <= kMaxN rows into a ring of C:
//   start  = ptr + N <= C ? ptr : 0            (read on the device)
//   rank_i = number of valid rows before row i  (block-wide exclusive scan)
//   dest_i = start + rank_i                     for a valid row
//          = start + n_new + (i - rank_i)       for an invalid one
// so the valid rows come first in insertion order and the invalid ones
// after them, as the stable argsort of ~valid lays them out; every row field
// is copied to its dest; valid[start + k] = k < n_new; n_lost is the count
// of valid rows in [start, start + N) before the write; then ptr = start +
// n_new, size = size - n_lost + n_new, n_seen += n_new.  No host read: the
// ring pointer stays on the device between windows and chunks.
//
// Bound on the card: bytes.  A window moves each source row once in and once
// out (about 450 B a row at the paper fleet's obs_dim 49: two 196 B
// observations, four 8 B masks, the costs and scalars) plus the N valid
// flags of the overwritten ring window; there are no floating-point
// operations.  Design: ONE block of 1024 threads (the metadata update must
// follow every thread's read of `ptr`, which only a single block orders with
// a barrier); each thread scans a contiguous run of rows, the block scans
// the per-thread counts in shared memory, and the rows are copied as 4-byte
// words where a field's row is a multiple of 4 bytes (bytes otherwise), with
// neighbouring threads on neighbouring words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxN = 8192;
constexpr int kMaxFields = 16;

struct Fields {
  const uint8_t* src[kMaxFields];
  uint8_t* dst[kMaxFields];
  int row_bytes[kMaxFields];
  int n;
};

__global__ void __launch_bounds__(kThreads)
    replay_ingest_kernel(const Fields f, const uint8_t* __restrict__ valid,
                         uint8_t* __restrict__ rb_valid, int* ptr, int* size,
                         int* n_seen, int N, int C) {
  __shared__ int dest[kMaxN];
  __shared__ int counts[kThreads];
  __shared__ int lost[kThreads / 32];
  __shared__ int s_start, s_new;
  const int tid = threadIdx.x;
  const int per = (N + kThreads - 1) / kThreads;
  const int lo = tid * per, hi = min(N, lo + per);
  const int p0 = *ptr;
  const int start = (p0 + N <= C) ? p0 : 0;
  int c = 0;
  for (int i = lo; i < hi; ++i) c += valid[i] != 0;
  counts[tid] = c;
  // the overwritten window's valid rows (read before anything is written)
  int l = 0;
  for (int i = tid; i < N; i += kThreads) l += rb_valid[start + i] != 0;
  for (int off = 16; off > 0; off >>= 1) l += __shfl_down_sync(0xffffffffu, l, off);
  if ((tid & 31) == 0) lost[tid >> 5] = l;
  __syncthreads();
  // exclusive scan of the per-thread counts (Hillis-Steele in shared memory)
  for (int off = 1; off < kThreads; off <<= 1) {
    const int v = tid >= off ? counts[tid - off] : 0;
    __syncthreads();
    counts[tid] += v;
    __syncthreads();
  }
  const int before = counts[tid] - c;  // inclusive -> exclusive
  if (tid == kThreads - 1) s_new = counts[tid];
  __syncthreads();
  const int n_new = s_new;
  int rank = before;
  for (int i = lo; i < hi; ++i) {
    if (valid[i]) {
      dest[i] = start + rank;
      ++rank;
    } else {
      dest[i] = start + n_new + (i - rank);
    }
  }
  __syncthreads();
  for (int k = 0; k < f.n; ++k) {
    const int rb = f.row_bytes[k];
    if ((rb & 3) == 0) {
      const int words = rb >> 2;
      const uint32_t* s = reinterpret_cast<const uint32_t*>(f.src[k]);
      uint32_t* d = reinterpret_cast<uint32_t*>(f.dst[k]);
      for (long long e = tid; e < (long long)N * words; e += kThreads) {
        const int i = (int)(e / words), w = (int)(e % words);
        d[(long long)dest[i] * words + w] = s[e];
      }
    } else {
      for (long long e = tid; e < (long long)N * rb; e += kThreads) {
        const int i = (int)(e / rb), b = (int)(e % rb);
        f.dst[k][(long long)dest[i] * rb + b] = f.src[k][e];
      }
    }
  }
  for (int i = tid; i < N; i += kThreads) rb_valid[start + i] = i < n_new;
  if (tid == 0) {
    int n_lost = 0;
    for (int w = 0; w < kThreads / 32; ++w) n_lost += lost[w];
    *ptr = start + n_new;
    *size = *size - n_lost + n_new;
    *n_seen = *n_seen + n_new;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): `src`/`dst` hold n_fields device
// pointers (the window's rows and the ring's, in rl/replay.py's ROW_FIELDS
// order), `row_bytes` each field's bytes per row.  Launches one block on
// `stream`.  Returns the cudaError_t of the launch, -1 for a bad field table,
// -2 for a window the kernel does not take.
extern "C" int replay_ingest_launch(const uint64_t* src, const uint64_t* dst,
                                    const int* row_bytes, int n_fields,
                                    void* valid, void* rb_valid, void* ptr,
                                    void* size, void* n_seen, int N, int C,
                                    void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return -1;
  if (N < 1 || N > kMaxN || N > C) return -2;
  Fields f;
  f.n = n_fields;
  for (int k = 0; k < n_fields; ++k) {
    f.src[k] = reinterpret_cast<const uint8_t*>(src[k]);
    f.dst[k] = reinterpret_cast<uint8_t*>(dst[k]);
    f.row_bytes[k] = row_bytes[k];
    if (row_bytes[k] < 1) return -1;
  }
  replay_ingest_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      f, reinterpret_cast<const uint8_t*>(valid),
      reinterpret_cast<uint8_t*>(rb_valid), reinterpret_cast<int*>(ptr),
      reinterpret_cast<int*>(size), reinterpret_cast<int*>(n_seen), N, C);
  return (int)cudaGetLastError();
}
