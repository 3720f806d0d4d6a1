// B6a, the replay ingest, on Hopper (sm_90a): the port of the XLA-fused
// `_add_window` of the replay ring (distributed_cluster_gpus_tpu/rl/
// replay.py:165, through `replay_add_chunk`, :103) in the default
// "slotring" layout, and of `_add_scatter` (:132) in the "scatter" layout.
// The JAX package has no Pallas kernel; this replaces the jnp argsort +
// gather + dynamic_update_slice chain (slotring) and the cumsum + scatter
// (scatter).
//
// What it computes, for one window of N <= C rows into a ring of C:
//   rank_i = number of valid rows before row i, n_new = the window's valid
//            rows
//   slotring: start  = ptr + N <= C ? ptr : 0        (read on the device)
//             dest_i = start + rank_i                  for a valid row
//                    = start + n_new + (i - rank_i)    for an invalid one
//             (the valid rows first in insertion order, then the invalid
//             ones: the stable argsort of ~valid); valid[start + k] =
//             k < n_new; n_lost = the valid rows of [start, start + N)
//             before the write; ptr = start + n_new, size = size - n_lost +
//             n_new
//   scatter:  dest_i = (ptr + rank_i) mod C for a valid row, an invalid row
//             dropped; valid[dest_i] = 1; ptr = (ptr + n_new) mod C, size =
//             min(size + n_new, C)
//   both:     every row field copied to its dest, n_seen += n_new.
// No host read: the ring's pointer stays on the device between windows.
//
// Bound on the card: bytes.  A window moves each row once in and once out
// (456 B a row at the paper fleet's obs_dim 49 with 8 x 8 heads: two 196 B
// observations, four 8 B masks, the 16 B costs and four scalars) and reads
// the N valid flags (and, slotring, the N flags it overwrites): 3.74 MB at
// 4,096 rows, 1.1 us at 3.35 TB/s; there is no floating-point arithmetic.
// At the CLI's window a launch's latency is the floor.
//
// Design: one launch over the card (two above kSelfCountMax rows).  A block
// of 512 threads owns a tile of `rows` consecutive window rows (32 a
// warp-ballot group, 1-16 groups: up to 8,192 rows 32-row tiles, so a
// 4,096-row window spreads over 128 SMs, two rows a warp).  A warp's rows
// are loaded before anything else (their addresses are the source rows',
// so their latency hides behind the counts'; 16 warps of 2 rows beat 8 of
// 4: `chip_smoke.py --b6a-variants`).  Each block learns its tile's rank offset by counting valid[0,
// tile) itself from L2 with 16-byte loads and __popc (over the whole
// window up to kSelfCountMax rows, also giving n_new); above that a count
// launch first sums each 4,096-row tile and the last of its blocks scans
// the tile sums, and a block counts only inside its 4,096-row tile.
// Inside the tile each row's rank comes from the groups' __ballot_sync
// masks.  The ring's metadata: every block reads `ptr` (and its last warp
// `size` and `n_seen`) first, each warp storing what it read to shared
// memory before the block's barrier (so every read has returned), then
// counts one arrival after the barrier (one 64-bit atomic: the arrival in
// the high word, the block's n_lost share in the low one, so the last
// block learns both in one round trip, with no fence: it orders nothing
// but reads that have returned); the last block to arrive writes ptr, size
// and n_seen after every block has read ptr, and sets the word back to 0,
// so the launch replays.
// n_lost (slotring) sums the blocks' counts of their own slice of the
// overwritten window, each byte read by the lane that then writes it (the
// last warp, while the others copy).  The copy: a warp per row, two rows
// a warp in flight; each field's row in the widest unit of at most 8 bytes
// (a lane's registers: 16-byte units took 202 registers a thread and one
// block an SM) its row size and both base addresses allow (8 B the masks
// and the costs, 4 B the 196-byte observations), the units of all the fields spread over the
// lanes, every load of a batch issued before its stores; the destination
// row's address one 64-bit multiply, no division.  A field without a
// source (the window's `done` when the engine emits none) is filled with
// its constant word.  Any N from 1 to C <= 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = kWarps;       // 32-row groups a tile, at most
constexpr int kMaxFields = 16;
constexpr int kCountTile = 4096;         // rows a count launch's tile
constexpr int kMaxCountTiles = (1 << 24) / kCountTile;
constexpr int kSelfCountMax = 32768;     // windows whose blocks count alone
constexpr int kRowsAhead = 2;            // rows a warp loads before storing
constexpr int kPass = 4;                 // units a lane loads a row a pass
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Fields {
  const uint8_t* src[kMaxFields];  // null: fill with `fill` (4-byte words)
  uint8_t* dst[kMaxFields];
  int row_bytes[kMaxFields];
  int unit[kMaxFields];            // bytes a copy unit: 16, 8, 4, 2 or 1
  int first_unit[kMaxFields + 1];  // the fields' units, numbered in a row
  uint32_t fill[kMaxFields];
  int n;
};

struct Ring {
  const uint8_t* valid;  // the window's N flags
  uint8_t* rb_valid;     // the ring's C flags
  int *ptr, *size, *n_seen;
  unsigned long long* arrivals;  // the blocks' arrivals (high word) and
                                 // their n_lost shares (low): 0, left 0
  unsigned* count_ticket;        // the count launch's: 0, left 0
  const int* prefix;     // the count launch's T + 1 prefixes, or null
  int N, C, rows, scatter;
};

// bit 7 of each nonzero byte of a 32-bit word
__device__ __forceinline__ uint32_t nz_mask(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

// bit 7 of the bytes i of a word with from <= i < to (clamped to [0, 4))
__device__ __forceinline__ uint32_t byte_span(long long from, long long to) {
  const int f = (int)(from < 0 ? 0 : (from > 4 ? 4 : from));
  const int t = (int)(to < 0 ? 0 : (to > 4 ? 4 : to));
  if (t <= f) return 0u;
  const uint32_t upto = t == 4 ? 0xFFFFFFFFu : (1u << (8 * t)) - 1u;
  return upto & ~((1u << (8 * f)) - 1u) & 0x80808080u;
}

// This thread's share of the nonzero bytes of p[a, b) (a <= split <= b):
// .x those before `split`, .y all of them.  The block reads the aligned
// 16-byte chunks that cover the range, a chunk a thread at a time (a chunk
// never crosses a page, so the bytes outside the range it reads are
// mapped); bytes outside the range are masked off.
__device__ __forceinline__ int2 count_nz(const uint8_t* p, long long a,
                                         long long split, long long b) {
  int2 c = make_int2(0, 0);
  if (a >= b) return c;
  const long long base = (long long)reinterpret_cast<uintptr_t>(p);
  const long long A = base + a, S = base + split, H = base + b;
  for (long long q = (A & ~15LL) + 16LL * threadIdx.x; q < H;
       q += 16LL * kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long wb = q + 4 * j;
      const uint32_t m = nz_mask(w[j]);
      c.x += __popc(m & byte_span(A - wb, S - wb));
      c.y += __popc(m & byte_span(A - wb, H - wb));
    }
  }
  return c;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint2 load_unit(const uint8_t* p, int e, int unit) {
  uint2 v = make_uint2(0u, 0u);
  switch (unit) {
    case 8: v = reinterpret_cast<const uint2*>(p)[e]; break;
    case 4: v.x = reinterpret_cast<const uint32_t*>(p)[e]; break;
    case 2: v.x = reinterpret_cast<const uint16_t*>(p)[e]; break;
    default: v.x = p[e];
  }
  return v;
}

__device__ __forceinline__ void store_unit(uint8_t* p, int e, int unit,
                                           uint2 v) {
  switch (unit) {
    case 8: reinterpret_cast<uint2*>(p)[e] = v; break;
    case 4: reinterpret_cast<uint32_t*>(p)[e] = v.x; break;
    case 2: reinterpret_cast<uint16_t*>(p)[e] = (uint16_t)v.x; break;
    default: p[e] = (uint8_t)v.x;
  }
}

// The count launch (windows above kSelfCountMax rows): a block per
// 4,096-row tile sums its valid flags; the last block to finish writes the
// exclusive prefixes of the T tile sums and their total (prefix[T]) and
// resets its ticket.  Integer sums: exact in any order.
__global__ void __launch_bounds__(kThreads)
    replay_ingest_count_kernel(const uint8_t* __restrict__ valid, int N,
                               int T, int* __restrict__ count,
                               int* __restrict__ prefix, unsigned* ticket) {
  __shared__ int s_warp[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long a = (long long)blockIdx.x * kCountTile;
  const long long b = a + kCountTile < N ? a + kCountTile : N;
  int c = warp_sum(count_nz(valid, a, b, b).y);
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_warp[w];
    count[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)T - 1;
  }
  __syncthreads();
  if (!last) return;
  constexpr int kPer = kMaxCountTiles / kThreads;
  int local[kPer];
  int s = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = tid * kPer + i;
    local[i] = t < T ? __ldcg(count + t) : 0;
    s += local[i];
  }
  int incl = s;  // inclusive scan of the threads' sums over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = incl - s;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = tid * kPer + i;
    if (t <= T) prefix[t] = before;
    before += local[i];
  }
  if (tid == kThreads - 1 && T == kMaxCountTiles) prefix[T] = before;
  if (tid == 0) *ticket = 0u;
}

// A pass of a warp's rows' copy units: lane l's kPass units (field, element)
// of the units base + 32 p + l of a row (field -1: past the row)
struct Pass {
  int fk[kPass], fe[kPass];
};

__device__ __forceinline__ Pass units_of(const Fields& f, int base, int lane) {
  Pass u;
#pragma unroll
  for (int p = 0; p < kPass; ++p) {
    const int i = base + 32 * p + lane;
    u.fk[p] = -1;
    u.fe[p] = 0;
    if (i < f.first_unit[f.n]) {
      int k = 0;
      while (i >= f.first_unit[k + 1]) ++k;
      u.fk[p] = k;
      u.fe[p] = i - f.first_unit[k];
    }
  }
  return u;
}

// The pass's units of the window rows lo + j0 + kWarps u (u < kRowsAhead,
// rows past n_rows skipped), every load issued before any is used
__device__ __forceinline__ void load_rows(const Fields& f, const Pass& u,
                                          int lo, int j0, int n_rows,
                                          uint2 (&v)[kRowsAhead][kPass]) {
#pragma unroll
  for (int r = 0; r < kRowsAhead; ++r)
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int k = u.fk[p], j = j0 + r * kWarps;
      if (k < 0 || j >= n_rows) continue;
      v[r][p] = f.src[k] == nullptr
                    ? make_uint2(f.fill[k], 0u)
                    : load_unit(f.src[k] + (long long)(lo + j) * f.row_bytes[k],
                                u.fe[p], f.unit[k]);
    }
}

// ... and their stores at the rows' destinations (-1: dropped)
__device__ __forceinline__ void store_rows(const Fields& f, const Pass& u,
                                           const int (&dest)[kRowsAhead],
                                           const uint2 (&v)[kRowsAhead][kPass]) {
#pragma unroll
  for (int r = 0; r < kRowsAhead; ++r)
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int k = u.fk[p];
      if (k < 0 || dest[r] < 0) continue;
      store_unit(f.dst[k] + (long long)dest[r] * f.row_bytes[k], u.fe[p],
                 f.unit[k], v[r][p]);
    }
}

__global__ void __launch_bounds__(kThreads)
    replay_ingest_kernel(const __grid_constant__ Fields f,
                         const __grid_constant__ Ring g) {
  __shared__ int s_red[2][kWarps], s_start[kWarps];
  __shared__ uint32_t s_mask[kMaxGroups];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = blockIdx.x * g.rows;
  const int hi = lo + g.rows < g.N ? lo + g.rows : g.N;
  const int n_rows = hi - lo, units = f.first_unit[f.n];
  // the warp's first rows' first units, loaded before anything else is
  // known: their addresses are the source rows' (the counts' and the
  // pointer's latency hides theirs)
  const Pass u0 = units_of(f, 0, lane);
  uint2 v0[kRowsAhead][kPass];
  load_rows(f, u0, lo, warp, n_rows, v0);
  const int p0 = *g.ptr;
  // (what the last block writes from, read now: nothing else writes them)
  const bool meta = warp == kWarps - 1 && lane == 0;
  const int size0 = meta ? *g.size : 0, seen0 = meta ? *g.n_seen : 0;
  // the window's valid rows before the tile and in all, and the tile's
  // 32-row groups' flags
  int2 c;
  if (g.prefix == nullptr) {
    c = count_nz(g.valid, 0, lo, g.N);
  } else {
    const long long t0 = (long long)(lo / kCountTile) * kCountTile;
    c = count_nz(g.valid, t0, lo, lo);
  }
  if (warp < (n_rows + 31) / 32) {
    const int row = lo + 32 * warp + lane;
    s_mask[warp] = __ballot_sync(kFull, row < hi && g.valid[row] != 0);
  }
  c.x = warp_sum(c.x);
  c.y = warp_sum(c.y);
  const int start = g.scatter || p0 + g.N <= g.C ? p0 : 0;
  if (lane == 0) {
    s_red[0][warp] = c.x;
    s_red[1][warp] = c.y;
    s_start[warp] = start;  // so the warp's read of ptr has returned
  }
  __syncthreads();  // every warp's read of ptr has returned
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += s_red[0][w];
    total += s_red[1][w];
  }
  if (g.prefix != nullptr) {
    before += g.prefix[lo / kCountTile];
    total = g.prefix[(g.N + kCountTile - 1) / kCountTile];
  }
  // one arrival a block by its last warp, after every thread's read of
  // ptr, with the count of the valid rows of the tile's slice of the
  // overwritten window (slotring; each lane reads its bytes before it
  // writes them): one 64-bit atomic, the arrivals in its high word, the
  // counts summed in its low; the last block to arrive writes the ring's
  // metadata at its end
  bool last = false;
  int n_lost = 0;
  if (warp == kWarps - 1) {
    int lost = 0;
    if (!g.scatter)
      for (int k = lo + lane; k < hi; k += 32) lost += g.rb_valid[start + k] != 0;
    lost = warp_sum(lost);
    if (lane == 0) {
      const unsigned long long prev =
          atomicAdd(g.arrivals, (1ull << 32) | (unsigned)lost);
      last = (unsigned)(prev >> 32) == gridDim.x - 1;
      n_lost = (int)(prev & 0xFFFFFFFFull) + lost;
    }
    if (!g.scatter)
      for (int k = lo + lane; k < hi; k += 32) g.rb_valid[start + k] = k < total;
  }
  // a row's destination from its rank
  auto dest_of = [&](int j) {
    if (j >= n_rows) return -1;
    const int grp = j >> 5, bit = j & 31;
    int rank = before + __popc(s_mask[grp] & ((1u << bit) - 1u));
    for (int k = 0; k < grp; ++k) rank += __popc(s_mask[k]);
    const bool v = (s_mask[grp] >> bit) & 1u;
    if (!g.scatter) return v ? start + rank : start + total + (lo + j - rank);
    if (!v) return -1;
    const int d = p0 + rank;  // p0 <= C, rank < C: one subtraction
    return d >= g.C ? d - g.C : d;
  };
  // the copy: warp w takes the tile's rows w, w + kWarps, ..., kRowsAhead
  // at a time, its first pass already loaded
  for (int j0 = warp; j0 < n_rows; j0 += kWarps * kRowsAhead) {
    int dest[kRowsAhead];
#pragma unroll
    for (int r = 0; r < kRowsAhead; ++r) {
      dest[r] = dest_of(j0 + r * kWarps);
      if (g.scatter && dest[r] >= 0 && lane == 0) g.rb_valid[dest[r]] = 1;
    }
    for (int base = 0; base < units; base += 32 * kPass) {
      if (j0 == warp && base == 0) {
        store_rows(f, u0, dest, v0);
        continue;
      }
      const Pass u = units_of(f, base, lane);
      uint2 v[kRowsAhead][kPass];
      load_rows(f, u, lo, j0, n_rows, v);
      store_rows(f, u, dest, v);
    }
  }
  if (last) {  // every block has read ptr and added its n_lost share
    if (g.scatter) {
      *g.ptr = (int)(((long long)p0 + total) % g.C);
      const int s = size0 + total;
      *g.size = s < g.C ? s : g.C;
    } else {
      *g.ptr = start + total;
      *g.size = size0 - n_lost + total;
    }
    *g.n_seen = seen0 + total;
    *g.arrivals = 0ull;  // ready for the next launch on this stream
  }
}

// the widest copy unit (at most 8 bytes: a lane's registers) that divides
// the row size and both base addresses
int copy_unit(uint64_t src, uint64_t dst, int rb) {
  for (int u = 8; u > 1; u >>= 1)
    if (rb % u == 0 && src % u == 0 && dst % u == 0) return u;
  return 1;
}

}  // namespace

// The rows of a block's tile for a window of N rows (a multiple of 32: up
// to 8,192 rows 32, so the tiles spread over the card; up to 512).
extern "C" int replay_ingest_rows(int N) {
  int groups = (N + 32 * 256 - 1) / (32 * 256);
  if (groups < 1) groups = 1;
  if (groups > kMaxGroups) groups = kMaxGroups;
  return 32 * groups;
}

// The int32 scratch a window of N rows needs: 0 when its blocks count
// alone, else the count launch's T tile sums and T + 1 prefixes.
extern "C" int replay_ingest_scratch(int N) {
  if (N <= kSelfCountMax) return 0;
  const int T = (N + kCountTile - 1) / kCountTile;
  return 2 * T + 1;
}

// Plain C entry point (bound with ctypes): `src`/`dst` hold n_fields device
// pointers (the window's rows, 0 for a field filled with fill[k], and the
// ring's, in rl/replay.py's ROW_FIELDS order), `row_bytes` each field's
// bytes per row; `valid` the window's N flags, `rb_valid` the ring's C;
// `ptr`, `size`, `n_seen` int32 on the device; `scatter` 0 (slotring) or 1;
// `scratch` replay_ingest_scratch(N) ints; `state` four uint32 on the
// device, 8-byte aligned, 0 at the launch and left 0.  Returns the first failing launch's
// cudaError_t, -1 for a bad field table, -2 for a window the kernel does
// not take.
extern "C" int replay_ingest_launch(const uint64_t* src, const uint64_t* dst,
                                    const int* row_bytes, const uint32_t* fill,
                                    int n_fields, void* valid, void* rb_valid,
                                    void* ptr, void* size, void* n_seen, int N,
                                    int C, int scatter, void* scratch,
                                    void* state, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return -1;
  if (N < 1 || N > C || C > (1 << 24)) return -2;
  Fields f;
  f.n = n_fields;
  f.first_unit[0] = 0;
  for (int k = 0; k < n_fields; ++k) {
    if (row_bytes[k] < 1 || dst[k] == 0) return -1;
    if (src[k] == 0 && row_bytes[k] != 4) return -1;
    f.src[k] = reinterpret_cast<const uint8_t*>(src[k]);
    f.dst[k] = reinterpret_cast<uint8_t*>(dst[k]);
    f.row_bytes[k] = row_bytes[k];
    f.fill[k] = fill[k];
    f.unit[k] = src[k] == 0 ? 4 : copy_unit(src[k], dst[k], row_bytes[k]);
    if (dst[k] % f.unit[k] != 0) return -1;
    f.first_unit[k + 1] = f.first_unit[k] + row_bytes[k] / f.unit[k];
  }
  Ring g;
  g.valid = reinterpret_cast<const uint8_t*>(valid);
  g.rb_valid = reinterpret_cast<uint8_t*>(rb_valid);
  g.ptr = reinterpret_cast<int*>(ptr);
  g.size = reinterpret_cast<int*>(size);
  g.n_seen = reinterpret_cast<int*>(n_seen);
  if (reinterpret_cast<uintptr_t>(state) % 8 != 0) return -1;
  g.arrivals = reinterpret_cast<unsigned long long*>(state);
  g.count_ticket = reinterpret_cast<unsigned*>(state) + 2;
  g.prefix = nullptr;
  g.N = N;
  g.C = C;
  g.rows = replay_ingest_rows(N);
  g.scatter = scatter != 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N > kSelfCountMax) {
    const int T = (N + kCountTile - 1) / kCountTile;
    int* count = reinterpret_cast<int*>(scratch);
    int* prefix = count + T;
    replay_ingest_count_kernel<<<T, kThreads, 0, s>>>(
        g.valid, N, T, count, prefix, g.count_ticket);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
    g.prefix = prefix;
  }
  replay_ingest_kernel<<<(N + g.rows - 1) / g.rows, kThreads, 0, s>>>(f, g);
  return (int)cudaGetLastError();
}
