// B6b, the replay sample, on Hopper (sm_90a): the port of the XLA-fused
// `replay_sample` (distributed_cluster_gpus_tpu/rl/replay.py:212): a uniform
// draw over the ring's valid rows by the inverse CDF, then the gather of the
// sampled rows of every field.  The JAX package has no Pallas kernel; this
// replaces the float32 cumsum over the ring, the uniform draw, the
// searchsorted and the eleven gathers.
//
// What it computes, for a ring of C rows and a batch of Bs draws:
//   total  = number of valid rows (an exact integer count: JAX's float32
//            cumsum is exact too, since C <= 2^24)
//   u_s    = unit_float(threefry bits of draw s) * max(total, 1)   (float32;
//            under the float64 clock, x64, unit_double of the block's 64
//            bits times max(total, 1) in double, as jax under
//            jax_enable_x64 draws it)
//   r_s    = floor(u_s);  idx_s = the row of rank r_s among the valid rows,
//            or C - 1 when r_s >= total (JAX's clip of searchsorted's C:
//            an empty ring, or u_s rounded up to the total)
//   out[field][s] = ring[field][idx_s]   for the 11 row fields
//   (s0 and s1 optionally rounded to bf16 as they are copied: the encoder's
//   input cast, round to nearest even as torch's `.to(bfloat16)`)
// searchsorted(cdf, u, 'right') counts the cdf entries <= u; with an
// integer cdf that is the first row whose cdf exceeds floor(u), the row of
// rank floor(u).  The bits are jax.random.uniform(key, (Bs,))'s: element s
// from the threefry block on counter (0, s) under the sample key
// (threefry.cuh), bit for bit.  The sample key is read from device memory:
// the key itself, or, given an update index i (an int32 on the device), the
// JAX update chain's split(fold_in(key, i))[0] for the chunk key `key`, so
// a CUDA graph of an update replays with the next update's key; the draw
// launch then advances the index by one (the last of its blocks, after
// every block has read it), so the update needs no launch of its own for
// that.
//
// Bound on the card: bytes.  A draw reads the ring's validity bytes (C, 200
// KB at the CLI's ring) and the Bs sampled rows (about 450 B each at the
// paper fleet's obs_dim 49) and writes them: ~0.43 MB, 0.13 us at 3.35
// TB/s; at that size two launch latencies are the floor.  Design, two
// launches on many SMs:
//   1. count: a block per 4,096-byte tile of the validity bytes, a 16-byte
//      load per thread, nonzero bytes counted with __popc, a block sum; the
//      last block to finish (an atomic ticket) scans the tile counts into
//      exclusive prefixes and the total, and resets the ticket;
//   2. draw + gather: a warp per draw: the key chain and the draw on every
//      lane, a 32-way search over the tile prefixes (32 loads at once a
//      round), then the row inside the tile in two warp-wide steps, each a
//      load a lane, __popc, a warp scan and __ballot_sync: the lanes'
//      128-byte counts find the lane's range, that range's 32 words the
//      word, the word's nonzero-byte mask the row; the warp then copies the
//      row of every field in the widest units (16, 8, 4, 2 or 1 bytes) the
//      field's row size and base allow, the units of all the fields spread
//      over the lanes and loaded before they are stored (one round trip for
//      the ~110 units of a paper-fleet row, not one per field).
// No host read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kTile = 4096;              // validity bytes per tile
constexpr int kCountThreads = kTile / 16;  // one 16-byte load a thread
constexpr int kMaxTiles = (1 << 24) / kTile;
constexpr int kDrawThreads = 256;        // 8 warps, a draw each
constexpr int kLaneBytes = kTile / 32;   // a lane's share of a tile
constexpr int kMaxFields = 16;

constexpr int kPass = 8;  // copy units a lane loads before it stores

struct Fields {
  const uint8_t* src[kMaxFields];
  uint8_t* dst[kMaxFields];
  int row_bytes[kMaxFields];
  int unit[kMaxFields];            // bytes per copy unit: 16, 8, 4, 2 or 1
  int cast[kMaxFields];            // float32 rows written as bf16 (a unit
                                   // of u source bytes stores u / 2)
  int first_unit[kMaxFields + 1];  // the fields' units, numbered in a row
  int n;
};

__device__ __forceinline__ uint4 load_unit(const uint8_t* p, int e, int unit) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  switch (unit) {
    case 16: v = reinterpret_cast<const uint4*>(p)[e]; break;
    case 8: {
      const uint2 w = reinterpret_cast<const uint2*>(p)[e];
      v.x = w.x;
      v.y = w.y;
      break;
    }
    case 4: v.x = reinterpret_cast<const uint32_t*>(p)[e]; break;
    case 2: v.x = reinterpret_cast<const uint16_t*>(p)[e]; break;
    default: v.x = p[e];
  }
  return v;
}

__device__ __forceinline__ void store_unit(uint8_t* p, int e, int unit,
                                           uint4 v) {
  switch (unit) {
    case 16: reinterpret_cast<uint4*>(p)[e] = v; break;
    case 8: reinterpret_cast<uint2*>(p)[e] = make_uint2(v.x, v.y); break;
    case 4: reinterpret_cast<uint32_t*>(p)[e] = v.x; break;
    case 2: reinterpret_cast<uint16_t*>(p)[e] = (uint16_t)v.x; break;
    default: p[e] = (uint8_t)v.x;
  }
}

// the unit's float32 words (unit / 4 of them) rounded to bf16 and stored
// as unit / 2 bytes at element e of p
__device__ __forceinline__ void store_bf16_unit(uint8_t* p, int e, int unit,
                                                uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint16_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(w[i])));
  switch (unit) {
    case 16:
      reinterpret_cast<uint2*>(p)[e] =
          make_uint2((uint32_t)h[0] | ((uint32_t)h[1] << 16),
                     (uint32_t)h[2] | ((uint32_t)h[3] << 16));
      break;
    case 8:
      reinterpret_cast<uint32_t*>(p)[e] =
          (uint32_t)h[0] | ((uint32_t)h[1] << 16);
      break;
    default: reinterpret_cast<uint16_t*>(p)[e] = h[0];
  }
}

constexpr unsigned kFull = 0xFFFFFFFFu;

// bit 7 of each nonzero byte of a 32-bit word
__device__ __forceinline__ uint32_t nz_mask(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

// the number of nonzero bytes of a 32-bit word
__device__ __forceinline__ int nz_bytes(uint32_t w) { return __popc(nz_mask(w)); }

// the inclusive sum of v over lanes 0..lane of a full warp
__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

// nonzero bytes of the 16 bytes at `off` (bytes at or past C count 0)
__device__ __forceinline__ int nz16(const uint8_t* __restrict__ valid, int off,
                                    int C) {
  if (off + 16 <= C) {
    const uint4 v = *reinterpret_cast<const uint4*>(valid + off);
    return nz_bytes(v.x) + nz_bytes(v.y) + nz_bytes(v.z) + nz_bytes(v.w);
  }
  int c = 0;
  for (int i = off; i < C && i < off + 16; ++i) c += valid[i] != 0;
  return c;
}

__global__ void __launch_bounds__(kCountThreads)
    replay_sample_count_kernel(const uint8_t* __restrict__ valid, int C,
                               int T, int* __restrict__ count,
                               int* __restrict__ prefix, unsigned* ticket) {
  __shared__ int warp_sum[kCountThreads / 32];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int c = nz16(valid, blockIdx.x * kTile + tid * 16, C);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < kCountThreads / 32; ++w) s += warp_sum[w];
    count[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)T - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: exclusive prefixes of the T tile counts, 16 tiles a
  // thread, then a block scan of the threads' sums (integer sums: exact in
  // any order)
  constexpr int kPer = kMaxTiles / kCountThreads;
  int local[kPer];
  int s = 0;
  for (int i = 0; i < kPer; ++i) {
    const int t = tid * kPer + i;
    local[i] = t < T ? __ldcg(count + t) : 0;
    s += local[i];
  }
  const int incl = warp_incl_scan(s, lane);
  __syncthreads();
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = incl - s;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  for (int i = 0; i < kPer; ++i) {
    const int t = tid * kPer + i;
    if (t <= T) prefix[t] = before;
    before += local[i];
  }
  if (tid == kCountThreads - 1 && T == kMaxTiles) prefix[T] = before;
  if (tid == 0) *ticket = 0u;
}

template <bool kX64>
__global__ void __launch_bounds__(kDrawThreads)
    replay_sample_draw_kernel(const __grid_constant__ Fields f,
                              const uint8_t* __restrict__ valid, int C, int T,
                              const int* __restrict__ prefix, int Bs,
                              const long long* __restrict__ key,
                              int* index, int advance, unsigned* ticket,
                              int* __restrict__ idx_out) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (kDrawThreads / 32) + (threadIdx.x >> 5);
  uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  if (index != nullptr) {  // the update's key, then its sample key
    uint32_t u0, u1;
    tf::child(k0, k1, (uint32_t)*index, u0, u1);
    tf::child(u0, u1, 0u, k0, k1);
  }
  if (advance) {
    // every warp of the block has read the index (its key came from it):
    // one arrival a block; the last to arrive advances it and resets the
    // ticket, so the launch replays in a CUDA graph
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
        *index = *index + 1;
        *ticket = 0u;
      }
    }
  }
  if (s >= Bs) return;
  uint32_t o0, o1;
  tf::threefry(k0, k1, 0u, (uint32_t)s, o0, o1);
  const int total = prefix[T];
  int r;  // u >= 0 and below 2^24: the floor, exactly
  if constexpr (kX64) {  // the float64 clock's run: a double uniform
    const double u = tf::unit_double(o0, o1) * fmax((double)total, 1.0);
    r = (int)u;
  } else {
    const float u = tf::unit_float(o0 ^ o1) * fmaxf((float)total, 1.0f);
    r = (int)u;
  }
  int row = C - 1;
  if (r < total) {
    // the tile a with prefix[a] <= r < prefix[a + 1], by a 32-way search:
    // each round the lanes read 32 evenly spaced prefixes of [a, b) at once
    // (prefix[a] <= r < prefix[b] throughout; 3 rounds at most)
    int a = 0, b = T;
    while (b - a > 1) {
      const int step = (b - a + 31) / 32;
      const int m = a + lane * step;
      const unsigned le = __ballot_sync(kFull, m < b && prefix[m] <= r);
      a += (31 - __clz(le)) * step;
      b = min(b, a + step);
    }
    const int k = r - prefix[a];
    // the lane of the tile holding rank k: each lane counts its 128 bytes
    const int tb = a * kTile;
    int c = 0;
    for (int i = 0; i < kLaneBytes; i += 16)
      c += nz16(valid, tb + lane * kLaneBytes + i, C);
    const int incl = warp_incl_scan(c, lane);
    const int owner = __ffs(__ballot_sync(kFull, incl > k)) - 1;
    const int k1 = k - __shfl_sync(kFull, incl - c, owner);
    // then the word of that lane's 32, a word a lane, and the byte in it
    const int wb = tb + owner * kLaneBytes + lane * 4;
    uint32_t m = 0;  // bit 7 of each nonzero byte (little-endian: row order)
    if (wb + 4 <= C) {
      m = nz_mask(*reinterpret_cast<const uint32_t*>(valid + wb));
    } else {
      for (int j = 0; j < 4; ++j)
        if (wb + j < C && valid[wb + j]) m |= 0x80u << (8 * j);
    }
    const int cw = __popc(m);
    const int iw = warp_incl_scan(cw, lane);
    const int wl = __ffs(__ballot_sync(kFull, iw > k1)) - 1;
    int kk = k1 - __shfl_sync(kFull, iw - cw, wl);
    int found = 0;
    for (int j = 0; j < 4; ++j) {
      if ((m >> (8 * j + 7)) & 1u) {
        if (kk == 0) { found = wb + j; break; }
        --kk;
      }
    }
    row = __shfl_sync(kFull, found, wl);
  }
  if (lane == 0) idx_out[s] = row;
  // the row of every field: its copy units numbered across the fields and
  // spread over the lanes, each pass's loads all issued before its stores
  const int total_units = f.first_unit[f.n];
  for (int base = 0; base < total_units; base += 32 * kPass) {
    uint4 v[kPass];
    int fk[kPass], fe[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const int i = base + j * 32 + lane;
      fk[j] = -1;
      if (i < total_units) {
        int k = 0;
        while (i >= f.first_unit[k + 1]) ++k;
        fk[j] = k;
        fe[j] = i - f.first_unit[k];
        v[j] = load_unit(f.src[k] + (long long)row * f.row_bytes[k], fe[j],
                         f.unit[k]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const int k = fk[j];
      if (k < 0) continue;
      if (f.cast[k])
        store_bf16_unit(f.dst[k] + (long long)s * (f.row_bytes[k] / 2), fe[j],
                        f.unit[k], v[j]);
      else
        store_unit(f.dst[k] + (long long)s * f.row_bytes[k], fe[j], f.unit[k],
                   v[j]);
    }
  }
}

// the widest copy unit that divides the row size and both base addresses
// (of a cast field: 16, 8 or 4 source bytes, whose bf16 half divides the
// destination's base; 0 if none does)
int copy_unit(uint64_t src, uint64_t dst, int rb, int cast) {
  if (cast) {
    for (int u = 16; u >= 4; u >>= 1)
      if (rb % u == 0 && src % u == 0 && dst % (u / 2) == 0) return u;
    return 0;
  }
  for (int u = 16; u > 1; u >>= 1)
    if (rb % u == 0 && src % u == 0 && dst % u == 0) return u;
  return 1;
}

}  // namespace

// Scratch sizes for a ring of C rows: the tile count T, then the ints the
// wrapper allocates (T counts and T + 1 prefixes).
extern "C" int replay_sample_tiles(int C) { return (C + kTile - 1) / kTile; }

// Plain C entry point (bound with ctypes): `src`/`dst` hold n_fields device
// pointers (the ring's rows and the batch's, in rl/replay.py's ROW_FIELDS
// order), `row_bytes` each field's bytes per row (of the ring's rows),
// `cast` 1 for a float32 field the batch holds as bf16; `valid` the ring's
// C validity bytes (16-byte aligned); `key` two int64 words on the device
// (the sample key, or with `index` non-null the chunk key and the int32
// update index on the device, which `advance` increments once every draw
// has read it); `x64` draws u in double (the float64 clock's run, jax under
// jax_enable_x64); idx [Bs] int32; `scratch` 2T + 1 ints; `ticket` two
// unsigned on the device, 0 at the launch and left 0.
// Launches the two kernels on `stream`.  Returns the first failing
// launch's cudaError_t, -1 for a bad field table, -2 for a batch or ring the
// kernel does not take.
extern "C" int replay_sample_launch(const uint64_t* src, const uint64_t* dst,
                                    const int* row_bytes, const int* cast,
                                    int n_fields, const void* valid, int C,
                                    int Bs, const void* key, void* index,
                                    int advance, int x64, void* idx,
                                    void* scratch, void* ticket,
                                    void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return -1;
  if (C < 1 || C > (1 << 24) || Bs < 1 ||
      reinterpret_cast<uint64_t>(valid) % 16 != 0 ||
      (advance && index == nullptr))
    return -2;
  Fields f;
  f.n = n_fields;
  for (int k = 0; k < n_fields; ++k) {
    if (row_bytes[k] < 1) return -1;
    f.src[k] = reinterpret_cast<const uint8_t*>(src[k]);
    f.dst[k] = reinterpret_cast<uint8_t*>(dst[k]);
    f.row_bytes[k] = row_bytes[k];
    f.cast[k] = cast[k] != 0;
    f.unit[k] = copy_unit(src[k], dst[k], row_bytes[k], f.cast[k]);
    if (f.unit[k] == 0) return -1;
  }
  f.first_unit[0] = 0;
  for (int k = 0; k < n_fields; ++k)
    f.first_unit[k + 1] = f.first_unit[k] + row_bytes[k] / f.unit[k];
  const int T = replay_sample_tiles(C);
  int* count = reinterpret_cast<int*>(scratch);
  int* prefix = count + T;
  cudaStream_t s = (cudaStream_t)stream;
  replay_sample_count_kernel<<<T, kCountThreads, 0, s>>>(
      reinterpret_cast<const uint8_t*>(valid), C, T, count, prefix,
      reinterpret_cast<unsigned*>(ticket));
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int warps = kDrawThreads / 32;
  auto draw = x64 ? replay_sample_draw_kernel<true>
                  : replay_sample_draw_kernel<false>;
  draw<<<(Bs + warps - 1) / warps, kDrawThreads, 0, s>>>(
      f, reinterpret_cast<const uint8_t*>(valid), C, T, prefix, Bs,
      reinterpret_cast<const long long*>(key), reinterpret_cast<int*>(index),
      advance, reinterpret_cast<unsigned*>(ticket) + 1,
      reinterpret_cast<int*>(idx));
  return (int)cudaGetLastError();
}
