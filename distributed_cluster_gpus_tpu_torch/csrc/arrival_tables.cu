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
//     (threefry-2x32, 20 rounds, partitionable jax semantics; csrc/
//     threefry.cuh), the job size
//     (Pareto(1.8) for inference, max(0.1, LogNormal(ln 5e4, 0.4)) for
//     training) and the gap increment: Exp(1)/rate (poisson) or Exp(1)
//     (sinusoid inversion, where the fold carries the cumulative Exp sum);
//   * per stream: the sequential LEFT fold carry += inc[i] (never a
//     parallel scan: chunk invariance depends on this association);
//   * per (s, i): tnext = fold (poisson), epoch + 30-step bisection of the
//     integrated sinusoid rate (sin_inv), the trace's time at the cursor
//     (+inf past its end; a trace with explicit sizes reads them at
//     count - 1 and draws nothing), the inversion of a rate timeline's
//     integrated rate at the fold (a binary search over its cumulative
//     rates qc, the periodic wrap and its base as fused multiply-adds,
//     zero-rate bins and the end of a finite timeline), or +inf (off);
//   * per thinning stream (a sinusoid with |amp| > 1), `thin_kernel`, one
//     thread a (lane, stream) walking its entries in order: the rejection
//     loop of ops/arrivals.py next_interarrival, three threefry blocks, an
//     Exp, a uniform and the sinusoid a candidate (the slowest family: a
//     warp's threads diverge on their candidate counts).
// The trace and timeline constants come packed in one buffer with
// per-stream offsets (kernels/arrival_tables.py StreamConsts), so one
// launch still builds every stream's and every lane's tables.
// R rollout lanes (the JAX vmap axis) share one launch: lane r has its own
// arr_key, cursors and clocks, and its tables are bit for bit the ones a
// single-lane launch with that lane's inputs writes.
//
// Bound on the card (H100 SXM, 3.35 TB/s, S=16, n=4096): the output is
// 3 * 4 * S * n = 0.79 MB (0.23 us of memory time); the integer work is
// about 8 threefry blocks (~170 integer ops each) per entry, ~2e7 ops, a
// few us; the floor is the dependent float32 fold, 4096 adds per stream at
// ~4 cycles each, ~9.4 us at 1.75 GHz (the left fold is one chain: no
// parallel scan keeps its association).  Design, three launches:
//   1. `draws_kernel`, one thread per entry: keys, size, gap increment;
//   2. `fold_kernel`, one block per (stream, lane), a pipeline over chunks
//      of the stream's increments in a ring in shared memory: while thread
//      0 folds chunk c from registers (taking it as 16-byte vectors, the
//      next batch's loads in flight while it adds the current one, so the
//      chain of adds, not a load, is on every step, and writing the sums
//      back as vectors), the other warps write chunk c - 1's fold out and
//      stage chunk c + 1 (every load of a thread in flight at once);
//   3. `tnext_kernel`, one thread per entry over the whole card: the next
//      arrival from the fold (the 30-step bisections of the sinusoid's
//      inversion run on every SM, not on the S fold blocks' 16).  Where
//      the fold blocks alone fill the card (S x R at least twice its SMs:
//      the bench's 32 lanes), the fold blocks invert their own chunks as
//      they write them out, and this launch is not made.
//
// Built with -fmad=false: no product may be contracted into an FMA, so
// every float32 expression rounds as the plain version's separate torch
// ops round.  The erf_inv polynomial is the one place that wants fused
// multiply-adds (XLA's polynomial uses them); it calls fmaf explicitly.
//
// The float64 clock (`arrival_tables64_launch`, the JAX package under
// jax_enable_x64): the same three launches instantiated for double.  The
// draws take the 64 bits (o0 << 32 | o1) of the block whose float32 draw
// takes o0 ^ o1 (no more threefry rounds), the samplers run in double
// (the uniform's top 52 bits, log1p, pow, exp, XLA's double erf_inv
// polynomial `erfinv_f64` with each step rounded twice, as the plain
// version's torch ops round it, and cos in the inversion), the sizes are
// stored as float32, and the increments, the fold (a plain left fold, one
// double add an entry) and the next arrivals are double.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kFamOff = 0;
constexpr int kFamPoisson = 1;
constexpr int kFamSinInv = 2;
constexpr int kFamTrace = 3;
constexpr int kFamRateTl = 4;
constexpr int kFamThin = 5;
// StreamConsts.meta columns (kernels/arrival_tables.py M_*)
constexpr int kMOff = 0, kMLen = 1, kMSoff = 2, kMFlag = 3;
constexpr int kChunk = 512;  // a stage of the fold block's pipeline (floats)
constexpr int kRing = 3;     // chunks in flight: staged, folded, drained
constexpr int kFoldVec = 8;  // float4s the folding thread loads a batch
constexpr int kFoldPad = 4 * kFoldVec;  // floats a batch may read past a chunk

using tf::bits32;
using tf::child;
using tf::unit_double;
using tf::unit_float;

// XLA's double erf_inv (ops/prng.py erfinv_f64: the coefficients of its
// three branches, w < 6.25, w < 16 and above, read from its optimized HLO)
__device__ __constant__ double kErfSmall[23] = {
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
    6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
    1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027};
__device__ __constant__ double kErfMid[19] = {
    2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
    0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
    -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
    3.0838856104922208};
__device__ __constant__ double kErfLarge[17] = {
    -2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
    7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.8499064014085844};

__device__ double erfinv_f64(double x) {
  const double w = -log1p(-(x * x));
  const bool small = w < 6.25, mid = w < 16.0;
  const double z = small ? w - 3.125 : sqrt(w) - (mid ? 3.25 : 5.0);
  const double* c = small ? kErfSmall : (mid ? kErfMid : kErfLarge);
  const int len = small ? 23 : (mid ? 19 : 17);
  double p = c[0];
  for (int i = 1; i < len; ++i) p = c[i] + p * z;
  if (fabs(x) == 1.0) return x * CUDART_INF;
  return p * x;
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

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fmax_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_t(double a, double b) { return fmax(a, b); }

__device__ __forceinline__ float pymod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}
__device__ __forceinline__ double pymod(double a, double b) {
  double r = fmod(a, b);
  if (r != 0.0 && ((r < 0.0) != (b < 0.0))) r += b;
  return r;
}

// kernel 1: one thread per (lane, stream, entry) - keys, size, gap
// increment (TimeT: the clock's type, float or double).  A trace with
// explicit sizes reads them at count - 1 and draws nothing; the trace and
// thinning families draw no gap (their increments are 0).
template <typename TimeT>
__global__ void draws_kernel(const int64_t* __restrict__ arr_key,
                             const int* __restrict__ c0,
                             const int* __restrict__ family,
                             const float* __restrict__ sparams, int R, int S,
                             int n, const float* __restrict__ sbuf,
                             const int* __restrict__ meta,
                             float* __restrict__ sizes,
                             TimeT* __restrict__ inc,
                             int* __restrict__ aux_key,
                             TimeT* __restrict__ aux_u) {
  constexpr bool kD = sizeof(TimeT) == 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * S * n) return;
  const int rs = (int)(idx / n);  // lane * S + stream
  const int r = rs / S;
  const int s = rs - r * S;
  const int i = (int)(idx - (long long)rs * n);
  const int fam = family[s];
  const bool no_gap = fam == kFamOff || fam == kFamTrace || fam == kFamThin;
  if (no_gap) {
    inc[idx] = (TimeT)0;
    if (aux_key != nullptr) {
      aux_key[2 * idx] = 0;
      aux_key[2 * idx + 1] = 0;
      aux_u[idx] = (TimeT)0;
    }
  }
  if (fam == kFamOff) {
    sizes[idx] = 0.0f;
    return;
  }
  if (fam == kFamTrace && meta[4 * s + kMFlag]) {
    const int len = meta[4 * s + kMLen];
    int c = c0[rs] + i - 1;
    c = c < 0 ? 0 : (c > len - 1 ? len - 1 : c);
    sizes[idx] = sbuf[meta[4 * s + kMSoff] + c];
    return;
  }
  const float rate = sparams[4 * s + 0];
  uint32_t ks0, ks1, k0, k1, a0, a1, b0, b1;
  child((uint32_t)arr_key[2 * r], (uint32_t)arr_key[2 * r + 1], (uint32_t)s,
        ks0, ks1);
  child(ks0, ks1, (uint32_t)(c0[rs] + i), k0, k1);
  child(k0, k1, 0u, a0, a1);  // k_size
  child(k0, k1, 1u, b0, b1);  // k_gap
  // sample_job_size: (k_u, k_n) = split(k_size)
  uint32_t u0, u1, z0, z1;
  float size;
  if constexpr (kD) {
    if ((s & 1) == 0) {
      child(a0, a1, 0u, u0, u1);
      uint32_t h, l;
      tf::bits64(u0, u1, h, l);
      const double u = fmax(1e-9, 1.0 - unit_double(h, l));
      size = (float)(1.0 / pow(u, 1.0 / 1.8));
    } else {
      child(a0, a1, 1u, z0, z1);
      // uniform in (nextafter(-1, 0), 1): f * (1 - lo) + lo, 1 - lo = 2
      const double lo = -0x1.fffffffffffffp-1;  // nextafter(-1, 0)
      uint32_t h, l;
      tf::bits64(z0, z1, h, l);
      const double un = fmax(lo, unit_double(h, l) * (1.0 - lo) + lo);
      const double z = 1.4142135623730951 * erfinv_f64(un);
      const double mu = (double)logf(50000.0f);
      size = (float)fmax(0.1, exp(mu + 0.4 * z));
    }
  } else {
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
  }
  sizes[idx] = size;
  if (no_gap) return;
  TimeT ug, e;
  if constexpr (kD) {
    uint32_t h, l;
    tf::bits64(b0, b1, h, l);
    ug = unit_double(h, l);
    e = -log1p(-ug);
  } else {
    ug = unit_float(bits32(b0, b1));
    e = -log1pf(-ug);
  }
  if (fam == kFamPoisson) {
    // e * (1/rate): the float32 rate's reciprocal in the clock's type
    inc[idx] = rate > 0.0f ? e * ((TimeT)1 / (TimeT)fmaxf(rate, 1e-30f))
                           : (TimeT)CUDART_INF_F;
  } else {
    inc[idx] = e;
  }
  if (aux_key != nullptr) {
    aux_key[2 * idx] = (int)b0;
    aux_key[2 * idx + 1] = (int)b1;
    aux_u[idx] = ug;
  }
}

// A stream's constants of its next arrivals, once per (stream, lane): its
// family, the epoch, and for the sinusoid's inversion the terms that do
// not depend on the entry
// (the epoch, the phase and its cosine in the clock's type; the float32
// shape terms promote to it where they meet them)
template <typename TimeT>
struct Arrive {
  int fam;
  TimeT ep;
  float rate, period, w;
  TimeT phase0, cos0;
  float coef, den_lo, den_hi, den_per;
  // trace: its times and length and the stream's cursor; rate_timeline:
  // qc [T+1], rates [T], bin_s, T * bin_s (at `tl`), T and periodic
  const TimeT* tl;
  int len, c0, per;
};

__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }

template <typename TimeT>
__device__ __forceinline__ Arrive<TimeT> arrive_of(
    const int* __restrict__ family, const float* __restrict__ sparams,
    const TimeT* __restrict__ epoch, const TimeT* __restrict__ cbuf,
    const int* __restrict__ meta, const int* __restrict__ c0, int s, int rs) {
  Arrive<TimeT> A;
  A.fam = family[s];
  A.ep = epoch[rs];
  A.tl = nullptr;
  A.len = A.c0 = A.per = 0;
  if (A.fam == kFamTrace || A.fam == kFamRateTl) {
    A.tl = cbuf + meta[4 * s + kMOff];
    A.len = meta[4 * s + kMLen];
    A.per = meta[4 * s + kMFlag];
    A.c0 = c0[rs];
  }
  const float rate = sparams[4 * s + 0], amp_s = sparams[4 * s + 1];
  const float period = sparams[4 * s + 2];
  const TimeT anchor = A.ep + (TimeT)sparams[4 * s + 3];
  const float a = fabsf(amp_s);
  A.rate = rate;
  A.period = period;
  A.w = 6.28318548f / period;
  A.phase0 = (TimeT)A.w * pymod(anchor, (TimeT)period);
  A.cos0 = cos_t(A.phase0);
  A.coef = rate * amp_s / A.w;
  A.den_lo = fmaxf(rate * (1.0f + a), 1e-30f);
  A.den_hi = fmaxf(rate * (1.0f - a), 1e-9f);
  A.den_per = fmaxf(rate * period, 1e-30f);
  return A;
}

// the 30-step bisection of the integrated sinusoid rate for cumulative
// Exp sum s (ops/arrivals.py sinusoid_gap_from_cum)
__device__ __forceinline__ float sin_inv_gap(const Arrive<float>& A, float s) {
  float lo = s / A.den_lo;
  float hi = fminf(s / A.den_hi, (s / A.den_per + 1.0f) * A.period);
  for (int it = 0; it < 30; ++it) {
    const float mid = 0.5f * (lo + hi);
    const float g =
        A.rate * mid + A.coef * (A.cos0 - cosf(A.phase0 + A.w * mid));
    if (g < s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return 0.5f * (lo + hi);
}
// ... in double, the float32 terms widened
__device__ __forceinline__ double sin_inv_gap(const Arrive<double>& A,
                                              double s) {
  const double rate = A.rate, w = A.w, coef = A.coef, period = A.period;
  double lo = s / (double)A.den_lo;
  double hi = fmin(s / (double)A.den_hi, (s / (double)A.den_per + 1.0) * period);
  for (int it = 0; it < 30; ++it) {
    const double mid = 0.5 * (lo + hi);
    const double g = rate * mid + coef * (A.cos0 - cos(A.phase0 + w * mid));
    if (g < s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return 0.5 * (lo + hi);
}

// Lambda^{-1}(s) of a piecewise-constant rate timeline (T bins), as
// kernels/arrival_tables.py `invert_timeline` computes it: the periodic
// wrap's remainder and its base added by fused multiply-adds (XLA's CPU
// contraction, both clocks), searchsorted(side="right") as the count of
// boundaries qc[k] <= s, zero-rate bins and the end of a finite timeline
template <typename TimeT>
__device__ TimeT invert_timeline(const TimeT* __restrict__ tl, int T, int per,
                                 TimeT s) {
  const TimeT* qc = tl;
  const TimeT* rates = tl + T + 1;
  const TimeT bs = tl[2 * T + 1], span = tl[2 * T + 2];
  const TimeT inf = (TimeT)CUDART_INF_F;
  TimeT srem = s, wraps = (TimeT)0;
  if (per) {
    const TimeT total = qc[T];
    wraps = floor(s * ((TimeT)1 / total));
    srem = fma_t(-wraps, total, s);
  }
  int lo = 0, hi = T + 1;  // the first boundary above srem
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (qc[mid] <= srem) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int b = lo - 1;
  b = b < 0 ? 0 : (b > T - 1 ? T - 1 : b);
  const TimeT rb = rates[b], qb = qc[b];
  const TimeT bt = (TimeT)b * bs;
  TimeT t_in = bt + (srem - qb) / fmax_t(rb, (TimeT)1e-30);
  if (!(rb > (TimeT)0)) t_in = srem <= qb ? bt : inf;
  if (!per) return srem > qc[T] ? inf : t_in;
  return fma_t(wraps, span, t_in);
}

// the next arrival of entry i of a stream from its fold f (a thinning
// stream's come from thin_kernel, which runs after)
template <typename TimeT>
__device__ __forceinline__ TimeT tnext_of(const Arrive<TimeT>& A, TimeT f,
                                          int i) {
  const TimeT inf = (TimeT)CUDART_INF_F;
  if (A.fam == kFamPoisson) return f;
  if (A.fam == kFamSinInv)
    return A.ep + (A.rate > 0.0f ? sin_inv_gap(A, f) : inf);
  if (A.fam == kFamTrace) {
    const long long c = (long long)A.c0 + i;
    return c < A.len ? A.tl[c] : inf;
  }
  if (A.fam == kFamRateTl) return invert_timeline(A.tl, A.len, A.per, f);
  return inf;
}

// The left fold c += tile[j], tile[j] = c over tile[0..len) by one thread
// (the tile 16-byte aligned, with kFoldPad readable floats past len):
// whole batches of kFoldVec float4s in two register sets, the next batch's
// loads issued (unconditionally: a batch past the whole ones reads the pad
// and is not used) before the current batch's adds, then the rest one
// float at a time.  Returns the carry.
__device__ __forceinline__ void fold_batch(float4 (&v)[kFoldVec], float4* t4,
                                           float& c) {
#pragma unroll
  for (int u = 0; u < kFoldVec; ++u) {
    float4 x = v[u];
    c = c + x.x;
    x.x = c;
    c = c + x.y;
    x.y = c;
    c = c + x.z;
    x.z = c;
    c = c + x.w;
    x.w = c;
    t4[u] = x;
  }
}

__device__ __forceinline__ void load_batch(float4 (&v)[kFoldVec],
                                           const float4* t4) {
#pragma unroll
  for (int u = 0; u < kFoldVec; ++u) v[u] = t4[u];
}

// the double clock's fold: one add an entry, in order
__device__ __forceinline__ double fold_tile(double* tile, int len, double c) {
  for (int j = 0; j < len; ++j) {
    c = c + tile[j];
    tile[j] = c;
  }
  return c;
}

__device__ __forceinline__ float fold_tile(float* tile, int len, float c) {
  float4* t4 = reinterpret_cast<float4*>(tile);
  const int nb = len / (4 * kFoldVec) * kFoldVec;  // float4s in whole batches
  float4 a[kFoldVec], b[kFoldVec];
  load_batch(a, t4);
  for (int i = 0; i < nb; i += 2 * kFoldVec) {
    load_batch(b, t4 + i + kFoldVec);
    fold_batch(a, t4 + i, c);
    if (i + kFoldVec >= nb) break;
    load_batch(a, t4 + i + 2 * kFoldVec);
    fold_batch(b, t4 + i + kFoldVec, c);
  }
  for (int j = 4 * nb; j < len; ++j) {
    c = c + tile[j];
    tile[j] = c;
  }
  return c;
}

// src[0..len) into dst, threads t0, t0 + nt, ...: each thread's loads in
// flight together
template <typename TimeT>
__device__ __forceinline__ void stage(TimeT* dst, const TimeT* src, int len,
                                      int t0, int nt) {
  for (int j0 = t0; j0 < len; j0 += 4 * nt) {
    TimeT v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * nt;
      v[u] = j < len ? src[j] : (TimeT)0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u * nt < len) dst[j0 + u * nt] = v[u];
  }
}

// kernel 2: one block per (stream, lane) - the sequential fold of the
// increments (in `cum`) into the cumulative row, in place; with `invert`
// also the next arrivals (`tnext_of`) of its entries
template <typename TimeT>
__global__ void fold_kernel(const int* __restrict__ family,
                            const float* __restrict__ sparams,
                            const TimeT* __restrict__ t0,
                            const TimeT* __restrict__ cum0,
                            const TimeT* __restrict__ epoch,
                            const TimeT* __restrict__ cbuf,
                            const int* __restrict__ meta,
                            const int* __restrict__ c0, int n,
                            int invert, TimeT* __restrict__ cum,
                            TimeT* __restrict__ tnext) {
  __shared__ __align__(16) TimeT ring[kRing][kChunk + kFoldPad];
  const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int rs = blockIdx.y * gridDim.x + s;  // lane * S + stream
  TimeT* row = cum + (long long)rs * n;
  TimeT* trow = tnext + (long long)rs * n;
  const int nc = (n + kChunk - 1) / kChunk;
  const Arrive<TimeT> A =
      arrive_of(family, sparams, epoch, cbuf, meta, c0, s, rs);
  // chunk k's fold out of the ring (and its next arrivals), threads t0,
  // t0 + step, ...
  auto drain = [&](int k, int t0, int step) {
    const TimeT* buf = ring[k % kRing];
    const int base = k * kChunk, len = min(kChunk, n - base);
    for (int j = t0; j < len; j += step) {
      row[base + j] = buf[j];
      if (invert) trow[base + j] = tnext_of(A, buf[j], base + j);
    }
  };
  // thread 0's carry: the cumulative Exp sum or the clock
  TimeT c = (A.fam == kFamSinInv || A.fam == kFamRateTl) ? cum0[rs] : t0[rs];
  stage(ring[0], row, min(kChunk, n), tid, nt);
  __syncthreads();
  for (int k = 0; k < nc; ++k) {
    if (tid == 0) {
      c = fold_tile(ring[k % kRing], min(kChunk, n - k * kChunk), c);
    } else if (tid >= 32) {  // warps 1..: the chunks either side
      if (k > 0) drain(k - 1, tid - 32, nt - 32);
      if (k + 1 < nc)
        stage(ring[(k + 1) % kRing], row + (k + 1) * kChunk,
              min(kChunk, n - (k + 1) * kChunk), tid - 32, nt - 32);
    }
    __syncthreads();
  }
  drain(nc - 1, tid, nt);
}

// kernel 3: one thread per (lane, stream, entry) - the next arrival from
// the fold
template <typename TimeT>
__global__ void tnext_kernel(const int* __restrict__ family,
                             const float* __restrict__ sparams,
                             const TimeT* __restrict__ epoch,
                             const TimeT* __restrict__ cbuf,
                             const int* __restrict__ meta,
                             const int* __restrict__ c0, int R, int S,
                             int n, const TimeT* __restrict__ cum,
                             TimeT* __restrict__ tnext) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * S * n) return;
  const int rs = (int)(idx / n);  // lane * S + stream
  tnext[idx] = tnext_of(
      arrive_of(family, sparams, epoch, cbuf, meta, c0, rs % S, rs), cum[idx],
      (int)(idx - (long long)rs * n));
}

__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }

// kernel 4: one thread per (lane, thinning stream) - the sequential replay
// of the rejection loop, entry by entry (kernels/arrival_tables.py
// `thinning_replay`, op for op): entry i's k_gap = split(fold_in(fold_in(
// arr_key, s), c0 + i))[1]; each candidate splits its key into three (the
// next key, the Exp draw's, the uniform's), adds Exp / lam_max to w and
// accepts when u <= lambda(t + phase + w) / lam_max, lambda the clamped
// sinusoid at (2 pi mod(x, period)) / period; at most 2^22 candidates.
template <typename TimeT>
__global__ void thin_kernel(const int64_t* __restrict__ arr_key,
                            const int* __restrict__ c0,
                            const TimeT* __restrict__ t0,
                            const int* __restrict__ family,
                            const float* __restrict__ sparams,
                            const TimeT* __restrict__ cbuf,
                            const int* __restrict__ meta, int R, int S, int n,
                            TimeT* __restrict__ tnext) {
  constexpr bool kD = sizeof(TimeT) == 8;
  const int rs = blockIdx.x * blockDim.x + threadIdx.x;
  if (rs >= R * S) return;
  const int r = rs / S, s = rs - r * S;
  if (family[s] != kFamThin) return;
  const float rate = sparams[4 * s + 0], amp = sparams[4 * s + 1];
  const TimeT period = (TimeT)sparams[4 * s + 2];
  const TimeT phase = cbuf[meta[4 * s + kMOff]];
  const float lam_max = rate * (1.0f + fabsf(amp));
  const TimeT denom = (TimeT)fmaxf(lam_max, 1e-30f);
  const bool live = lam_max > 0.0f;
  const TimeT inf = (TimeT)CUDART_INF_F;
  const TimeT two_pi = kD ? (TimeT)6.283185307179586 : (TimeT)6.2831855f;
  uint32_t ks0, ks1;
  child((uint32_t)arr_key[2 * r], (uint32_t)arr_key[2 * r + 1], (uint32_t)s,
        ks0, ks1);
  TimeT t = t0[rs];
  TimeT* row = tnext + (long long)rs * n;
  for (int i = 0; i < n; ++i) {
    uint32_t k0, k1, g0, g1;
    child(ks0, ks1, (uint32_t)(c0[rs] + i), k0, k1);
    child(k0, k1, 1u, g0, g1);  // k_gap
    const TimeT tq = t + phase;
    TimeT w = (TimeT)0;
    bool done = !live;
    for (int it = 0; it < (1 << 22) && !done; ++it) {
      uint32_t n0, n1, w0, w1, u0, u1;
      child(g0, g1, 0u, n0, n1);
      child(g0, g1, 1u, w0, w1);
      child(g0, g1, 2u, u0, u1);
      g0 = n0;
      g1 = n1;
      TimeT e, u;
      if constexpr (kD) {
        uint32_t h, l;
        tf::bits64(w0, w1, h, l);
        e = -log1p(-unit_double(h, l));
        tf::bits64(u0, u1, h, l);
        u = unit_double(h, l);
      } else {
        e = -log1pf(-unit_float(bits32(w0, w1)));
        u = unit_float(bits32(u0, u1));
      }
      w = w + e / denom;
      const TimeT x = tq + w;
      const TimeT ph = two_pi * pymod(x, period) / period;
      TimeT lam = (TimeT)rate * ((TimeT)1 + (TimeT)amp * sin_t(ph));
      lam = isnan(lam) ? lam : fmax_t(lam, (TimeT)0);
      done = u <= lam / denom;
    }
    t = t + ((live && isfinite(w)) ? w : inf);
    row[i] = t;
  }
}

// The launches for one clock type (see arrival_tables_launch).
template <typename TimeT>
int launch_tables(const int64_t* arr_key, const int* c0, const TimeT* t0,
                  const TimeT* cum0, const TimeT* epoch, const int* family,
                  const float* sparams, int R, int S, int n, float* sizes,
                  TimeT* tnext, TimeT* cum, int* aux_key, TimeT* aux_u,
                  const TimeT* cbuf, const float* sbuf, const int* meta,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0 || S <= 0 || n <= 0) return (int)cudaSuccess;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)R * S * n;
  const int blocks = (int)((total + threads - 1) / threads);
  draws_kernel<TimeT><<<blocks, threads, 0, st>>>(
      arr_key, c0, family, sparams, R, S, n, sbuf, meta, sizes, cum, aux_key,
      aux_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the fold blocks invert their own entries where they alone fill the card
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int invert = (long long)S * R >= 2LL * sms;
  fold_kernel<TimeT><<<dim3(S, R), threads, 0, st>>>(
      family, sparams, t0, cum0, epoch, cbuf, meta, c0, n, invert, cum, tnext);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!invert) {
    tnext_kernel<TimeT><<<blocks, threads, 0, st>>>(
        family, sparams, epoch, cbuf, meta, c0, R, S, n, cum, tnext);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (meta != nullptr) {  // the thinning streams, if any, last
    const int tb = 64;
    thin_kernel<TimeT><<<(R * S + tb - 1) / tb, tb, 0, st>>>(
        arr_key, c0, t0, family, sparams, cbuf, meta, R, S, n, tnext);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Per-lane inputs are [R, 2]
// (arr_key) and [R, S] (c0, t0, cum0, epoch); outputs are [R, S, n].  `cum`
// doubles as the increment scratch of the first two kernels.  aux_key/aux_u
// may be null; when given they receive each entry's k_gap key words and its
// uniform draw.  cbuf/sbuf/meta (kernels/arrival_tables.py StreamConsts)
// may be null when no stream is a trace, a rate timeline or a thinning
// replay.  Returns the cudaError_t of the launches (0 on success).
extern "C" int arrival_tables_launch(const int64_t* arr_key, const int* c0,
                                     const float* t0, const float* cum0,
                                     const float* epoch, const int* family,
                                     const float* sparams, int R, int S, int n,
                                     float* sizes, float* tnext, float* cum,
                                     int* aux_key, float* aux_u,
                                     const float* cbuf, const float* sbuf,
                                     const int* meta, void* stream) {
  return launch_tables<float>(arr_key, c0, t0, cum0, epoch, family, sparams,
                              R, S, n, sizes, tnext, cum, aux_key, aux_u,
                              cbuf, sbuf, meta, stream);
}

// The float64 clock's tables: the clocks, `tnext`, `cum` and `aux_u` are
// double (`sizes` stays float32); otherwise as arrival_tables_launch.
extern "C" int arrival_tables64_launch(const int64_t* arr_key, const int* c0,
                                       const double* t0, const double* cum0,
                                       const double* epoch, const int* family,
                                       const float* sparams, int R, int S,
                                       int n, float* sizes, double* tnext,
                                       double* cum, int* aux_key,
                                       double* aux_u, const double* cbuf,
                                       const float* sbuf, const int* meta,
                                       void* stream) {
  return launch_tables<double>(arr_key, c0, t0, cum0, epoch, family, sparams,
                               R, S, n, sizes, tnext, cum, aux_key, aux_u,
                               cbuf, sbuf, meta, stream);
}
