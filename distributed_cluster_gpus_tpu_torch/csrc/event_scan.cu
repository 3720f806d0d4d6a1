// B1, the event scan, on Hopper (sm_90a): the port of the XLA-fused scan
// `Engine._run_chunk` -> `lax.scan(Engine._step)` (distributed_cluster_gpus_
// tpu/sim/engine.py:4581 and :2966), the K=1 write-plan program with ring
// queues for the heuristic algorithms (default_policy, joint_nf) and, in RL
// mode, for chsac_af's acting path.  The JAX package has no Pallas kernel;
// this replaces the fused jnp step.
//
// What it computes: `n_steps` events of every rollout lane, exactly as the
// plain torch engine (`Engine._scan_plain`, sim/engine.py, the kernel's
// oracle in kernels/event_scan.py) computes them, one event per step:
//   B1a head: first-index argmins of the projected finish times [J], the
//       XFER t_avail [J] and the arrival clocks [S]; the 4-way event choice
//       (ties finish < xfer < arrival < log); the exact accrual (per-DC power
//       as a fixed-tree dc_sum plus the idle floor, energy and GPU time, job
//       progress); the first EMPTY slot; the per-event key split;
//   B1b the planners (finish, xfer, arrival) and the shared commit;
//   B1c the bounded queue drain with the admission decision and the
//       physics refresh (`_row_TP`);
//   B1d the queue rings (push with drop counting, head with inference
//       priority and free-GPU gating, pop);
//   B1e the log tick (per-DC cluster row, log clock).
// Steps after the run is done only advance the key, as the plain engine's.
//
// RL mode (chsac_af, `Lane::step_rl`): the event branches defer routing and
// the post-finish drain to the policy tail, which runs on every event:
//   B3 (sim/algos.py:210 `windowed_percentile`, `rlk::windowed_p99`): the
//       exact linear-interpolation p99 of both latency windows.  The window
//       lives in shared memory.  A warp bitonic sort of the 32 lane maxima
//       gives a threshold no larger than the K-th largest value (K = top
//       `ceil(0.01 W) + 2`, 23 at W = 2048), each lane keeps its few
//       candidates at or above it in registers, and rounds of warp max +
//       tie count walk the distinct values down to the two ranks the
//       interpolation reads (a scan of the window per round when some lane
//       holds more than 4 candidates).  Bound: the window's bytes, read once.
//   B4 (sim/engine.py:3454 `_tail_head`, :3584 `_policy_tail_planned`,
//       :1840 `_commit_tail`, with rl/nets.py and rl/sac.py:150): the
//       observation, the masks, ONE encoder/actor forward when a route or a
//       drain decision is pending, the Gumbel-max samples, the step's RL
//       record and the tail commit.  The forward is a warp GEMV: a lane owns
//       outputs o = lane + 32k and sums its K products by the reference
//       recipe's halving tree, which it evaluates as pairwise sums over the
//       inputs in bit-reversed order (the wrapper stores each weight row and
//       the kernel each activation in that order, padded with zeros to a
//       power of two).  bf16 operands, exact float32 products, one bf16
//       rounding before and one after the bias, as rl/nets.py's
//       `bf16_dense`.  Bound: the 0.43 MB of bf16 weights per decision
//       (L2-resident here) against 3.35 TB/s; one warp is far below it.
//
// Bound on the card: an event is a chain of dependent steps (three argmins,
// n_dc tree sums, the branch, a drain loop), each a few hundred cycles of
// latency, so one lane is latency-bound on one SM; the bytes (the slab in and
// out once per chunk, ~100 B of emissions per event) and the operations
// (~20 per slot per event) bound it far below that.  Design: one block of
// ONE warp per lane (grid = R lanes); the job slab (18 four-byte fields x J)
// lives in shared memory for the whole launch, the rings [n_dc, 2, Q, 11] in
// global memory; reductions over J are warp-wide (a lane owns the slots
// j = lane + 32k) and need no block barrier; the scalar program of an event
// runs on lane 0 between __syncwarp()s.  Emissions go straight to the
// preallocated [R, n_steps, ...] buffers; the rest of the state is written
// back once, at chunk end.  No host read happens inside the chunk.
//
// Rounding: built with -fmad=false and IEEE division (-prec-div=true, the
// default), never fast math.  Each float expression is the plain engine's,
// op for op: `fmul_pinned` is a*b + a*0 (one rounding, the reference's
// signed-zero fence), reciprocals are multiplied where the plain engine
// multiplies by one, true division stays true division, `(f*f)*f` keeps its
// order, and the dc_sum is the reference's fixed halving tree (element i +
// element i + p/2 at each level, zero-padded to a power of two p).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDC = 32;
constexpr int kMaxS = 64;
constexpr int kMaxF = 32;
constexpr int kMaxObs = 256;    // widest observation (kernels/event_scan.py)
constexpr int kMaxWidth = 512;  // widest layer
constexpr int kNLayers = 6;     // encoder 0-2, actor hidden, DC head, GPU head

constexpr int EV_FINISH = 0, EV_XFER = 1, EV_ARRIVAL = 2, EV_LOG = 3,
              EV_NOOP = 4;
constexpr int ST_EMPTY = 0, ST_XFER = 1, ST_RUNNING = 3;
// the policy tail's pending decision
constexpr int REQ_NONE = 0, REQ_ROUTE = 1, REQ_DRAIN = 2;

// QRec field indices (models/structs.py)
enum {
  R_SIZE, R_SEQ, R_INGRESS, R_T_INGRESS, R_T_AVAIL, R_NET_LAT, R_UNITS_DONE,
  R_T_START, R_PREEMPT_COUNT, R_PREEMPT_T, R_TOTAL_PREEMPT, N_REC
};
constexpr int kClusterCols = 14;
constexpr int kJobCols = 15;

// Pointer table, in kernels/event_scan.py's PTR_NAMES order.  Per-lane
// leaves have a leading lane axis [R, ...]; fleet constants have none.
enum Ptr {
  P_T, P_KEY, P_JID, P_STARTED, P_T_FIRST, P_NEXT_LOG, P_N_EVENTS, P_N_FIN,
  P_UNITS_FIN, P_N_DROP, P_DONE,
  P_BUSY, P_CUR_F, P_ENERGY, P_UTIL, P_ACC,
  P_NEXT_ARR, P_ARR_COUNT,
  P_LAT_BUF, P_LAT_COUNT, P_LAT_PTR,
  P_Q_RECS, P_Q_HEAD, P_Q_TAIL,
  P_JOBS,  // 18 JobSlab fields in dataclass order
  P_SIZES = P_JOBS + 18, P_TNEXT, P_C0,
  P_EM_T, P_EM_BRANCH, P_EM_CLUSTER, P_EM_JOB,
  P_FREQ, P_TOTAL, P_EGRID, P_TRANSFER, P_NETLAT,
  P_PA, P_PB, P_PG, P_LA, P_LB, P_LG, P_IDLE_W,
  // RL mode only (null otherwise): the slab's RL trace [R, J, ...], the
  // per-step RL records [R, n_steps, ...], the policy's bf16 operands
  P_RL_OBS0, P_RL_ADC, P_RL_AG, P_RL_MDC0, P_RL_MG0, P_RL_VALID,
  P_E_VALID, P_E_S0, P_E_S1, P_E_ADC, P_E_AG, P_E_MDC0, P_E_MG0, P_E_R,
  P_E_COSTS, P_E_MDC, P_E_MG,
  P_W0,  // per layer: the weight [out, pow2(in)] then the bias [out]
  N_PTRS = P_W0 + 2 * kNLayers
};

// Integer parameters, in kernels/event_scan.py's INT_NAMES order.
enum Int {
  I_R, I_NSTEPS, I_NDC, I_NING, I_NF, I_NCAP, I_J, I_P, I_Q, I_W, I_NTAB,
  I_KDRAIN, I_DEFAULT_F, I_ALGO_JNF, I_PERF_FIRST, I_INF_PRIORITY,
  I_RESERVE, I_MAXGPU, I_FHI, I_FLO, I_SCALE_OUT_LOW,
  I_RL, I_GREEDY, I_OBS_DIM, I_PERC_K, I_WH0, I_WH1, I_WLAT, I_WAH,
  N_INTS
};

enum Flt { F_END, F_LOG_INTERVAL, F_SLA_THR, F_NEG_W, F_SLA_MS, N_FLTS };

struct Args {
  void* p[N_PTRS];
  int i[N_INTS];
  float f[N_FLTS];
};

// slab fields in shared memory: 8 int32 columns then 10 float32 columns
enum JI { JI_STATUS, JI_JTYPE, JI_INGRESS, JI_DC, JI_SEQ, JI_N, JI_FIDX,
          JI_PCOUNT, N_JI };
enum JF { JF_SIZE, JF_UDONE, JF_TING, JF_TAVAIL, JF_TSTART, JF_NETLAT,
          JF_PT, JF_TPT, JF_SPU, JF_WATTS, N_JF };
// JobSlab dataclass order -> (is_float, column)
__constant__ int kJobIsF[18] = {0, 0, 0, 0, 0, 1, 1, 0, 0,
                                1, 1, 1, 1, 0, 1, 1, 1, 1};
__constant__ int kJobCol[18] = {JI_STATUS, JI_JTYPE, JI_INGRESS, JI_DC,
                                JI_SEQ,    JF_SIZE,  JF_UDONE,   JI_N,
                                JI_FIDX,   JF_TING,  JF_TAVAIL,  JF_TSTART,
                                JF_NETLAT, JI_PCOUNT, JF_PT,     JF_TPT,
                                JF_SPU,    JF_WATTS};

// per-lane scalars and small arrays, in static shared memory
struct Small {
  float t, t_first, next_log_t, dt;
  uint32_t k0, k1, kev0, kev1;
  int jid, started, done, n_events, n_dropped;
  int n_fin[2];
  float units_fin[2];
  int lat_count[2], lat_ptr[2];
  // step-local results of the head, read by every lane
  int branch, j_fin, j_x, a_idx, has_slot, slot, can, flag;
  int busy[kMaxDC], cur_f[kMaxDC], total[kMaxDC];
  float energy[kMaxDC], util[kMaxDC], acc[kMaxDC], powers[kMaxDC];
  float red[kMaxDC], idle_w[kMaxDC], inv_total[kMaxDC];
  // each DC's running-job power (the dc_sum of the accrual), kept between
  // events and recomputed only for a DC whose running set changed
  float active[kMaxDC];
  int dirty[kMaxDC];
  int run_tot[kMaxDC], run_inf[kMaxDC];
  int qhead[2 * kMaxDC], qtail[2 * kMaxDC];
  float pa[2 * kMaxDC], pb[2 * kMaxDC], pg[2 * kMaxDC];
  float la[2 * kMaxDC], lb[2 * kMaxDC], lg[2 * kMaxDC];
  int jnf_n[2 * kMaxDC], jnf_f[2 * kMaxDC];
  float freq[kMaxF];
  float next_arr[kMaxS];
  int arr_count[kMaxS], c0[kMaxS];
  float rec[N_REC];
  // RL mode: the action key, the step's finish record and pending decision,
  // both windows' p99, the masks, the action and the deferred start
  uint32_t ka0, ka1;
  int req_kind, req_idx;
  int fin_jt, fin_dcj, fin_slot;
  float fin_soj, fin_over;
  float p99[2];
  int mdc[kMaxDC], mg[kMaxDC];
  int a_dc, a_g;
  int st_on, st_j, st_dcj, st_jt, st_n, st_f, st_newf;
  float st_t0, st_pt0, st_tpt0;
};

// ---------------------------------------------------------------- helpers

// fmul_pinned: the product rounded once, plus the reference's a*0 fence
__device__ __forceinline__ float fmulp(float a, float b) {
  return a * b + a * 0.0f;
}

// torch.clamp(x, min=m): NaN propagates
__device__ __forceinline__ float clamp_min(float x, float m) {
  return isnan(x) ? x : fmaxf(x, m);
}

// torch.minimum: NaN propagates
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// Python/jnp a % b on floats (the divisor's sign), exact
__device__ __forceinline__ float tmod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r = r + b;
  return r;
}

// torch.remainder on int32
__device__ __forceinline__ int iremainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// int32 arithmetic with int32 wraparound
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// argmin order of torch.argmin: NaN first, then smaller, ties to the lower
// index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na && nb) ? ia < ib : na;
  if (a < b) return true;
  if (b < a) return false;
  return ia < ib;
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kAll, v, off);
    const int oi = __shfl_xor_sync(kAll, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__device__ __forceinline__ T* lane_ptr(const Args& a, int which, long long n,
                                       int r) {
  return reinterpret_cast<T*>(a.p[which]) + (long long)r * n;
}

// ---------------------------------------------------------------- RL mode:
// B3 (the windowed p99) and B4's policy (forward, log-softmax, sampling) as
// warp-level device functions, shared by the event scan and the standalone
// batched launch `rl_tail_batch_launch`.

namespace rlk {

constexpr float kTiny = 1.17549435e-38f;  // float32's smallest normal
constexpr float kNegMask = -1e9f;          // rl/nets.py NEG_MASK

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

// The k-th largest (1-based) of the warp's 32 values: a bitonic sort of the
// lanes into descending order, read at lane k - 1.
__device__ float warp_kth_largest(float v, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kAll, v, stride);
      const bool up = (lane & size) == 0, lower = (lane & stride) == 0;
      v = (lower == up) ? fmaxf(v, o) : fminf(v, o);
    }
  }
  return __shfl_sync(kAll, v, k - 1);
}

// Descending order statistics r_lo >= r_hi (0-based ranks, with ties
// counted) of buf[0..m), m >= 1, into s_lo / s_hi (all lanes).  The ring
// holds latencies: finite values.
__device__ void rank_values(const float* buf, int m, int K, int r_lo, int r_hi,
                            float& s_lo, float& s_hi, int lane) {
  float lm = -CUDART_INF_F;
  for (int j = lane; j < m; j += 32) lm = fmaxf(lm, buf[j]);
  // no larger than the K-th largest value: K lane maxima lie at or above it
  const float tau = K <= 32 ? warp_kth_largest(lm, K, lane) : -CUDART_INF_F;
  constexpr int kC = 4;
  float c[kC];
  int nc = 0;
  bool over = false;
#pragma unroll
  for (int q = 0; q < kC; ++q) c[q] = -CUDART_INF_F;
  for (int j = lane; j < m; j += 32) {
    const float v = buf[j];
    if (v >= tau) {
      if (nc < kC) {
#pragma unroll
        for (int q = 0; q < kC; ++q)
          if (q == nc) c[q] = v;
        ++nc;
      } else {
        over = true;
      }
    }
  }
  const bool regs = !__any_sync(kAll, over);
  s_lo = s_hi = -CUDART_INF_F;
  float prev = CUDART_INF_F;
  bool first = true;
  int cum = 0;
  for (;;) {
    float v = -CUDART_INF_F;
    if (regs) {
#pragma unroll
      for (int q = 0; q < kC; ++q)
        if (q < nc && (first || c[q] < prev)) v = fmaxf(v, c[q]);
    } else {
      for (int j = lane; j < m; j += 32) {
        const float x = buf[j];
        if (x >= tau && (first || x < prev)) v = fmaxf(v, x);
      }
    }
    v = warp_max(v);
    int cnt = 0;
    if (regs) {
#pragma unroll
      for (int q = 0; q < kC; ++q) cnt += (q < nc && c[q] == v) ? 1 : 0;
    } else {
      for (int j = lane; j < m; j += 32) {
        const float x = buf[j];
        cnt += (x >= tau && x == v) ? 1 : 0;
      }
    }
    cnt = __reduce_add_sync(kAll, cnt);
    if (cnt == 0) break;  // cannot happen for r_lo < m; a guard
    if (r_hi >= cum && r_hi < cum + cnt) s_hi = v;
    if (r_lo >= cum && r_lo < cum + cnt) {
      s_lo = v;
      break;
    }
    cum += cnt;
    prev = v;
    first = false;
  }
}

// sim/algos.py `windowed_percentile(buf, count, 99)`: the result in every
// lane.  The interpolation rounds as the plain version does: the second
// product fused into the add.
__device__ float windowed_p99(const float* buf, int count, int W, int K,
                              int lane) {
  const int m = count < W ? count : W;
  const int mf = m > 1 ? m : 1;
  const float pos = 0.99f * (float)(mf - 1);
  const int lo = (int)floorf(pos);
  const int hi = lo + 1 < mf - 1 ? lo + 1 : mf - 1;
  const float frac = pos - (float)lo;
  int r_lo = mf - 1 - lo, r_hi = mf - 1 - hi;
  r_lo = r_lo < 0 ? 0 : (r_lo > K - 1 ? K - 1 : r_lo);
  r_hi = r_hi < 0 ? 0 : (r_hi > K - 1 ? K - 1 : r_hi);
  float s_lo = -CUDART_INF_F, s_hi = -CUDART_INF_F;
  if (m > 0) rank_values(buf, m, K, r_lo, r_hi, s_lo, s_hi, lane);
  return __fmaf_rn(s_hi, frac, __fmul_rn(s_lo, 1.0f - frac));
}

// ---- the policy forward (rl/nets.py's recipe)

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_bits(uint16_t u) {
  return __uint_as_float((uint32_t)u << 16);
}

__device__ __forceinline__ int log2_pow2(int p) { return __ffs(p) - 1; }

// position of element o in the bit-reversed order of a power-of-two width
__device__ __forceinline__ int bitrev(int o, int p) {
  const int b = log2_pow2(p);
  return b == 0 ? 0 : (int)(__brev((unsigned)o) >> (32 - b));
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// One output's K = KP products summed by the halving tree: over the inputs
// in bit-reversed order the tree is the sum of adjacent pairs, level by
// level (groups of 16 leaves in registers, then the group sums).  `xs` and
// `w` are both in that order.
template <int KP>
__device__ __forceinline__ float dot_tree(const float* xs, const uint16_t* w) {
  constexpr int G = KP < 16 ? KP : 16;
  constexpr int NG = KP / G;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  float gs[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float p[G];
#pragma unroll
    for (int h8 = 0; h8 < G / 8; ++h8) {
      const uint4 q = __ldg(wv + (g * G) / 8 + h8);
      const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = g * G + h8 * 8 + 2 * e;
        p[h8 * 8 + 2 * e] = __fmul_rn(xs[idx], __uint_as_float(u[e] << 16));
        p[h8 * 8 + 2 * e + 1] =
            __fmul_rn(xs[idx + 1], __uint_as_float(u[e] & 0xffff0000u));
      }
    }
#pragma unroll
    for (int h = 1; h < G; h <<= 1)
#pragma unroll
      for (int e = 0; e < G; e += 2 * h) p[e] = __fadd_rn(p[e], p[e + h]);
    gs[g] = p[0];
  }
#pragma unroll
  for (int h = 1; h < NG; h <<= 1)
#pragma unroll
    for (int g = 0; g < NG; g += 2 * h) gs[g] = __fadd_rn(gs[g], gs[g + h]);
  return gs[0];
}

// One bf16 Dense: xs [KP] (bit-reversed, shared) -> n_out outputs.  With
// `relu` the outputs go to `out` in the next layer's bit-reversed order over
// kp_out (zero padding included); without it (the heads) to out[o].
template <int KP>
__device__ void dense_t(const float* xs, const uint16_t* W, const uint16_t* b,
                        int n_out, float* out, int kp_out, bool relu,
                        int lane) {
  for (int o = lane; o < n_out; o += 32) {
    const float acc = dot_tree<KP>(xs, W + (long long)o * KP);
    const float y = bf16_round(acc);
    float z = bf16_round(__fadd_rn(y, bf16_bits(b[o])));
    if (relu) {
      z = z > 0.0f ? z : 0.0f;
      out[bitrev(o, kp_out)] = z;
    } else {
      out[o] = z;
    }
  }
  if (relu)
    for (int n = lane; n < kp_out; n += 32)
      if (bitrev(n, kp_out) >= n_out) out[n] = 0.0f;
}

__device__ void dense(const float* xs, int kp, const uint16_t* W,
                      const uint16_t* b, int n_out, float* out, int kp_out,
                      bool relu, int lane) {
  switch (kp) {
    case 8: dense_t<8>(xs, W, b, n_out, out, kp_out, relu, lane); break;
    case 16: dense_t<16>(xs, W, b, n_out, out, kp_out, relu, lane); break;
    case 32: dense_t<32>(xs, W, b, n_out, out, kp_out, relu, lane); break;
    case 64: dense_t<64>(xs, W, b, n_out, out, kp_out, relu, lane); break;
    case 128: dense_t<128>(xs, W, b, n_out, out, kp_out, relu, lane); break;
    case 256: dense_t<256>(xs, W, b, n_out, out, kp_out, relu, lane); break;
    default: dense_t<512>(xs, W, b, n_out, out, kp_out, relu, lane); break;
  }
}

struct Policy {
  const uint16_t* w[kNLayers];
  const uint16_t* b[kNLayers];
  int in[kNLayers], out[kNLayers];
  int greedy;
};

// Encoder (3 ReLU layers) and actor (ReLU hidden, two heads): the logits of
// the DC head into logit[0..n_dc) and of the GPU-count head into
// logit[32..32+n_g).  `obs` [in[0]] float32 in natural order (shared).
__device__ void forward(const Policy& P, const float* obs, float* act0,
                        float* act1, float* logit, int lane) {
  const int kp0 = pow2_at_least(P.in[0]);
  for (int n = lane; n < kp0; n += 32) {
    const int r = bitrev(n, kp0);
    act0[n] = r < P.in[0] ? bf16_round(obs[r]) : 0.0f;
  }
  __syncwarp();
  float* x = act0;
  float* y = act1;
  for (int k = 0; k < 4; ++k) {
    dense(x, pow2_at_least(P.in[k]), P.w[k], P.b[k], P.out[k], y,
          pow2_at_least(P.out[k]), true, lane);
    __syncwarp();
    float* t = x;
    x = y;
    y = t;
  }
  dense(x, pow2_at_least(P.in[4]), P.w[4], P.b[4], P.out[4], logit, 0, false,
        lane);
  dense(x, pow2_at_least(P.in[5]), P.w[5], P.b[5], P.out[5], logit + 32, 0,
        false, lane);
  __syncwarp();
}

// rl/nets.py `masked_log_softmax` over n <= 32 logits (one thread): the
// infeasible logits at -1e9, the exponentials summed by the halving tree.
__device__ void masked_log_softmax(const float* logit, const int* mask, int n,
                                   float* logp) {
  float x[32], e[32];
  float m = -CUDART_INF_F;
  for (int i = 0; i < n; ++i) {
    x[i] = mask[i] ? logit[i] : kNegMask;
    m = i == 0 ? x[i] : fmaxf(m, x[i]);
  }
  const int p = pow2_at_least(n);
  for (int i = 0; i < p; ++i) e[i] = i < n ? expf(__fsub_rn(x[i], m)) : 0.0f;
  for (int half = p >> 1; half >= 1; half >>= 1)
    for (int i = 0; i < half; ++i) e[i] = __fadd_rn(e[i], e[i + half]);
  const float lse = logf(e[0]);
  for (int i = 0; i < n; ++i) logp[i] = __fsub_rn(__fsub_rn(x[i], m), lse);
}

// jax.random.categorical(key, logp) (Gumbel-max over uniform(tiny, 1), the
// first maximum wins), or the first argmax when greedy (one thread).
__device__ int sample(uint32_t k0, uint32_t k1, const float* logp, int n,
                      bool greedy) {
  int best = 0;
  float bv = 0.0f;
  const float span = __fsub_rn(1.0f, kTiny);
  for (int i = 0; i < n; ++i) {
    float v = logp[i];
    if (!greedy) {
      uint32_t o0, o1;
      tf::threefry(k0, k1, 0u, (uint32_t)i, o0, o1);
      const float f = tf::unit_float(o0 ^ o1);
      const float u = fmaxf(kTiny, __fadd_rn(__fmul_rn(f, span), kTiny));
      const float g = -logf(-logf(u));
      v = __fadd_rn(g, logp[i]);
    }
    if (i == 0 || v > bv) {
      bv = v;
      best = i;
    }
  }
  return best;
}

}  // namespace rlk

}  // namespace

namespace {

// Everything one lane's warp needs; every thread holds a copy.
struct Lane {
  Small& sm;
  int lane, J, P, n_dc, n_f, Q, W, n_tab, k_drain, default_f, algo_jnf,
      perf_first, inf_priority, reserve, maxgpu, f_hi, f_lo, scale_out_low;
  float end, li;
  int* si;      // [N_JI, J] shared
  float* sf;    // [N_JF, J] shared
  float* vals;  // [P] shared scratch
  float* scr;   // [P] shared scratch
  float* recs;  // [n_dc, 2, Q, N_REC] global (this lane's)
  float* lat_buf;
  float* em_t;
  int* em_branch;
  float* em_cluster;
  float* em_job;
  const float* sizes;  // [S, n_tab] (this lane's)
  const float* tnext;
  const float* transfer;  // [n_ing, n_dc, 2]
  const float* netlat;    // [n_ing, n_dc]
  const float* egrid;     // E_grid_cap [n_dc, 2, n_cap, n_f]
  int n_cap;
  // RL mode
  int rl, obs_dim, K, n_g;
  float sla_thr, neg_w, sla_ms, inv_kwh;
  rlk::Policy pol;
  float* obs;    // [kMaxObs] shared
  float* act0;   // [kMaxWidth] shared
  float* act1;   // [kMaxWidth] shared
  float* logit;  // [64] shared: DC head at 0, GPU-count head at 32
  float* logp;   // [64] shared, the same layout
  // the slab's RL trace (global, this lane's rows)
  float* rl_obs0;
  int* rl_adc;
  int* rl_ag;
  uint8_t* rl_mdc0;
  uint8_t* rl_mg0;
  uint8_t* rl_valid;
  // the per-step RL records (this lane's)
  uint8_t* e_valid;
  float* e_s0;
  float* e_s1;
  int* e_adc;
  int* e_ag;
  uint8_t* e_mdc0;
  uint8_t* e_mg0;
  float* e_r;
  float* e_costs;
  uint8_t* e_mdc;
  uint8_t* e_mg;

  __device__ __forceinline__ int& I(int f, int j) { return si[f * J + j]; }
  __device__ __forceinline__ float& F(int f, int j) { return sf[f * J + j]; }

  // ------------------------------------------------ warp-wide slab passes

  // first EMPTY slot, or J when the slab is full (all lanes)
  __device__ int first_empty() {
    for (int base = 0; base < J; base += 32) {
      const int j = base + lane;
      const unsigned m =
          __ballot_sync(kAll, j < J && I(JI_STATUS, j) == ST_EMPTY);
      if (m) return base + __ffs(m) - 1;
    }
    return J;
  }

  // Per-DC fixed-tree sums of vals[0..J) into out[d] (all lanes): for each
  // DC, the values of its slots (zero elsewhere and in the padding to P)
  // reduced by the reference's halving tree.  Levels with half >= 32 pair
  // slots of one lane (j and j + half are congruent mod 32); the last five
  // levels are warp shuffles, element i taking element i + half.  With
  // `only_dirty`, DCs whose flag in sm.dirty is clear keep their out[d].
  __device__ void dc_tree_sums(float* out, bool only_dirty) {
    for (int d = 0; d < n_dc; ++d) {
      if (only_dirty && !sm.dirty[d]) continue;
      for (int j = lane; j < P; j += 32)
        scr[j] = (j < J && I(JI_DC, j) == d) ? vals[j] : 0.0f;
      for (int half = P >> 1; half >= 32; half >>= 1)
        for (int j = lane; j < half; j += 32) scr[j] = scr[j] + scr[j + half];
      float v = lane < P ? scr[lane] : 0.0f;
      for (int half = (P < 32 ? P : 32) >> 1; half >= 1; half >>= 1) {
        const float o = __shfl_down_sync(kAll, v, half);
        if (lane < half) v = v + o;
      }
      if (lane == 0) out[d] = v;
    }
    __syncwarp();
  }

  // ------------------------------------------------ scalar helpers (lane 0)

  __device__ int free_for(int dcj, int jt) {
    const int fr = wsub(sm.total[dcj], sm.busy[dcj]);
    if (reserve <= 0 || jt != 1) return fr;
    const int f2 = wsub(fr, reserve);
    return f2 > 0 ? f2 : 0;
  }

  // _row_TP: (seconds per unit, watts) at (dc, jtype, n, f_idx)
  __device__ void row_tp(int dcj, int jt, int n, int f_idx, float& spu,
                         float& watts) {
    const int q = dcj * 2 + jt;
    const float f = sm.freq[f_idx];
    // step_time_s
    const int nn = n > 1 ? n : 1;
    const float ff = clamp_min(f, 1e-9f);
    const float inv = 1.0f / ff;
    const float base = sm.la[q] + fmulp(sm.lb[q], inv);
    spu = (nn == 1) ? base
                    : (base + fmulp(sm.lg[q], (float)nn)) / (float)nn;
    // task_power_w
    const int n2 = n > 0 ? n : 0;
    const float f2 = clamp_min(f, 0.0f);
    const float gp = fmulp(sm.pa[q], (f2 * f2) * f2) + fmulp(sm.pb[q], f2) +
                     sm.pg[q];
    watts = fmulp((float)n2, gp);
  }

  __device__ void rec_from_slab(int j, float* rec) {
    rec[R_SIZE] = F(JF_SIZE, j);
    rec[R_SEQ] = (float)I(JI_SEQ, j);
    rec[R_INGRESS] = (float)I(JI_INGRESS, j);
    rec[R_T_INGRESS] = F(JF_TING, j);
    rec[R_T_AVAIL] = F(JF_TAVAIL, j);
    rec[R_NET_LAT] = F(JF_NETLAT, j);
    rec[R_UNITS_DONE] = F(JF_UDONE, j);
    rec[R_T_START] = F(JF_TSTART, j);
    rec[R_PREEMPT_COUNT] = (float)I(JI_PCOUNT, j);
    rec[R_PREEMPT_T] = F(JF_PT, j);
    rec[R_TOTAL_PREEMPT] = F(JF_TPT, j);
  }

  // _ring_push: append, or count a drop when the ring is full
  __device__ void ring_push(int dcj, int jt, const float* rec) {
    const int q = dcj * 2 + jt;
    const int tail = sm.qtail[q];
    if (wsub(tail, sm.qhead[q]) < Q) {
      float* row = recs + ((long long)q * Q + iremainder(tail, Q)) * N_REC;
      for (int k = 0; k < N_REC; ++k) row[k] = rec[k];
      sm.qtail[q] = wadd(tail, 1);
    } else {
      sm.n_dropped = wadd(sm.n_dropped, 1);
    }
  }

  // _ring_head: the head record to start at dcj (into sm.rec); returns jt,
  // sets `found`
  __device__ int ring_head(int dcj, bool& found) {
    const int q0 = dcj * 2, q1 = dcj * 2 + 1;
    const bool has0 = wsub(sm.qtail[q0], sm.qhead[q0]) > 0;
    const bool has1 = wsub(sm.qtail[q1], sm.qhead[q1]) > 0;
    const bool has_i = has0 && free_for(dcj, 0) > 0;
    const bool has_t = has1 && free_for(dcj, 1) > 0;
    const int jt = inf_priority ? (has_i ? 0 : 1) : (has_t ? 1 : 0);
    const int q = dcj * 2 + jt;
    const float* row =
        recs + ((long long)q * Q + iremainder(sm.qhead[q], Q)) * N_REC;
    for (int k = 0; k < N_REC; ++k) sm.rec[k] = row[k];
    found = has_i || has_t;
    return jt;
  }

  // _decide_start_vals + _start_from_rec: commit `rec` to RUNNING at slot
  __device__ void start_from_rec(int slot, int dcj, int jt, const float* rec) {
    const int fr = free_for(dcj, jt);
    const int cur = sm.cur_f[dcj];
    int n_d, f_d, new_f;
    if (algo_jnf) {
      n_d = sm.jnf_n[dcj * 2 + jt];
      f_d = sm.jnf_f[dcj * 2 + jt];
      new_f = cur;
    } else {  // heuristic_select
      const int g0 = fr < maxgpu ? fr : maxgpu;
      const int g = g0 > 1 ? g0 : 1;
      int trn_f;
      if (perf_first) {
        const int q_inf = wsub(sm.qtail[dcj * 2], sm.qhead[dcj * 2]);
        const int want = q_inf > 0 ? f_hi : default_f;
        trn_f = cur > want ? cur : want;
      } else if (scale_out_low) {
        trn_f = fr >= 2 ? f_lo : (cur > f_lo ? cur : f_lo);
      } else {
        trn_f = cur > f_lo ? cur : f_lo;
      }
      n_d = g;
      f_d = jt == 0 ? f_hi : trn_f;
      new_f = f_d;
    }
    const int m = n_d < fr ? n_d : fr;
    const int n_st = m > 1 ? m : 1;
    float spu, watts;
    row_tp(dcj, jt, n_st, f_d, spu, watts);
    const float t = sm.t;
    const float t_start0 = rec[R_T_START];
    const bool resuming = rec[R_PREEMPT_T] > 0.0f;
    I(JI_STATUS, slot) = ST_RUNNING;
    I(JI_JTYPE, slot) = jt;
    I(JI_INGRESS, slot) = (int)rec[R_INGRESS];
    I(JI_DC, slot) = dcj;
    I(JI_SEQ, slot) = (int)rec[R_SEQ];
    F(JF_SIZE, slot) = rec[R_SIZE];
    F(JF_UDONE, slot) = rec[R_UNITS_DONE];
    I(JI_N, slot) = n_st;
    I(JI_FIDX, slot) = f_d;
    F(JF_SPU, slot) = spu;
    F(JF_WATTS, slot) = watts;
    F(JF_TING, slot) = rec[R_T_INGRESS];
    F(JF_TAVAIL, slot) = rec[R_T_AVAIL];
    F(JF_TSTART, slot) = t_start0 <= 0.0f ? t : t_start0;
    F(JF_NETLAT, slot) = rec[R_NET_LAT];
    I(JI_PCOUNT, slot) = (int)rec[R_PREEMPT_COUNT];
    F(JF_PT, slot) = 0.0f;
    F(JF_TPT, slot) = rec[R_TOTAL_PREEMPT] +
                      (resuming ? (t - rec[R_PREEMPT_T]) : 0.0f);
    sm.busy[dcj] = wadd(sm.busy[dcj], n_st);
    sm.cur_f[dcj] = new_f;
    sm.dirty[dcj] = 1;
  }

  // _drain_queues(masked=True, xfer=...): at most k_drain starts; iteration
  // 0 is the xfer start when xfer_j >= 0; stops at the first iteration that
  // starts nothing (all lanes)
  __device__ void drain(int dcj, bool enabled, int xfer_j) {
    for (int it = 0; it < k_drain; ++it) {
      if (xfer_j >= 0 && it == 0) {
        __syncwarp();
        if (lane == 0) {
          float rec[N_REC];
          rec_from_slab(xfer_j, rec);
          start_from_rec(xfer_j, dcj, I(JI_JTYPE, xfer_j), rec);
        }
        __syncwarp();
        continue;
      }
      if (!enabled) return;
      __syncwarp();
      const int fe = first_empty();
      if (lane == 0) {
        bool found;
        const int jt = ring_head(dcj, found);
        const int ok = found && fe < J;
        sm.flag = ok;
        if (ok) {
          start_from_rec(fe, dcj, jt, sm.rec);
          sm.qhead[dcj * 2 + jt] = wadd(sm.qhead[dcj * 2 + jt], 1);
        }
      }
      __syncwarp();
      if (!sm.flag) return;
    }
  }

  // ------------------------------------------------ B1a: head + accrual

  __device__ void head(int i) {
    const float t = sm.t;
    float bf = CUDART_INF_F, bx = CUDART_INF_F, ba = CUDART_INF_F;
    int jf = 0x7fffffff, jx = 0x7fffffff, ia = 0x7fffffff, fe = J;
    for (int j = lane; j < J; j += 32) {
      const int st = I(JI_STATUS, j);
      const bool running = st == ST_RUNNING;
      const float runT = running ? F(JF_SPU, j) : CUDART_INF_F;
      const bool fin_ok = isfinite(runT);
      const float rem = clamp_min(F(JF_SIZE, j) - F(JF_UDONE, j), 0.0f);
      const float tf = fin_ok ? t + fmulp(rem, runT) : CUDART_INF_F;
      if (before(tf, j, bf, jf)) {
        bf = tf;
        jf = j;
      }
      const float ta = st == ST_XFER ? F(JF_TAVAIL, j) : CUDART_INF_F;
      if (before(ta, j, bx, jx)) {
        bx = ta;
        jx = j;
      }
      if (st == ST_EMPTY && j < fe) fe = j;
      // the dc_sum input: running jobs' cached watts
      vals[j] = running ? F(JF_WATTS, j) : 0.0f;
    }
    for (int s = lane; s < 2 * n_ing; s += 32) {
      const float v = sm.next_arr[s];
      if (before(v, s, ba, ia)) {
        ba = v;
        ia = s;
      }
    }
    warp_argmin(bf, jf);
    warp_argmin(bx, jx);
    warp_argmin(ba, ia);
    fe = __reduce_min_sync(kAll, fe);
    __syncwarp();
    // active power per DC: the tree is a pure function of the running slots
    // of that DC, so only a DC whose running set changed since its last
    // sum (a finish or a start there) is summed again
    dc_tree_sums(sm.active, true);
    if (lane == 0) {
      for (int d = 0; d < n_dc; ++d) sm.dirty[d] = 0;
      const float cand[4] = {bf, bx, ba, sm.next_log_t};
      int kind = 0;
      float tn = cand[0];
      for (int k = 1; k < 4; ++k) {
        if (before(cand[k], k, tn, kind)) {
          tn = cand[k];
          kind = k;
        }
      }
      const bool past_end = (tn > end) || !isfinite(tn) || sm.done;
      const float t_adv = past_end ? end : tn;
      const float dt = clamp_min(t_adv - t, 0.0f);
      const bool accrue = sm.started && !sm.done;
      for (int d = 0; d < n_dc; ++d) {
        const int idle_n = wsub(sm.total[d], sm.busy[d]);
        const float pw = sm.active[d] + fmulp((float)idle_n, sm.idle_w[d]);
        sm.powers[d] = pw;
        const float e_inc = fmulp(pw, dt);
        const float u_inc = fmulp((float)sm.busy[d], dt);
        sm.energy[d] = sm.energy[d] + (accrue ? e_inc : 0.0f);
        sm.util[d] = sm.util[d] + (accrue ? u_inc : 0.0f);
      }
      sm.t_first = sm.started ? sm.t_first : t_adv;
      sm.t = t_adv;
      sm.dt = dt;
      sm.started = 1;
      sm.done = sm.done || past_end;
      const int branch = sm.done ? EV_NOOP : kind;
      sm.branch = branch;
      // the per-event key split: (key, k_ev) = split(key), or under RL
      // (key, k_ev, k_act) = split(key, 3)
      uint32_t n0, n1, e0, e1;
      tf::child(sm.k0, sm.k1, 0u, n0, n1);
      tf::child(sm.k0, sm.k1, 1u, e0, e1);
      if (rl) tf::child(sm.k0, sm.k1, 2u, sm.ka0, sm.ka1);
      sm.k0 = n0;
      sm.k1 = n1;
      sm.kev0 = e0;
      sm.kev1 = e1;
      em_t[i] = t_adv;
      if (branch != EV_NOOP) em_branch[i] = branch;
      sm.j_fin = jf;
      sm.j_x = jx;
      sm.a_idx = ia;
      sm.has_slot = fe < J;
      sm.slot = fe < J ? fe : 0;
      sm.can = free_for(I(JI_DC, jx), I(JI_JTYPE, jx)) > 0;
    }
    __syncwarp();
    // job progress over the gap (every slot; running ones advance)
    const float dt = sm.dt;
    for (int j = lane; j < J; j += 32) {
      const bool running = I(JI_STATUS, j) == ST_RUNNING;
      const float runT = running ? F(JF_SPU, j) : CUDART_INF_F;
      const bool fin_ok = isfinite(runT);
      const float prog = fin_ok ? dt / (fin_ok ? runT : 1.0f) : 0.0f;
      F(JF_UDONE, j) = minimum(F(JF_SIZE, j), F(JF_UDONE, j) + prog);
    }
    __syncwarp();
  }

  // ------------------------------------------------ B1b: planners + commit

  __device__ void finish(int i) {  // lane 0
    const int j = sm.j_fin;
    const int dcj = I(JI_DC, j), jt = I(JI_JTYPE, j);
    const float t = sm.t;
    const int n = I(JI_N, j);
    const float f_used = sm.freq[I(JI_FIDX, j)];
    const float size_j = F(JF_SIZE, j);
    const float span = tmod(t, li);
    const float acc = span / F(JF_SPU, j);
    const float Tp = F(JF_SPU, j), Pp = F(JF_WATTS, j);
    const float Ep = Tp * Pp;
    const float soj = clamp_min(t - F(JF_TSTART, j), 0.0f);
    float* row = em_job + (long long)i * kJobCols;
    row[0] = (float)I(JI_SEQ, j);
    row[1] = (float)I(JI_INGRESS, j);
    row[2] = (float)jt;
    row[3] = size_j;
    row[4] = (float)dcj;
    row[5] = f_used;
    row[6] = (float)n;
    row[7] = F(JF_NETLAT, j);
    row[8] = F(JF_TSTART, j);
    row[9] = t;
    row[10] = soj;
    row[11] = (float)I(JI_PCOUNT, j);
    row[12] = Tp;
    row[13] = Pp;
    row[14] = Ep;
    // the commit
    I(JI_STATUS, j) = ST_EMPTY;
    F(JF_UDONE, j) = size_j;
    sm.dirty[dcj] = 1;
    sm.busy[dcj] = wsub(sm.busy[dcj], n);
    for (int d = 0; d < n_dc; ++d)
      if (sm.busy[d] < 0) sm.busy[d] = 0;
    sm.acc[dcj] = sm.acc[dcj] + acc;
    lat_buf[jt * W + sm.lat_ptr[jt]] = soj;
    sm.lat_count[jt] = wadd(sm.lat_count[jt], 1);
    sm.lat_ptr[jt] = iremainder(wadd(sm.lat_ptr[jt], 1), W);
    sm.n_fin[jt] = wadd(sm.n_fin[jt], 1);
    sm.units_fin[jt] = sm.units_fin[jt] + size_j;
    if (rl) rl_valid[j] = 0;
  }

  __device__ void arrival() {  // lane 0
    const int s = sm.a_idx;  // stream = ingress * 2 + jtype
    const int ing = s >> 1, jt = s & 1;
    const float t = sm.t;
    int idx = wsub(sm.arr_count[s], sm.c0[s]);
    if (idx > n_tab - 1) idx = n_tab - 1;
    if (idx < 0) idx = 0;
    const float size = sizes[(long long)s * n_tab + idx];
    const float t_next_arr = tnext[(long long)s * n_tab + idx];
    const int dc_sel = tf::randint(sm.kev0, sm.kev1, n_dc);
    const float xfer_s = transfer[(ing * n_dc + dc_sel) * 2 + jt];
    const float nl = netlat[ing * n_dc + dc_sel];
    const float t_avail = t + xfer_s;
    const int jid = sm.jid;
    if (sm.has_slot) {
      const int j = sm.slot;
      I(JI_STATUS, j) = ST_XFER;
      I(JI_JTYPE, j) = jt;
      I(JI_INGRESS, j) = ing;
      I(JI_DC, j) = dc_sel;
      I(JI_SEQ, j) = jid;
      F(JF_SIZE, j) = size;
      F(JF_UDONE, j) = 0.0f;
      I(JI_N, j) = 0;
      I(JI_FIDX, j) = default_f;
      F(JF_TING, j) = t;
      F(JF_TAVAIL, j) = t_avail;
      F(JF_TSTART, j) = 0.0f;
      F(JF_NETLAT, j) = nl;
      I(JI_PCOUNT, j) = 0;
      F(JF_PT, j) = 0.0f;
      F(JF_TPT, j) = 0.0f;
    } else {
      float rec[N_REC];
      for (int k = 0; k < N_REC; ++k) rec[k] = 0.0f;
      rec[R_SIZE] = size;
      rec[R_SEQ] = (float)jid;
      rec[R_INGRESS] = (float)ing;
      rec[R_T_INGRESS] = t;
      rec[R_T_AVAIL] = t_avail;
      rec[R_NET_LAT] = nl;
      ring_push(dc_sel, jt, rec);
    }
    sm.jid = wadd(jid, 1);
    sm.next_arr[s] = t_next_arr;
    sm.arr_count[s] = wadd(sm.arr_count[s], 1);
  }

  // ------------------------------------------------ B1e: the log tick

  __device__ void log_tick(int i) {
    for (int j = lane; j < J; j += 32) {
      const bool running = I(JI_STATUS, j) == ST_RUNNING;
      const float tpt = running ? 1.0f / F(JF_SPU, j) : 0.0f;
      vals[j] = fmulp(tpt, li);
    }
    __syncwarp();
    dc_tree_sums(sm.red, false);
    for (int d = 0; d < n_dc; ++d) {
      int c_tot = 0, c_inf = 0;
      for (int j = lane; j < J; j += 32) {
        if (I(JI_DC, j) == d && I(JI_STATUS, j) == ST_RUNNING) {
          ++c_tot;
          if (I(JI_JTYPE, j) == 0) ++c_inf;
        }
      }
      c_tot = __reduce_add_sync(kAll, c_tot);
      c_inf = __reduce_add_sync(kAll, c_inf);
      if (lane == 0) {
        sm.run_tot[d] = c_tot;
        sm.run_inf[d] = c_inf;
      }
    }
    __syncwarp();
    if (lane == 0) {
      const float t = sm.t;
      const float elapsed = clamp_min(t - sm.t_first, 1e-9f);
      const float inv_1000 = 1.0f / 1000.0f;
      for (int d = 0; d < n_dc; ++d) {
        sm.acc[d] = sm.acc[d] + sm.red[d];
        const int busy = sm.busy[d], total = sm.total[d];
        float* row = em_cluster + ((long long)i * n_dc + d) * kClusterCols;
        row[0] = t;
        row[1] = sm.freq[sm.cur_f[d]];
        row[2] = (float)busy;
        row[3] = (float)wsub(total, busy);
        row[4] = (float)sm.run_tot[d];
        row[5] = (float)sm.run_inf[d];
        row[6] = (float)wsub(sm.run_tot[d], sm.run_inf[d]);
        row[7] = (float)wsub(sm.qtail[2 * d], sm.qhead[2 * d]);
        row[8] = (float)wsub(sm.qtail[2 * d + 1], sm.qhead[2 * d + 1]);
        row[9] = (float)busy * sm.inv_total[d];
        row[10] = sm.util[d] / ((float)total * elapsed);
        row[11] = sm.acc[d];
        row[12] = sm.powers[d];
        row[13] = sm.energy[d] * inv_1000;
      }
      sm.next_log_t = sm.next_log_t + li;
    }
    __syncwarp();
  }

  // ------------------------------------------------ one event

  __device__ void step(int i) {
    head(i);
    const int branch = sm.branch;
    if (branch == EV_NOOP) return;
    if (branch == EV_FINISH) {
      if (lane == 0) finish(i);
      __syncwarp();
      drain(I(JI_DC, sm.j_fin), true, -1);
    } else if (branch == EV_XFER) {
      const int j = sm.j_x;
      const int dcj = I(JI_DC, j), jt = I(JI_JTYPE, j);
      if (!sm.can) {  // queue-on-full: evict the row into the ring
        __syncwarp();
        if (lane == 0) {
          float rec[N_REC];
          rec_from_slab(j, rec);
          I(JI_STATUS, j) = ST_EMPTY;
          ring_push(dcj, jt, rec);
        }
        __syncwarp();
      } else {  // iteration 0 of the shared drain is the xfer start
        drain(dcj, false, j);
      }
    } else if (branch == EV_ARRIVAL) {
      if (lane == 0) arrival();
      __syncwarp();
    } else if (branch == EV_LOG) {
      log_tick(i);
    }
    if (lane == 0) sm.n_events = wadd(sm.n_events, 1);
    __syncwarp();
  }

  // ------------------------------------------------ RL mode (chsac_af)

  // step_time_s(n, f) of (dc, jtype) q, the plain version's expression
  __device__ float step_time(int q, float f, int n) {
    const int nn = n > 1 ? n : 1;
    const float ff = clamp_min(f, 1e-9f);
    const float inv = 1.0f / ff;
    const float base = sm.la[q] + fmulp(sm.lb[q], inv);
    return (nn == 1) ? base : (base + fmulp(sm.lg[q], (float)nn)) / (float)nn;
  }

  // _chsac_nf: n = clamp(a_g + 1, 1, min(free, cap)), f = the first energy
  // argmin at that n (lane 0)
  __device__ void chsac_nf(int dcj, int jt, int free, int a_g, int& n,
                           int& f) {
    const int cap = free < maxgpu ? free : maxgpu;
    const int m = a_g + 1 < cap ? a_g + 1 : cap;
    n = m > 1 ? m : 1;
    const int row = n < n_cap ? n : n_cap;
    const float* e =
        egrid + (((long long)(dcj * 2 + jt) * n_cap) + row - 1) * n_f;
    float bv = e[0];
    int bi = 0;
    for (int k = 1; k < n_f; ++k)
      if (before(e[k], k, bv, bi)) {
        bv = e[k];
        bi = k;
      }
    f = bi;
  }

  // `_commit_tail`'s start: clamp to free, refresh the cached physics,
  // stamp the start / close a preemption wait (lane 0)
  __device__ void start_req(int j, int dcj, int jt, int n_d, int f_d,
                            int new_f, float t_start0, float pt0,
                            float tpt0) {
    const int fr = free_for(dcj, jt);
    const int m = n_d < fr ? n_d : fr;
    const int n_st = m > 1 ? m : 1;
    float spu, watts;
    row_tp(dcj, jt, n_st, f_d, spu, watts);
    const float t = sm.t;
    I(JI_STATUS, j) = ST_RUNNING;
    I(JI_N, j) = n_st;
    I(JI_FIDX, j) = f_d;
    F(JF_TSTART, j) = t_start0 <= 0.0f ? t : t_start0;
    F(JF_PT, j) = 0.0f;
    F(JF_TPT, j) = tpt0 + (pt0 > 0.0f ? (t - pt0) : 0.0f);
    F(JF_SPU, j) = spu;
    F(JF_WATTS, j) = watts;
    sm.busy[dcj] = wadd(sm.busy[dcj], n_st);
    sm.cur_f[dcj] = new_f;
    sm.dirty[dcj] = 1;
  }

  // the finish branch's partial transition (`_plan_finish`'s chsac record),
  // read before the commit retires the row
  __device__ void fin_record(int i) {
    const int j = sm.j_fin;
    for (int k = lane; k < obs_dim; k += 32)
      e_s0[(long long)i * obs_dim + k] = rl_obs0[(long long)j * obs_dim + k];
    for (int d = lane; d < n_dc; d += 32)
      e_mdc0[(long long)i * n_dc + d] = rl_mdc0[(long long)j * n_dc + d];
    for (int g = lane; g < n_g; g += 32)
      e_mg0[(long long)i * n_g + g] = rl_mg0[(long long)j * n_g + g];
    if (lane == 0) {
      const int dcj = I(JI_DC, j), jt = I(JI_JTYPE, j);
      const int q = dcj * 2 + jt;
      const float Ep = F(JF_SPU, j) * F(JF_WATTS, j);
      const float Eu = Ep * inv_kwh;
      const int na = rl_ag[j] + 1;
      const float n_act = (float)(na > 1 ? na : 1);
      const float r = fmulp(Eu, neg_w) + fmulp(1.0f / n_act, 0.05f);
      // min_n_for_sla at the job's frequency
      const float size_j = F(JF_SIZE, j);
      const float f_used = sm.freq[I(JI_FIDX, j)];
      int n_min = maxgpu;
      for (int n = 1; n <= maxgpu; ++n) {
        if ((size_j * step_time(q, f_used, n)) * 1000.0f <= sla_ms) {
          n_min = n;
          break;
        }
      }
      const int over = wsub(I(JI_N, j), n_min);
      e_valid[i] = rl_valid[j];
      e_adc[i] = rl_adc[j];
      e_ag[i] = rl_ag[j];
      e_r[i] = r;
      sm.fin_jt = jt;
      sm.fin_dcj = dcj;
      sm.fin_slot = j;
      sm.fin_soj = clamp_min(sm.t - F(JF_TSTART, j), 0.0f);
      sm.fin_over = (float)(over > 0 ? over : 0);
    }
  }

  // chsac arrival planner: the pregenerated draw, no routing (the tail
  // routes), the XFER placeholder row (DC 0, t_avail inf) or a drop (lane 0)
  __device__ void arrival_rl() {
    const int s = sm.a_idx;
    const int ing = s >> 1, jt = s & 1;
    int idx = wsub(sm.arr_count[s], sm.c0[s]);
    if (idx > n_tab - 1) idx = n_tab - 1;
    if (idx < 0) idx = 0;
    const float size = sizes[(long long)s * n_tab + idx];
    const float t_next_arr = tnext[(long long)s * n_tab + idx];
    if (sm.has_slot) {
      const int j = sm.slot;
      I(JI_STATUS, j) = ST_XFER;
      I(JI_JTYPE, j) = jt;
      I(JI_INGRESS, j) = ing;
      I(JI_DC, j) = 0;
      I(JI_SEQ, j) = sm.jid;
      F(JF_SIZE, j) = size;
      F(JF_UDONE, j) = 0.0f;
      I(JI_N, j) = 0;
      I(JI_FIDX, j) = default_f;
      F(JF_TING, j) = sm.t;
      F(JF_TAVAIL, j) = CUDART_INF_F;
      F(JF_TSTART, j) = 0.0f;
      F(JF_NETLAT, j) = 0.0f;
      I(JI_PCOUNT, j) = 0;
      F(JF_PT, j) = 0.0f;
      F(JF_TPT, j) = 0.0f;
      rl_valid[j] = 0;
      sm.req_kind = REQ_ROUTE;
      sm.req_idx = j;
    } else {
      sm.n_dropped = wadd(sm.n_dropped, 1);
    }
    sm.jid = wadd(sm.jid, 1);
    sm.next_arr[s] = t_next_arr;
    sm.arr_count[s] = wadd(sm.arr_count[s], 1);
  }

  // rl_obs: [t as a fraction of the day] + per DC [log1p(total)/7,
  // busy/total, free/total, f, log1p(q_inf)/4, log1p(q_trn)/4] (all lanes)
  __device__ void build_obs() {
    const float inv7 = 1.0f / 7.0f, inv_day = 1.0f / 86400.0f;
    for (int k = lane; k < obs_dim; k += 32) {
      float v;
      if (k == 0) {
        v = tmod(sm.t, 86400.0f) * inv_day;
      } else {
        const int d = (k - 1) / 6, c = (k - 1) % 6;
        const float total = (float)sm.total[d], busy = (float)sm.busy[d];
        if (c == 0) v = log1pf(total) * inv7;
        else if (c == 1) v = busy / total;
        else if (c == 2) v = clamp_min(total - busy, 0.0f) / total;
        else if (c == 3) v = sm.freq[sm.cur_f[d]];
        else if (c == 4) v = log1pf((float)wsub(sm.qtail[2 * d], sm.qhead[2 * d])) * 0.25f;
        else v = log1pf((float)wsub(sm.qtail[2 * d + 1], sm.qhead[2 * d + 1])) * 0.25f;
      }
      obs[k] = v;
    }
  }

  // the RL trace of slot j <- this step's (obs, action, masks) (all lanes)
  __device__ void write_trace(int j) {
    for (int k = lane; k < obs_dim; k += 32)
      rl_obs0[(long long)j * obs_dim + k] = obs[k];
    for (int d = lane; d < n_dc; d += 32)
      rl_mdc0[(long long)j * n_dc + d] = (uint8_t)sm.mdc[d];
    for (int g = lane; g < n_g; g += 32)
      rl_mg0[(long long)j * n_g + g] = (uint8_t)sm.mg[g];
    if (lane == 0) {
      rl_adc[j] = sm.a_dc;
      rl_ag[j] = sm.a_g;
      rl_valid[j] = 1;
    }
  }

  // the policy tail (`_tail_head` + `_policy_tail_planned` + `_commit_tail`)
  __device__ void tail(int i) {
    // B3: both windows' p99
    for (int w = 0; w < 2; ++w) {
      const float v = rlk::windowed_p99(lat_buf + w * W, sm.lat_count[w], W,
                                        K, lane);
      if (lane == 0) sm.p99[w] = v;
    }
    // the running power of DCs whose running set changed (for P_now)
    for (int j = lane; j < J; j += 32)
      vals[j] = I(JI_STATUS, j) == ST_RUNNING ? F(JF_WATTS, j) : 0.0f;
    __syncwarp();
    dc_tree_sums(sm.active, true);
    build_obs();
    __syncwarp();
    const int req = sm.req_kind, req_idx = sm.req_idx;
    if (lane == 0) {
      for (int d = 0; d < n_dc; ++d) sm.dirty[d] = 0;
      // masks: the inference reserve shrinks every free count when the
      // pending decision concerns a training job
      int extra = 0;
      if (reserve > 0) {
        int jt_req = 0;
        if (req == REQ_ROUTE) {
          jt_req = I(JI_JTYPE, req_idx);
        } else if (req == REQ_DRAIN) {
          bool found;
          jt_req = ring_head(req_idx, found);
        }
        extra = jt_req == 1 ? reserve : 0;
      }
      int max_free = 0;
      for (int d = 0; d < n_dc; ++d) {
        int fr = wsub(wsub(sm.total[d], sm.busy[d]), extra);
        fr = fr > 0 ? fr : 0;
        sm.mdc[d] = fr > 0;
        max_free = d == 0 ? fr : (fr > max_free ? fr : max_free);
      }
      const bool use_trn = sm.lat_count[1] > 0;
      const int cnt = use_trn ? sm.lat_count[1] : sm.lat_count[0];
      const float p99 = use_trn ? sm.p99[1] : sm.p99[0];
      const bool slack = cnt >= 5 && (p99 * 1000.0f < sla_thr);
      const int cap1 = max_free < 1 ? max_free : 1;
      for (int g = 0; g < n_g; ++g)
        sm.mg[g] = slack ? (g + 1 <= cap1) : (g + 1 <= max_free);
      // costs: [p99 ms, P_now, gpu_over, energy]
      const int jf = sm.fin_jt, df = sm.fin_dcj;
      const float p99_ms = sm.lat_count[jf] >= 5 ? sm.p99[jf] * 1000.0f
                                                : sm.fin_soj * 1000.0f;
      const float p_now =
          sm.active[df] +
          fmulp((float)wsub(sm.total[df], sm.busy[df]), sm.idle_w[df]);
      float e_sum = sm.energy[0];
      for (int d = 1; d < n_dc; ++d) e_sum = e_sum + sm.energy[d];
      float* c = e_costs + (long long)i * 4;
      c[0] = p99_ms;
      c[1] = p_now;
      c[2] = sm.fin_over;
      c[3] = e_sum;
    }
    __syncwarp();
    for (int k = lane; k < obs_dim; k += 32)
      e_s1[(long long)i * obs_dim + k] = obs[k];
    for (int d = lane; d < n_dc; d += 32)
      e_mdc[(long long)i * n_dc + d] = (uint8_t)sm.mdc[d];
    for (int g = lane; g < n_g; g += 32)
      e_mg[(long long)i * n_g + g] = (uint8_t)sm.mg[g];
    if (req == REQ_NONE) {
      // the xfer branch's start rides this commit
      if (lane == 0 && sm.st_on)
        start_req(sm.st_j, sm.st_dcj, sm.st_jt, sm.st_n, sm.st_f, sm.st_newf,
                  sm.st_t0, sm.st_pt0, sm.st_tpt0);
      __syncwarp();
      return;
    }
    // B4: one forward and the two samples (only when the action is used)
    rlk::forward(pol, obs, act0, act1, logit, lane);
    if (lane == 0) {
      rlk::masked_log_softmax(logit, sm.mdc, n_dc, logp);
      rlk::masked_log_softmax(logit + 32, sm.mg, n_g, logp + 32);
      uint32_t a0, a1, b0, b1;
      tf::child(sm.ka0, sm.ka1, 0u, a0, a1);
      tf::child(sm.ka0, sm.ka1, 1u, b0, b1);
      sm.a_dc = rlk::sample(a0, a1, logp, n_dc, pol.greedy);
      sm.a_g = rlk::sample(b0, b1, logp + 32, n_g, pol.greedy);
    }
    __syncwarp();
    const int a_dc = sm.a_dc;
    if (req == REQ_ROUTE) {
      const int slot = req_idx;
      if (lane == 0) {
        const int jt_s = I(JI_JTYPE, slot), ing_s = I(JI_INGRESS, slot);
        I(JI_DC, slot) = a_dc;
        F(JF_TAVAIL, slot) = sm.t + transfer[(ing_s * n_dc + a_dc) * 2 + jt_s];
        F(JF_NETLAT, slot) = netlat[ing_s * n_dc + a_dc];
      }
      write_trace(slot);
      __syncwarp();
      return;
    }
    // REQ_DRAIN: the finishing DC's ring head, re-materialized into the
    // slot the finish freed and started where the policy sends it
    if (lane == 0) {
      const int dcj = req_idx;
      bool found;
      const int jt_sel = ring_head(dcj, found);
      const int slot = sm.fin_slot;
      const int free_tgt = free_for(a_dc, jt_sel);
      const bool ok = found && free_tgt > 0;
      sm.flag = ok;
      if (ok) {
        int n, f;
        chsac_nf(a_dc, jt_sel, free_tgt, sm.a_g, n, f);
        const float* rec = sm.rec;
        I(JI_JTYPE, slot) = jt_sel;
        I(JI_INGRESS, slot) = (int)rec[R_INGRESS];
        I(JI_DC, slot) = a_dc;
        I(JI_SEQ, slot) = (int)rec[R_SEQ];
        F(JF_SIZE, slot) = rec[R_SIZE];
        F(JF_UDONE, slot) = rec[R_UNITS_DONE];
        F(JF_TING, slot) = rec[R_T_INGRESS];
        F(JF_TAVAIL, slot) = rec[R_T_AVAIL];
        F(JF_NETLAT, slot) = rec[R_NET_LAT];
        I(JI_PCOUNT, slot) = (int)rec[R_PREEMPT_COUNT];
        start_req(slot, a_dc, jt_sel, n, f, sm.cur_f[a_dc], rec[R_T_START],
                  rec[R_PREEMPT_T], rec[R_TOTAL_PREEMPT]);
        sm.qhead[dcj * 2 + jt_sel] = wadd(sm.qhead[dcj * 2 + jt_sel], 1);
      }
    }
    __syncwarp();
    if (sm.flag) write_trace(sm.fin_slot);
    __syncwarp();
  }

  // one chsac_af event: the branches defer routing and the post-finish
  // drain to the policy tail
  __device__ void step_rl(int i) {
    head(i);
    const int branch = sm.branch;
    if (lane == 0) {
      sm.req_kind = REQ_NONE;
      sm.req_idx = 0;
      sm.fin_jt = 0;
      sm.fin_dcj = 0;
      sm.fin_slot = 0;
      sm.fin_soj = 0.0f;
      sm.fin_over = 0.0f;
      sm.st_on = 0;
    }
    __syncwarp();
    if (branch == EV_FINISH) {
      fin_record(i);
      __syncwarp();
      if (lane == 0) {
        finish(i);
        sm.req_kind = REQ_DRAIN;
        sm.req_idx = sm.fin_dcj;
      }
      __syncwarp();
    } else if (branch == EV_XFER) {
      if (lane == 0) {
        const int j = sm.j_x;
        const int dcj = I(JI_DC, j), jt = I(JI_JTYPE, j);
        if (!sm.can) {  // queue-on-full: evict the row into the ring
          float rec[N_REC];
          rec_from_slab(j, rec);
          I(JI_STATUS, j) = ST_EMPTY;
          ring_push(dcj, jt, rec);
        } else {  // the start rides the tail's commit
          int n, f;
          chsac_nf(dcj, jt, free_for(dcj, jt), rl_ag[j], n, f);
          sm.st_on = 1;
          sm.st_j = j;
          sm.st_dcj = dcj;
          sm.st_jt = jt;
          sm.st_n = n;
          sm.st_f = f;
          sm.st_newf = sm.cur_f[dcj];
          sm.st_t0 = F(JF_TSTART, j);
          sm.st_pt0 = F(JF_PT, j);
          sm.st_tpt0 = F(JF_TPT, j);
        }
      }
      __syncwarp();
    } else if (branch == EV_ARRIVAL) {
      if (lane == 0) arrival_rl();
      __syncwarp();
    } else if (branch == EV_LOG) {
      log_tick(i);
    }
    tail(i);
    if (lane == 0 && branch != EV_NOOP) sm.n_events = wadd(sm.n_events, 1);
    __syncwarp();
  }

  // a step after the end: the same record as the step that reached it
  __device__ void copy_record(int src, int dst) {
    for (int k = lane; k < obs_dim; k += 32)
      e_s1[(long long)dst * obs_dim + k] = e_s1[(long long)src * obs_dim + k];
    for (int d = lane; d < n_dc; d += 32)
      e_mdc[(long long)dst * n_dc + d] = e_mdc[(long long)src * n_dc + d];
    for (int g = lane; g < n_g; g += 32)
      e_mg[(long long)dst * n_g + g] = e_mg[(long long)src * n_g + g];
    if (lane < 4) e_costs[(long long)dst * 4 + lane] = e_costs[(long long)src * 4 + lane];
  }

  int n_ing;
};

}  // namespace

namespace {

// kRL: chsac_af's RL mode.  A separate instantiation, so the heuristic
// kernel carries none of the RL code's registers or stack.
template <bool kRL>
__global__ void __launch_bounds__(32)
    event_scan_kernel(const Args a) {
  extern __shared__ float dyn[];
  __shared__ Small sm;
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int J = a.i[I_J], P = a.i[I_P], n_dc = a.i[I_NDC];
  const int n_ing = a.i[I_NING], S = 2 * n_ing, n_f = a.i[I_NF];
  const int Q = a.i[I_Q], W = a.i[I_W], n_tab = a.i[I_NTAB];
  const int n_steps = a.i[I_NSTEPS], n_cap = a.i[I_NCAP];
  Lane L{sm};
  L.lane = lane;
  L.J = J;
  L.P = P;
  L.n_dc = n_dc;
  L.n_f = n_f;
  L.Q = Q;
  L.W = W;
  L.n_tab = n_tab;
  L.k_drain = a.i[I_KDRAIN];
  L.default_f = a.i[I_DEFAULT_F];
  L.algo_jnf = a.i[I_ALGO_JNF];
  L.perf_first = a.i[I_PERF_FIRST];
  L.inf_priority = a.i[I_INF_PRIORITY];
  L.reserve = a.i[I_RESERVE];
  L.maxgpu = a.i[I_MAXGPU];
  L.f_hi = a.i[I_FHI];
  L.f_lo = a.i[I_FLO];
  L.scale_out_low = a.i[I_SCALE_OUT_LOW];
  L.end = a.f[F_END];
  L.li = a.f[F_LOG_INTERVAL];
  L.n_ing = n_ing;
  L.si = reinterpret_cast<int*>(dyn);
  L.sf = dyn + N_JI * J;
  L.vals = dyn + (N_JI + N_JF) * J;
  L.scr = L.vals + P;
  L.recs = lane_ptr<float>(a, P_Q_RECS, (long long)n_dc * 2 * Q * N_REC, r);
  L.lat_buf = lane_ptr<float>(a, P_LAT_BUF, 2LL * W, r);
  L.em_t = lane_ptr<float>(a, P_EM_T, n_steps, r);
  L.em_branch = lane_ptr<int>(a, P_EM_BRANCH, n_steps, r);
  L.em_cluster = lane_ptr<float>(a, P_EM_CLUSTER,
                                 (long long)n_steps * n_dc * kClusterCols, r);
  L.em_job = lane_ptr<float>(a, P_EM_JOB, (long long)n_steps * kJobCols, r);
  L.sizes = lane_ptr<const float>(a, P_SIZES, (long long)S * n_tab, r);
  L.tnext = lane_ptr<const float>(a, P_TNEXT, (long long)S * n_tab, r);
  L.transfer = reinterpret_cast<const float*>(a.p[P_TRANSFER]);
  L.netlat = reinterpret_cast<const float*>(a.p[P_NETLAT]);
  L.egrid = reinterpret_cast<const float*>(a.p[P_EGRID]);
  L.n_cap = n_cap;
  const int rl = kRL;
  L.rl = rl;
  float* lat_global = L.lat_buf;
  if constexpr (kRL) {
    const int obs_dim = a.i[I_OBS_DIM], n_g = a.i[I_MAXGPU];
    L.obs_dim = obs_dim;
    L.K = a.i[I_PERC_K];
    L.n_g = n_g;
    L.sla_thr = a.f[F_SLA_THR];
    L.neg_w = a.f[F_NEG_W];
    L.sla_ms = a.f[F_SLA_MS];
    L.inv_kwh = 1.0f / 3.6e6f;
    // RL scratch after the slab rows: the latency windows, then the
    // observation, two activation rows, the logits and log-probabilities
    L.lat_buf = L.scr + P;
    L.obs = L.lat_buf + 2 * W;
    L.act0 = L.obs + kMaxObs;
    L.act1 = L.act0 + kMaxWidth;
    L.logit = L.act1 + kMaxWidth;
    L.logp = L.logit + 64;
    const int widths[kNLayers + 1] = {obs_dim,      a.i[I_WH0], a.i[I_WH1],
                                      a.i[I_WLAT], a.i[I_WAH], n_dc, n_g};
    for (int k = 0; k < kNLayers; ++k) {
      L.pol.w[k] = reinterpret_cast<const uint16_t*>(a.p[P_W0 + 2 * k]);
      L.pol.b[k] = reinterpret_cast<const uint16_t*>(a.p[P_W0 + 2 * k + 1]);
    }
    for (int k = 0; k < 4; ++k) {
      L.pol.in[k] = widths[k];
      L.pol.out[k] = widths[k + 1];
    }
    L.pol.in[4] = L.pol.in[5] = widths[4];
    L.pol.out[4] = n_dc;
    L.pol.out[5] = n_g;
    L.pol.greedy = a.i[I_GREEDY];
    L.rl_obs0 = lane_ptr<float>(a, P_RL_OBS0, (long long)J * obs_dim, r);
    L.rl_adc = lane_ptr<int>(a, P_RL_ADC, J, r);
    L.rl_ag = lane_ptr<int>(a, P_RL_AG, J, r);
    L.rl_mdc0 = lane_ptr<uint8_t>(a, P_RL_MDC0, (long long)J * n_dc, r);
    L.rl_mg0 = lane_ptr<uint8_t>(a, P_RL_MG0, (long long)J * n_g, r);
    L.rl_valid = lane_ptr<uint8_t>(a, P_RL_VALID, J, r);
    L.e_valid = lane_ptr<uint8_t>(a, P_E_VALID, n_steps, r);
    L.e_s0 = lane_ptr<float>(a, P_E_S0, (long long)n_steps * obs_dim, r);
    L.e_s1 = lane_ptr<float>(a, P_E_S1, (long long)n_steps * obs_dim, r);
    L.e_adc = lane_ptr<int>(a, P_E_ADC, n_steps, r);
    L.e_ag = lane_ptr<int>(a, P_E_AG, n_steps, r);
    L.e_mdc0 = lane_ptr<uint8_t>(a, P_E_MDC0, (long long)n_steps * n_dc, r);
    L.e_mg0 = lane_ptr<uint8_t>(a, P_E_MG0, (long long)n_steps * n_g, r);
    L.e_r = lane_ptr<float>(a, P_E_R, n_steps, r);
    L.e_costs = lane_ptr<float>(a, P_E_COSTS, (long long)n_steps * 4, r);
    L.e_mdc = lane_ptr<uint8_t>(a, P_E_MDC, (long long)n_steps * n_dc, r);
    L.e_mg = lane_ptr<uint8_t>(a, P_E_MG, (long long)n_steps * n_g, r);
    for (int k = lane; k < 2 * W; k += 32) L.lat_buf[k] = lat_global[k];
  }

  // ---- load: the slab into shared memory, lane state into `sm`
  for (int f = 0; f < 18; ++f) {
    const int* src = lane_ptr<const int>(a, P_JOBS + f, J, r);
    int* dst = kJobIsF[f] ? reinterpret_cast<int*>(L.sf) + kJobCol[f] * J
                          : L.si + kJobCol[f] * J;
    for (int j = lane; j < J; j += 32) dst[j] = src[j];
  }
  for (int d = lane; d < n_dc; d += 32) {
    sm.dirty[d] = 1;
    sm.busy[d] = lane_ptr<int>(a, P_BUSY, n_dc, r)[d];
    sm.cur_f[d] = lane_ptr<int>(a, P_CUR_F, n_dc, r)[d];
    sm.energy[d] = lane_ptr<float>(a, P_ENERGY, n_dc, r)[d];
    sm.util[d] = lane_ptr<float>(a, P_UTIL, n_dc, r)[d];
    sm.acc[d] = lane_ptr<float>(a, P_ACC, n_dc, r)[d];
    const int tot = reinterpret_cast<const int*>(a.p[P_TOTAL])[d];
    sm.total[d] = tot;
    sm.idle_w[d] = reinterpret_cast<const float*>(a.p[P_IDLE_W])[d];
    sm.inv_total[d] = 1.0f / (float)(tot > 1 ? tot : 1);
  }
  for (int q = lane; q < 2 * n_dc; q += 32) {
    sm.qhead[q] = lane_ptr<int>(a, P_Q_HEAD, 2 * n_dc, r)[q];
    sm.qtail[q] = lane_ptr<int>(a, P_Q_TAIL, 2 * n_dc, r)[q];
    sm.pa[q] = reinterpret_cast<const float*>(a.p[P_PA])[q];
    sm.pb[q] = reinterpret_cast<const float*>(a.p[P_PB])[q];
    sm.pg[q] = reinterpret_cast<const float*>(a.p[P_PG])[q];
    sm.la[q] = reinterpret_cast<const float*>(a.p[P_LA])[q];
    sm.lb[q] = reinterpret_cast<const float*>(a.p[P_LB])[q];
    sm.lg[q] = reinterpret_cast<const float*>(a.p[P_LG])[q];
    // admit_joint_nf: first minimum of E_grid_cap[dc, jt] ([n_cap, n_f],
    // n-major)
    const float* eg =
        reinterpret_cast<const float*>(a.p[P_EGRID]) + (long long)q * n_cap * n_f;
    float bv = eg[0];
    int bi = 0;
    for (int k = 1; k < n_cap * n_f; ++k)
      if (before(eg[k], k, bv, bi)) {
        bv = eg[k];
        bi = k;
      }
    sm.jnf_n[q] = bi / n_f + 1;
    sm.jnf_f[q] = bi % n_f;
  }
  for (int k = lane; k < n_f; k += 32)
    sm.freq[k] = reinterpret_cast<const float*>(a.p[P_FREQ])[k];
  for (int s = lane; s < S; s += 32) {
    sm.next_arr[s] = lane_ptr<float>(a, P_NEXT_ARR, S, r)[s];
    sm.arr_count[s] = lane_ptr<int>(a, P_ARR_COUNT, S, r)[s];
    sm.c0[s] = lane_ptr<int>(a, P_C0, S, r)[s];
  }
  if (lane == 0) {
    sm.t = lane_ptr<float>(a, P_T, 1, r)[0];
    const int64_t* key = lane_ptr<int64_t>(a, P_KEY, 2, r);
    sm.k0 = (uint32_t)key[0];
    sm.k1 = (uint32_t)key[1];
    sm.jid = lane_ptr<int>(a, P_JID, 1, r)[0];
    sm.started = lane_ptr<uint8_t>(a, P_STARTED, 1, r)[0] != 0;
    sm.t_first = lane_ptr<float>(a, P_T_FIRST, 1, r)[0];
    sm.next_log_t = lane_ptr<float>(a, P_NEXT_LOG, 1, r)[0];
    sm.n_events = lane_ptr<int>(a, P_N_EVENTS, 1, r)[0];
    sm.n_dropped = lane_ptr<int>(a, P_N_DROP, 1, r)[0];
    sm.done = lane_ptr<uint8_t>(a, P_DONE, 1, r)[0] != 0;
    for (int k = 0; k < 2; ++k) {
      sm.n_fin[k] = lane_ptr<int>(a, P_N_FIN, 2, r)[k];
      sm.units_fin[k] = lane_ptr<float>(a, P_UNITS_FIN, 2, r)[k];
      sm.lat_count[k] = lane_ptr<int>(a, P_LAT_COUNT, 2, r)[k];
      sm.lat_ptr[k] = lane_ptr<int>(a, P_LAT_PTR, 2, r)[k];
    }
  }
  __syncwarp();

  // ---- the chunk
  int rec_row = -1;  // RL: the step whose record every later step repeats
  for (int i = 0; i < n_steps; ++i) {
    if (sm.done) {  // after the end each step only advances the key
      __syncwarp();
      if (lane == 0) {
        uint32_t n0, n1;
        tf::child(sm.k0, sm.k1, 0u, n0, n1);
        sm.k0 = n0;
        sm.k1 = n1;
        L.em_t[i] = sm.t;
      }
      __syncwarp();
      if constexpr (kRL) {  // and, under RL, emits the final state's record
        if (rec_row < 0) {
          if (lane == 0) {
            sm.req_kind = REQ_NONE;
            sm.fin_jt = sm.fin_dcj = sm.fin_slot = 0;
            sm.fin_soj = sm.fin_over = 0.0f;
            sm.st_on = 0;
          }
          __syncwarp();
          L.tail(i);
          rec_row = i;
        } else {
          L.copy_record(rec_row, i);
        }
        __syncwarp();
      }
      continue;
    }
    __syncwarp();
    if constexpr (kRL) {
      L.step_rl(i);
      if (sm.done) rec_row = i;
    } else {
      L.step(i);
    }
    __syncwarp();
  }

  // ---- write back
  for (int f = 0; f < 18; ++f) {
    int* dst = lane_ptr<int>(a, P_JOBS + f, J, r);
    const int* src = kJobIsF[f]
                         ? reinterpret_cast<const int*>(L.sf) + kJobCol[f] * J
                         : L.si + kJobCol[f] * J;
    for (int j = lane; j < J; j += 32) dst[j] = src[j];
  }
  for (int d = lane; d < n_dc; d += 32) {
    lane_ptr<int>(a, P_BUSY, n_dc, r)[d] = sm.busy[d];
    lane_ptr<int>(a, P_CUR_F, n_dc, r)[d] = sm.cur_f[d];
    lane_ptr<float>(a, P_ENERGY, n_dc, r)[d] = sm.energy[d];
    lane_ptr<float>(a, P_UTIL, n_dc, r)[d] = sm.util[d];
    lane_ptr<float>(a, P_ACC, n_dc, r)[d] = sm.acc[d];
  }
  for (int q = lane; q < 2 * n_dc; q += 32) {
    lane_ptr<int>(a, P_Q_HEAD, 2 * n_dc, r)[q] = sm.qhead[q];
    lane_ptr<int>(a, P_Q_TAIL, 2 * n_dc, r)[q] = sm.qtail[q];
  }
  for (int s = lane; s < S; s += 32) {
    lane_ptr<float>(a, P_NEXT_ARR, S, r)[s] = sm.next_arr[s];
    lane_ptr<int>(a, P_ARR_COUNT, S, r)[s] = sm.arr_count[s];
  }
  if constexpr (kRL)
    for (int k = lane; k < 2 * W; k += 32) lat_global[k] = L.lat_buf[k];
  if (lane == 0) {
    lane_ptr<float>(a, P_T, 1, r)[0] = sm.t;
    int64_t* key = lane_ptr<int64_t>(a, P_KEY, 2, r);
    key[0] = (int64_t)sm.k0;
    key[1] = (int64_t)sm.k1;
    lane_ptr<int>(a, P_JID, 1, r)[0] = sm.jid;
    lane_ptr<uint8_t>(a, P_STARTED, 1, r)[0] = sm.started ? 1 : 0;
    lane_ptr<float>(a, P_T_FIRST, 1, r)[0] = sm.t_first;
    lane_ptr<float>(a, P_NEXT_LOG, 1, r)[0] = sm.next_log_t;
    lane_ptr<int>(a, P_N_EVENTS, 1, r)[0] = sm.n_events;
    lane_ptr<int>(a, P_N_DROP, 1, r)[0] = sm.n_dropped;
    lane_ptr<uint8_t>(a, P_DONE, 1, r)[0] = sm.done ? 1 : 0;
    for (int k = 0; k < 2; ++k) {
      lane_ptr<int>(a, P_N_FIN, 2, r)[k] = sm.n_fin[k];
      lane_ptr<float>(a, P_UNITS_FIN, 2, r)[k] = sm.units_fin[k];
      lane_ptr<int>(a, P_LAT_COUNT, 2, r)[k] = sm.lat_count[k];
      lane_ptr<int>(a, P_LAT_PTR, 2, r)[k] = sm.lat_ptr[k];
    }
  }
}

}  // namespace

namespace {

// The RL shapes the device code takes: an observation of 5..kMaxObs, layer
// widths up to kMaxWidth, at most 32 actions per head, K >= 1, weights.
bool policy_ok(const Args& a) {
  const int obs_dim = a.i[I_OBS_DIM];
  if (obs_dim < 5 || obs_dim > kMaxObs || a.i[I_PERC_K] < 1) return false;
  if (a.i[I_NDC] > 32 || a.i[I_MAXGPU] < 1 || a.i[I_MAXGPU] > 32) return false;
  const int w[4] = {a.i[I_WH0], a.i[I_WH1], a.i[I_WLAT], a.i[I_WAH]};
  for (int k = 0; k < 4; ++k)
    if (w[k] < 5 || w[k] > kMaxWidth) return false;
  for (int k = 0; k < 2 * kNLayers; ++k)
    if (a.p[P_W0 + k] == nullptr) return false;
  return true;
}

// ---------------------------------------------------------------- standalone
// B3 and B4 over a batch through the same device functions (chip_smoke.py
// holds them against their plain versions; the main path never calls it).
// Block b (one warp): the p99 of ring b (b < B) and the policy on row b
// (b < M): log-probabilities and the actions sampled with row b's key.

enum TailPtr {
  T_LAT, T_LAT_COUNT, T_OBS, T_MDC, T_MG, T_KEYS, T_P99, T_LOGP_DC, T_LOGP_G,
  T_ADC, T_AG, T_W0, N_TAIL_PTRS = T_W0 + 2 * kNLayers
};

struct TailArgs {
  void* p[N_TAIL_PTRS];
  int i[N_INTS];
  int B, W, M;
};

__global__ void __launch_bounds__(32) rl_tail_batch_kernel(const TailArgs a) {
  __shared__ float obs[kMaxObs], act0[kMaxWidth], act1[kMaxWidth];
  __shared__ float logit[64], logp[64];
  __shared__ int mdc[32], mg[32];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int W = a.W, K = a.i[I_PERC_K];
  if (b < a.B) {
    const float* buf = reinterpret_cast<const float*>(a.p[T_LAT]) + (long long)b * W;
    const int count = reinterpret_cast<const int*>(a.p[T_LAT_COUNT])[b];
    const float v = rlk::windowed_p99(buf, count, W, K, lane);
    if (lane == 0) reinterpret_cast<float*>(a.p[T_P99])[b] = v;
  }
  if (b >= a.M) return;
  const int obs_dim = a.i[I_OBS_DIM], n_dc = a.i[I_NDC], n_g = a.i[I_MAXGPU];
  rlk::Policy P;
  const int widths[kNLayers + 1] = {obs_dim,      a.i[I_WH0], a.i[I_WH1],
                                    a.i[I_WLAT], a.i[I_WAH], n_dc, n_g};
  for (int k = 0; k < kNLayers; ++k) {
    P.w[k] = reinterpret_cast<const uint16_t*>(a.p[T_W0 + 2 * k]);
    P.b[k] = reinterpret_cast<const uint16_t*>(a.p[T_W0 + 2 * k + 1]);
  }
  for (int k = 0; k < 4; ++k) {
    P.in[k] = widths[k];
    P.out[k] = widths[k + 1];
  }
  P.in[4] = P.in[5] = widths[4];
  P.out[4] = n_dc;
  P.out[5] = n_g;
  P.greedy = a.i[I_GREEDY];
  const float* o = reinterpret_cast<const float*>(a.p[T_OBS]) + (long long)b * obs_dim;
  for (int k = lane; k < obs_dim; k += 32) obs[k] = o[k];
  const uint8_t* md = reinterpret_cast<const uint8_t*>(a.p[T_MDC]) + (long long)b * n_dc;
  const uint8_t* mgp = reinterpret_cast<const uint8_t*>(a.p[T_MG]) + (long long)b * n_g;
  if (lane < n_dc) mdc[lane] = md[lane] != 0;
  if (lane < n_g) mg[lane] = mgp[lane] != 0;
  __syncwarp();
  rlk::forward(P, obs, act0, act1, logit, lane);
  if (lane == 0) {
    rlk::masked_log_softmax(logit, mdc, n_dc, logp);
    rlk::masked_log_softmax(logit + 32, mg, n_g, logp + 32);
    const int64_t* key = reinterpret_cast<const int64_t*>(a.p[T_KEYS]) + 2LL * b;
    uint32_t a0, a1, b0, b1;
    tf::child((uint32_t)key[0], (uint32_t)key[1], 0u, a0, a1);
    tf::child((uint32_t)key[0], (uint32_t)key[1], 1u, b0, b1);
    reinterpret_cast<int*>(a.p[T_ADC])[b] = rlk::sample(a0, a1, logp, n_dc, P.greedy);
    reinterpret_cast<int*>(a.p[T_AG])[b] = rlk::sample(b0, b1, logp + 32, n_g, P.greedy);
  }
  __syncwarp();
  float* ld = reinterpret_cast<float*>(a.p[T_LOGP_DC]) + (long long)b * n_dc;
  float* lg = reinterpret_cast<float*>(a.p[T_LOGP_G]) + (long long)b * n_g;
  if (lane < n_dc) ld[lane] = logp[lane];
  if (lane < n_g) lg[lane] = logp[32 + lane];
}

}  // namespace

// Plain C entry point of the standalone launch: `ptrs` N_TAIL_PTRS device
// pointers (TailPtr order), `ints` the event scan's N_INTS followed by B, W
// and M.  Returns the cudaError_t of the launch, -1 for tables of the wrong
// length, -2 for shapes the device code does not take.
extern "C" int rl_tail_batch_launch(const uint64_t* ptrs, int n_ptrs,
                                    const int* ints, int n_ints,
                                    const float* floats, int n_floats,
                                    void* stream) {
  (void)floats;
  if (n_ptrs != N_TAIL_PTRS || n_ints != N_INTS + 3 || n_floats != N_FLTS)
    return -1;
  TailArgs a;
  Args chk;
  for (int k = 0; k < N_TAIL_PTRS; ++k) a.p[k] = (void*)ptrs[k];
  for (int k = 0; k < N_INTS; ++k) chk.i[k] = a.i[k] = ints[k];
  for (int k = 0; k < N_PTRS; ++k) chk.p[k] = nullptr;
  for (int k = 0; k < 2 * kNLayers; ++k) chk.p[P_W0 + k] = a.p[T_W0 + k];
  a.B = ints[N_INTS];
  a.W = ints[N_INTS + 1];
  a.M = ints[N_INTS + 2];
  if (a.B < 0 || a.M < 0 || a.W < 1 || !policy_ok(chk)) return -2;
  const int grid = a.B > a.M ? a.B : a.M;
  if (grid == 0) return (int)cudaSuccess;
  rl_tail_batch_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a launch needs: the slab plus two [P] scratch
// rows, and in RL mode the latency windows and the policy's scratch.
extern "C" long long event_scan_smem_bytes(int J, int P, int W, int rl) {
  const long long rl_part =
      rl ? 2LL * W + kMaxObs + 2LL * kMaxWidth + 128 : 0;
  return 4LL * ((N_JI + N_JF) * (long long)J + 2LL * P + rl_part);
}

// Plain C entry point (bound with ctypes).  `ptrs` holds N_PTRS device
// pointers in PTR_NAMES order, `ints` N_INTS and `floats` N_FLTS values (the
// counts are checked against this build's).  Launches R blocks of one warp
// on `stream`.  Returns the cudaError_t of the launch (0 on success), -1 for
// a table of the wrong length, -2 for a shape the kernel does not take (too
// many DCs, streams or frequency levels), -3 when the slab does not fit in
// shared memory.
extern "C" int event_scan_launch(const uint64_t* ptrs, int n_ptrs,
                                 const int* ints, int n_ints,
                                 const float* floats, int n_floats,
                                 void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_floats != N_FLTS) return -1;
  Args a;
  for (int k = 0; k < N_PTRS; ++k) a.p[k] = (void*)ptrs[k];
  for (int k = 0; k < N_INTS; ++k) a.i[k] = ints[k];
  for (int k = 0; k < N_FLTS; ++k) a.f[k] = floats[k];
  const int R = a.i[I_R];
  if (R <= 0 || a.i[I_NSTEPS] <= 0) return (int)cudaSuccess;
  if (a.i[I_NDC] < 1 || a.i[I_NDC] > kMaxDC || 2 * a.i[I_NING] > kMaxS ||
      a.i[I_NF] < 1 || a.i[I_NF] > kMaxF || a.i[I_J] < 1 || a.i[I_Q] < 1 ||
      a.i[I_W] < 1 || a.i[I_NTAB] < 1)
    return -2;
  if (a.i[I_RL] && !policy_ok(a)) return -2;
  const long long smem =
      event_scan_smem_bytes(a.i[I_J], a.i[I_P], a.i[I_W], a.i[I_RL]);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + (long long)sizeof(Small) > optin) return -3;
  auto kernel = a.i[I_RL] ? event_scan_kernel<true> : event_scan_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, 32, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
