// B1, the event scan, on Hopper (sm_90a): the port of the XLA-fused scan
// `Engine._run_chunk` -> `lax.scan(Engine._step)` (distributed_cluster_gpus_
// tpu/sim/engine.py:4581 and :2966), the K=1 write-plan program with ring
// queues for the heuristic algorithms (default_policy, joint_nf).  The JAX
// package has no Pallas kernel; this replaces the fused jnp step.
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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDC = 32;
constexpr int kMaxS = 64;
constexpr int kMaxF = 32;

constexpr int EV_FINISH = 0, EV_XFER = 1, EV_ARRIVAL = 2, EV_LOG = 3,
              EV_NOOP = 4;
constexpr int ST_EMPTY = 0, ST_XFER = 1, ST_RUNNING = 3;

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
  N_PTRS
};

// Integer parameters, in kernels/event_scan.py's INT_NAMES order.
enum Int {
  I_R, I_NSTEPS, I_NDC, I_NING, I_NF, I_NCAP, I_J, I_P, I_Q, I_W, I_NTAB,
  I_KDRAIN, I_DEFAULT_F, I_ALGO_JNF, I_PERF_FIRST, I_INF_PRIORITY,
  I_RESERVE, I_MAXGPU, I_FHI, I_FLO, I_SCALE_OUT_LOW,
  N_INTS
};

enum Flt { F_END, F_LOG_INTERVAL, N_FLTS };

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
      // the per-event key split: (key, k_ev) = split(key)
      uint32_t n0, n1, e0, e1;
      tf::child(sm.k0, sm.k1, 0u, n0, n1);
      tf::child(sm.k0, sm.k1, 1u, e0, e1);
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

  int n_ing;
};

}  // namespace

namespace {

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
      continue;
    }
    __syncwarp();
    L.step(i);
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

// The dynamic shared memory a launch needs: the slab plus two [P] scratch
// rows.
extern "C" long long event_scan_smem_bytes(int J, int P) {
  return 4LL * ((N_JI + N_JF) * (long long)J + 2LL * P);
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
  const long long smem = event_scan_smem_bytes(a.i[I_J], a.i[I_P]);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + (long long)sizeof(Small) > optin) return -3;
  err = cudaFuncSetAttribute(event_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  event_scan_kernel<<<R, 32, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
