// B1, the event scan, on Hopper (sm_90a): the port of the XLA-fused scan
// `Engine._run_chunk` -> `lax.scan(Engine._step)` (distributed_cluster_gpus_
// tpu/sim/engine.py:4581 and :2966), the K=1 write-plan program with ring
// queues for the heuristic algorithms and, in RL mode, for chsac_af's acting
// path.  The JAX package has no Pallas kernel; this replaces the fused jnp
// step.
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
// The extended heuristic instance (`kExt`; default_policy and joint_nf keep
// an instance without its code: unexecuted code costs an event 5-6%):
//   admission: carbon_cost's first-minimum cell of E * (price(hour) * 1/3.6e6)
//       or, at price 0, of E * carbon (a table of (dc, jtype) cells rebuilt
//       when a decision's hour differs from the table's), debug's fixed GPU
//       count at its fixed or least-energy frequency (a table built at
//       launch), the bandit's UCB1 select (the arms in global memory, read
//       and written by thread 0; the select count committed with the start,
//       the reward at the finish before the drain; `ln t` XLA's CPU float32
//       polynomial, `xla_log`, so the arm is the JAX package's bit for bit);
//   routing: eco_route's least job score over the DCs from each DC's
//       best-cell energy (a table per hour key) and the weighted score's five
//       terms summed left to right, per arrival on thread 0;
//   the log tick's control (`control`): idle DCs to ladder index 0, or the
//       cap controllers over the block: cap_uniform's clamped powers as two
//       passes of DC tree sums per iteration and its apply pass; cap_greedy's
//       per-job least rho over the job's ladder steps, the block argmin of
//       (rho key, atom) and the applied job's DC tree summed again; each
//       touched DC marked dirty and the log row's power summed after the
//       control.  The controller's ticks, iterations and clock cycles are
//       counted per lane (P_CTL).  Every eco score is written in XLA's
//       association (`E / 3.6e6 * price` as `E * (price * kKwh)`).
//
// RL mode (chsac_af, `Lane::step_rl`): the event branches defer routing and
// the post-finish drain to the policy tail, which runs on every event:
//   B3 (sim/algos.py:210 `windowed_percentile`, `rlk::windowed_p99`): the
//       exact linear-interpolation p99 of both latency windows, recomputed
//       only for a window a finish appended to since its last p99 (it is a
//       pure function of the window and its count).  The window lives in
//       shared memory.  The maxima of the 32 classes j mod 32 (each class
//       read by one lane of every warp) sorted in a warp give a threshold no
//       larger than the K-th largest value (K = `ceil(0.01 W) + 2`, 23 at
//       W = 2048); the values at or above it are compacted into a short
//       shared list, and each listed value's rank (how many are larger, how
//       many no smaller) picks out the two order statistics the
//       interpolation reads.  A list longer than kCand falls back to rounds
//       of warp max + tie count over the window.  Bound: the window's bytes.
//   B4 (sim/engine.py:3454 `_tail_head`, :3584 `_policy_tail_planned`,
//       :1840 `_commit_tail`, with rl/nets.py and rl/sac.py:150): the
//       observation, the masks, ONE encoder/actor forward when a route or a
//       drain decision is pending, the Gumbel-max samples, the step's RL
//       record and the tail commit.  The forward runs on a thread-block
//       cluster of cs blocks per lane (4 for the published 256-wide
//       policy): each block keeps ceil(out / cs) rows of every layer's
//       bf16 weights in its shared memory for the whole launch (read once
//       from L2: streaming the 429 KB through one SM per decision is bound
//       at ~10 B per cycle), computes those rows' outputs and writes them
//       into every block's next activation row over distributed shared
//       memory; a cluster barrier ends each layer.  Block 0 runs the lane;
//       the others wait for its forwards (`serve_forwards`).  Where block
//       0's slab leaves no room for a slice (job_cap over 1,024 at the
//       published widths), the wrapper clears I_LEAD and blocks 1..cs-1
//       hold ceil(out / (cs - 1)) rows each.  An output's K = KP products
//       are summed by the reference recipe's halving tree, which over the
//       inputs in bit-reversed order (the wrapper stores
//       each weight row and the kernel each activation in that order,
//       padded with zeros to a power of two) is the pairwise tree of
//       contiguous ranges: KP / 16 threads each take 16 contiguous products
//       and sum them by the tree, and shuffles add the partial sums
//       pairwise up the same tree.  bf16 operands, exact float32 products,
//       one bf16 rounding before and one after the bias, as rl/nets.py's
//       `bf16_dense`.  The heads take what the learning update takes (n_dc
//       <= 32, n_dc + n_g <= 256): the DC head's log-softmax and
//       Gumbel-max sample run on one warp, one action per lane; the
//       GPU-count head's actions sit in register slots (action a at lane
//       a % 32 of slot a / 32), each warp computes the log-softmax (the
//       tree's levels of distance >= 32 in registers, the last five by
//       shuffles) and draws the Gumbels of its own slots, and the first
//       maximum is taken across the warps (a head of up to 32 actions on
//       one warp, as the DC head's).  Bound: the 0.43 MB of bf16 weights
//       per decision against 3.35 TB/s (0.49 MB at 8 x 128 actions).
//
// Bound on the card: an event is a chain of dependent steps (three argmins,
// n_dc tree sums, the branch, a drain loop), each a few hundred cycles of
// latency, so one lane is latency-bound on one SM; the bytes (the slab in and
// out once per chunk, ~100 B of emissions per event) and the operations
// (~20 per slot per event) bound it far below that.  Design: one block of NT
// threads (a multiple of 32, chosen by the wrapper) per lane (grid = R
// lanes); the job slab (18 four-byte fields x J) lives in shared memory for
// the whole launch, the rings [n_dc, 2, Q, 11] in global memory.  The scalar
// program of an event runs on thread 0 between block barriers (`bar`, a warp
// barrier when the block is one warp); the passes over the slab run on all
// NT threads (thread t owns the slots j = t + NT k): the argmins as 32-bit
// keys in `before`'s total order (`order_key`), reduced by two warp REDUX
// and one shared 64-bit atomic min per warp (any order of reduction picks
// the same slot); the DCs' power trees a warp each, in registers
// (`dc_tree_sums`); the progress pass; the log tick's counts.  In RL mode
// the lane is a cluster of blocks (B4 above).  The key split runs on three
// threads of the last warp, the
// per-DC accrual and cluster rows on a thread each.  Emissions go straight
// to the preallocated [R, n_steps, ...] buffers; the rest of the state is
// written back once, at chunk end.  No host read happens inside the chunk.
//
// The clock (SimParams.time_dtype): every instance above is built for a
// float clock here and for a double one in csrc/event_scan64.cu, which
// compiles this source with DCG_CLOCK64 defined (its entry points carry
// "64" in their names).  The double instances (the float64 clock, jax's
// x64 mode in the JAX package) hold in double the lane's clock, first
// event time and log clock, the DCs' energy and GPU-time accumulators, the
// arrival clocks, the slab's four time columns (JF_TING, JF_TAVAIL,
// JF_TSTART, JF_PT: a [4, J] double array after the float slab, whose four
// float columns of those fields go unused) and every field of a ring
// record (88 bytes); the rest stays float32 and int32.  The head's argmins
// of double keys do not fit the float instances' one 64-bit (key << 32 |
// slot) word: each warp posts its least (64-bit key, slot, value) to
// shared memory and every thread takes the least (key, slot) over the
// warps after the barrier (ties to the lower slot, as before).  The float
// instances compile as they did.
//
// Rounding: built with -fmad=false and IEEE division (-prec-div=true, the
// default), never fast math.  Each float expression is the plain engine's,
// op for op: `fmul_pinned` is a*b + a*0 (one rounding, the reference's
// signed-zero fence), reciprocals are multiplied where the plain engine
// multiplies by one, true division stays true division, `(f*f)*f` keeps its
// order, and the dc_sum is the reference's fixed halving tree (element i +
// element i + p/2 at each level, zero-padded to a power of two p).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

#ifdef DCG_CLOCK64
#define DCG_ENTRY(name) name##64
#else
#define DCG_ENTRY(name) name
#endif

namespace {

// this build's clock (see the head note)
#ifdef DCG_CLOCK64
using Clock = double;
#else
using Clock = float;
#endif

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDC = 32;
// both policy heads together (n_dc + n_g), as the learning update takes
// them (kernels/envelope.py); the GPU-count head's actions sit in kSlots
// register slots of a warp (kMaxHeads - 1 at most: n_dc >= 1)
constexpr int kMaxHeads = 256;
constexpr int kSlots = kMaxHeads / 32;
// a cluster's logit row: the DC head at 0, the GPU-count head at 32; as
// long as n_g needs (a multiple of 4: what follows stays 16-byte aligned)
constexpr int kLogitLen = 32 + kMaxHeads;
__host__ __device__ __forceinline__ int logit_len(int n_g) {
  return 32 + (n_g + 3) / 4 * 4;
}
constexpr int kMaxS = 64;
constexpr int kMaxF = 32;
constexpr int kMaxObs = 256;    // widest observation (kernels/event_scan.py)
constexpr int kMaxWidth = 512;  // widest layer
constexpr int kNLayers = 6;     // encoder 0-2, actor hidden, DC head, GPU head
constexpr int kMaxWarps = 8;    // widest block: 256 threads
constexpr int kCand = 256;      // B3's compacted list, per window
constexpr int kRed = 8 * kMaxWarps;  // block-reduction scratch (4-byte words)
constexpr int kRegSlots = 16;   // a DC's power tree in registers up to P = 512
// an activation row: kMaxWidth values, a pad word after every 16 (`apos`)
constexpr int kActLen = kMaxWidth + kMaxWidth / 16;
constexpr int kMaxCluster = 8;  // blocks per lane in RL mode (portable limit)
// what the lane's block tells its cluster's other blocks
constexpr int CMD_FORWARD = 1, CMD_EXIT = 2;

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
  // the extended heuristic instance only (null otherwise): the uncapped E
  // grid [n_dc, 2, n_max, n_f], the hourly price [24], the per-DC carbon
  // intensity, the bandit's arms [R, n_dc, 2, n_f] and select count [R],
  // and the controller's counters [R, 4] (an output)
  P_EGRID_FULL = P_W0 + 2 * kNLayers, P_PRICE, P_CARBON, P_BAND_N, P_BAND_S,
  P_BAND_T, P_CTL,
  N_PTRS
};

// Integer parameters, in kernels/event_scan.py's INT_NAMES order.
enum Int {
  I_R, I_NSTEPS, I_NDC, I_NING, I_NF, I_NCAP, I_J, I_P, I_Q, I_W, I_NTAB,
  I_KDRAIN, I_DEFAULT_F, I_ALGO_JNF, I_PERF_FIRST, I_INF_PRIORITY,
  I_RESERVE, I_MAXGPU, I_FHI, I_FLO, I_SCALE_OUT_LOW,
  I_RL, I_GREEDY, I_OBS_DIM, I_PERC_K, I_WH0, I_WH1, I_WLAT, I_WAH,
  I_THREADS, I_SUM_WARPS, I_CLUSTER, I_LEAD,
  // the extended heuristic instance: on/off, the admission, the routing,
  // the eco objective, the log tick's control, debug's GPU count, fixed
  // ladder index (-1: the energy argmin)
  // and E-grid row, the uncapped grid's rows
  I_EXT, I_ADM, I_ROUTE, I_ECO_OBJ, I_CAP, I_NUM_FIXED, I_FIXED_F, I_DEBUG_ROW,
  I_NMAX,
  N_INTS
};

enum Flt {
  F_END, F_LOG_INTERVAL, F_SLA_THR, F_NEG_W, F_SLA_MS,
  // the extended instance: the power cap, its trigger (cap - margin) and
  // the router's five weights
  F_POWER_CAP, F_CAP_THR, F_W_LAT, F_W_E, F_W_C, F_W_COST, F_W_Q,
  N_FLTS
};
// the double clock's run end and log interval (kernels/event_scan.py
// DBL_NAMES)
enum Dbl { D_END, D_LOG_INTERVAL, N_DBLS };

// the extended instance's choices (kernels/event_scan.py ADM_/ROUTE_/
// ECO_/CAP_ codes)
constexpr int ADM_HEUR = 0, ADM_TABLE = 1, ADM_CC = 2, ADM_BANDIT = 3;
constexpr int RT_RANDOM = 0, RT_ECO = 1, RT_WEIGHTED = 2;
constexpr int ECO_ENERGY = 0, ECO_CARBON = 1, ECO_COST = 2;
constexpr int CAP_NONE = 0, CAP_IDLE = 1, CAP_UNIFORM = 2, CAP_GREEDY = 3;
// float32(1 / 3.6e6): XLA's multiplier for `/ 3.6e6` (sim/algos.py KWH)
constexpr float kKwh = 2.7777778655035945e-07f;

struct Args {
  void* p[N_PTRS];
  int i[N_INTS];
  float f[N_FLTS];
#ifdef DCG_CLOCK64
  double d[N_DBLS];
#endif
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
// JobSlab dataclass order -> the time column of the double instances'
// [4, J] array (-1: not a time field)
__constant__ int kJobTime[18] = {-1, -1, -1, -1, -1, -1, -1, -1, -1,
                                 0,  1,  2,  -1, -1, 3,  -1, -1, -1};
// the time columns' index in that array (any other column: unused)
__host__ __device__ constexpr int time_col(int f) {
  return f == JF_TING ? 0 : f == JF_TAVAIL ? 1 : f == JF_TSTART ? 2 : 3;
}
// the double instances' head: each warp's least (key, slot, value) of the
// three argmins, in shared memory after the time columns
constexpr int kWarpMinBytes = 3 * kMaxWarps * (8 + 8 + 4);

// per-lane scalars and small arrays, in static shared memory (the time
// fields in the clock's type)
template <typename TimeT>
struct SmallT {
  TimeT t, t_first, next_log_t;
  float dt;
  uint32_t k0, k1, kev0, kev1;
  uint32_t kc[6];  // the key's children 0, 1 (and 2 under RL)
  // the head's block argmins (finish, xfer, arrival) as (key << 32 | slot)
  // and its first EMPTY slot, a set per parity of the event (one is read
  // while the other is reset for the next event)
  unsigned long long amin[2][3];
  int afe[2];
  int jid, started, done, n_events, n_dropped;
  int n_fin[2];
  float units_fin[2];
  int lat_count[2], lat_ptr[2];
  // step-local results of the head, read by every lane
  int branch, j_fin, j_x, a_idx, has_slot, slot, can, flag;
  int busy[kMaxDC], cur_f[kMaxDC], total[kMaxDC];
  TimeT energy[kMaxDC], util[kMaxDC];
  float acc[kMaxDC], powers[kMaxDC];
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
  TimeT next_arr[kMaxS];
  int arr_count[kMaxS], c0[kMaxS];
  TimeT rec[N_REC];
  // RL mode: the action key, the step's finish record and pending decision,
  // both windows' p99, the masks, the action and the deferred start
  uint32_t ka0, ka1;
  int req_kind, req_idx;
  int fin_jt, fin_dcj, fin_slot;
  float fin_soj, fin_over;
  float p99[2];
  int p99_ok[2];      // p99[w] is that of window w as it stands
  float tau[2];       // B3: each window's threshold
  int n_cand[2];      // B3: each window's listed values
  int s_bits[4];      // B3: the two order statistics of each window (ordered bits)
  int mdc[kMaxDC], mg[kMaxHeads];
  int g_cap;          // the GPU-count mask's last feasible count
  int a_dc, a_g;
  int st_on, st_j, st_dcj, st_jt, st_n, st_f, st_newf;
  TimeT st_t0, st_pt0;
  float st_tpt0;
};

// the extended instance's scalars and tables, in static shared memory of
// that instance only (`ExtOf`)
struct Ext {
  int cc_hour;    // the hour carbon_cost's admission table (sm.jnf_*) is of
  int eco_key;    // what eco_e holds: eco_route's hour key, -1 none
  float eco_e[2 * kMaxDC];  // each (dc, jtype)'s energy per unit at its cell
  float ctl_now[kMaxDC], ctl_lo[kMaxDC];  // cap_uniform's clamped powers
  unsigned long long gmin;  // cap_greedy's block argmin (key << 32 | atom)
  float deficit, total;
  int live, best, newl;
  long long ticks, iters, cycles;  // the controller's counters
};
template <bool kExt> struct ExtOf { using T = Ext; };
template <> struct ExtOf<false> { using T = int; };

// ---------------------------------------------------------------- helpers

// fmul_pinned: the product rounded once, plus the reference's a*0 fence
__device__ __forceinline__ float fmulp(float a, float b) {
  return a * b + a * 0.0f;
}

// the double clock's fmul_pinned (a float32 power or GPU count widened,
// times the double gap): one rounding and the fence, in double
__device__ __forceinline__ double fmulp(double a, double b) {
  return __dadd_rn(__dmul_rn(a, b), __dmul_rn(a, 0.0));
}

// torch.clamp(x, min=m): NaN propagates
__device__ __forceinline__ float clamp_min(float x, float m) {
  return isnan(x) ? x : fmaxf(x, m);
}
__device__ __forceinline__ double clamp_min(double x, double m) {
  return isnan(x) ? x : fmax(x, m);
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
__device__ __forceinline__ double tmod(double a, double b) {
  double r = fmod(a, b);
  if (r != 0.0 && ((r < 0.0) != (b < 0.0))) r = r + b;
  return r;
}
__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

// torch.remainder on int32
__device__ __forceinline__ int iremainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// Engine._hour: floor((t mod 86400) / 3600) clipped to [0, 23], exact
// (t - t mod 3600 is a multiple of 3600), XLA's floor_divide in either
// clock's type
template <typename TimeT>
__device__ __forceinline__ int hour_of(TimeT t) {
  const TimeT day = tmod(t, (TimeT)86400);
  const TimeT whole = day - tmod(day, (TimeT)3600);
  const int h = (int)round_even(whole / (TimeT)3600);
  return h < 0 ? 0 : (h > 23 ? 23 : h);
}

// log of x >= 1 as XLA's CPU code computes a float32 log (ops/bandit.py
// `xla_log_f32`): the range reduction, the polynomial with the products
// its backend contracts into fused multiply-adds
__device__ float xla_log(float x) {
  x = fmaxf(x, 1.17549435e-38f);
  const uint32_t b = __float_as_uint(x);
  float e = (float)((int)(b >> 23) - 127);
  const float m = __uint_as_float((b & 0x807fffffu) | 0x3f000000u);
  e = 1.0f + e;
  const bool small = m < __uint_as_float(0x3f3504f3u);
  e = e - (small ? 1.0f : 0.0f);
  const float v = (m - 1.0f) + (small ? m : 0.0f);
  const float v2 = v * v, v3 = v2 * v;
  float y = __fmaf_rn(v, __uint_as_float(0x3d9021bbu), __uint_as_float(0xbdebd1b8u));
  float y1 = __fmaf_rn(v, __uint_as_float(0xbdfe5d4fu), __uint_as_float(0x3e11e9bfu));
  float y2 = __fmaf_rn(v, __uint_as_float(0x3e4cceacu), __uint_as_float(0xbe7ffffcu));
  y = __fmaf_rn(y, v, __uint_as_float(0x3def251au));
  y1 = __fmaf_rn(y1, v, __uint_as_float(0xbe2aae50u));
  y2 = __fmaf_rn(y2, v, __uint_as_float(0x3eaaaaaau));
  y = __fmaf_rn(y, v3, y1);
  y = __fmaf_rn(y, v3, y2);
  y = __fmaf_rn(y, v3, __uint_as_float(0xb95e8083u) * e);
  const float r = __fmaf_rn(-0.5f, v2, v) + y;
  return __fmaf_rn(__uint_as_float(0x3f318000u), e, r);
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

__device__ __forceinline__ bool before(double a, int ia, double b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na && nb) ? ia < ib : na;
  if (a < b) return true;
  if (b < a) return false;
  return ia < ib;
}

// before()'s order as an unsigned key: NaN first, then the float order with
// -0 == +0 (ties go to the lower index, which a key carries beside it);
// +inf maps below 0xffffffff, the key of "no candidate"
__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0u;
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
// ... and of a double (+inf below ~0)
__device__ __forceinline__ uint64_t order_key(double v) {
  if (isnan(v)) return 0ull;
  const uint64_t u = (uint64_t)__double_as_longlong(v == 0.0 ? 0.0 : v);
  return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
}

template <typename T>
__device__ __forceinline__ T* lane_ptr(const Args& a, int which, long long n,
                                       int r) {
  return reinterpret_cast<T*>(a.p[which]) + (long long)r * n;
}

// ---------------------------------------------------------------- RL mode:
// B3 (the windowed p99) and B4's policy (forward, log-softmax, sampling) as
// block-level device functions, shared by the event scan and the standalone
// batched launch `rl_tail_batch_launch`.  NT is the block's thread count.

namespace rlk {

constexpr float kTiny = 1.17549435e-38f;  // float32's smallest normal
constexpr float kNegMask = -1e9f;          // rl/nets.py NEG_MASK

template <int NT>
__device__ __forceinline__ void bar() {
  if constexpr (NT == 32) __syncwarp();
  else __syncthreads();
}

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

// float order as int order (-0 below +0): the largest of values that compare
// equal is then a fixed one of them whatever the order of the writes
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// What B3 keeps in shared memory: per window, the lanes' maxima [NT], the
// listed values [kCand], and in `Small`-like scalars the threshold, the
// list's length and the two order statistics.
struct P99Scratch {
  float* lmax;   // [2][NT]
  float* cand;   // [2][kCand]
  float* tau;    // [2]
  int* n_cand;   // [2]
  int* s_bits;   // [4]: window w's r_lo value at 2w, its r_hi value at 2w + 1
};

// The ranks of `windowed_percentile(buf, count, 99)`: (lo, hi) 0-based
// descending ranks with ties counted, clamped to [0, K - 1], and the
// interpolation weight.
struct P99Ranks {
  int m, r_lo, r_hi;
  float frac;
};

__device__ __forceinline__ P99Ranks p99_ranks(int count, int W, int K) {
  P99Ranks q;
  q.m = count < W ? count : W;
  const int mf = q.m > 1 ? q.m : 1;
  const float pos = 0.99f * (float)(mf - 1);
  const int lo = (int)floorf(pos);
  const int hi = lo + 1 < mf - 1 ? lo + 1 : mf - 1;
  q.frac = pos - (float)lo;
  int r_lo = mf - 1 - lo, r_hi = mf - 1 - hi;
  q.r_lo = r_lo < 0 ? 0 : (r_lo > K - 1 ? K - 1 : r_lo);
  q.r_hi = r_hi < 0 ? 0 : (r_hi > K - 1 ? K - 1 : r_hi);
  return q;
}

// The fallback for a long list: descending order statistics r_lo >= r_hi of
// the window's values at or above tau by rounds of warp max + tie count
// (one warp); into s_lo / s_hi (all lanes).  The ring holds latencies:
// finite values.
__device__ void rank_rounds(const float* buf, int m, float tau, int r_lo,
                            int r_hi, float& s_lo, float& s_hi, int lane) {
  s_lo = s_hi = -CUDART_INF_F;
  float prev = CUDART_INF_F;
  bool first = true;
  int cum = 0;
  for (;;) {
    float v = -CUDART_INF_F;
    for (int j = lane; j < m; j += 32) {
      const float x = buf[j];
      if (x >= tau && (first || x < prev)) v = fmaxf(v, x);
    }
    v = warp_max(v);
    int cnt = 0;
    for (int j = lane; j < m; j += 32) {
      const float x = buf[j];
      cnt += (x >= tau && x == v) ? 1 : 0;
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

// sim/algos.py `windowed_percentile(buf, count, 99)` of up to two windows at
// once (window w when `on[w]`), over the whole block; every thread calls it.
// Window w's result goes to out[w] (written by one thread; read it after a
// barrier).  The interpolation rounds as the plain version does: the second
// product fused into the add.
template <int NT>
__device__ void windowed_p99(const float* const buf[2], const int count[2],
                             const bool on[2], int W, int K, float* out,
                             const P99Scratch& sc, int tid) {
  constexpr int NW = NT / 32;
  const int lane = tid & 31, warp = tid >> 5;
  P99Ranks q[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) q[w] = p99_ranks(count[w], W, K);
  // 1. each thread's maximum over its slots j = tid + NT k
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!on[w]) continue;
    float lm = -CUDART_INF_F;
    for (int j = tid; j < q[w].m; j += NT) lm = fmaxf(lm, buf[w][j]);
    sc.lmax[w * NT + tid] = lm;
  }
  if (tid < 2) sc.n_cand[tid] = 0;
  if (tid < 4) sc.s_bits[tid] = ordered(-CUDART_INF_F);
  bar<NT>();
  // 2. the threshold, on warp w (warp 0 for both in a one-warp block): the
  // K-th largest of the 32 classes' maxima, class l being the slots
  // j = l (mod 32), which lane l of every warp read
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!on[w] || warp != (NW > 1 ? w : 0)) continue;
    float cm = -CUDART_INF_F;
#pragma unroll
    for (int v = 0; v < NW; ++v) cm = fmaxf(cm, sc.lmax[w * NT + 32 * v + lane]);
    // no larger than the K-th largest value: K class maxima lie at or above
    const float tau = K <= 32 ? warp_kth_largest(cm, K, lane) : -CUDART_INF_F;
    if (lane == 0) sc.tau[w] = tau;
  }
  bar<NT>();
  // 3. the values at or above the threshold into the list (a warp's in one
  // atomic; the list's order does not matter below)
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!on[w]) continue;
    const float tau = sc.tau[w];
    for (int base = 0; base < q[w].m; base += NT) {
      const int j = base + tid;
      const float x = j < q[w].m ? buf[w][j] : -CUDART_INF_F;
      const bool take = j < q[w].m && x >= tau;
      const unsigned mask = __ballot_sync(kAll, take);
      if (mask == 0) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(&sc.n_cand[w], __popc(mask));
      at = __shfl_sync(kAll, at, 0) + __popc(mask & ((1u << lane) - 1u));
      if (take && at < kCand) sc.cand[w * kCand + at] = x;
    }
  }
  bar<NT>();
  // 4. the order statistics: value x of the list sits at every descending
  // rank r with #(> x) <= r < #(>= x); the list holds every value at or
  // above the threshold, and ranks r_lo, r_hi lie above it
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!on[w] || q[w].m == 0) continue;
    const int n = sc.n_cand[w];
    if (n > kCand) continue;  // step 5
    const float* c = sc.cand + w * kCand;
    for (int at = tid; at < n; at += NT) {
      const float x = c[at];
      int gt = 0, ge = 0;
      for (int k = 0; k < n; ++k) {
        const float y = c[k];
        gt += y > x ? 1 : 0;
        ge += y >= x ? 1 : 0;
      }
      if (gt <= q[w].r_lo && q[w].r_lo < ge) atomicMax(&sc.s_bits[2 * w], ordered(x));
      if (gt <= q[w].r_hi && q[w].r_hi < ge) atomicMax(&sc.s_bits[2 * w + 1], ordered(x));
    }
  }
  // 5. a list that overflowed: rounds over the window on warp w
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!on[w] || q[w].m == 0 || sc.n_cand[w] <= kCand ||
        warp != (NW > 1 ? w : 0))
      continue;
    float s_lo, s_hi;
    rank_rounds(buf[w], q[w].m, sc.tau[w], q[w].r_lo, q[w].r_hi, s_lo, s_hi,
                lane);
    if (lane == 0) {
      sc.s_bits[2 * w] = ordered(s_lo);
      sc.s_bits[2 * w + 1] = ordered(s_hi);
    }
  }
  bar<NT>();
  if (tid < 2 && on[tid]) {
    const float s_lo = unordered(sc.s_bits[2 * tid]);
    const float s_hi = unordered(sc.s_bits[2 * tid + 1]);
    const float frac = q[tid].frac;
    out[tid] = __fmaf_rn(s_hi, frac, __fmul_rn(s_lo, 1.0f - frac));
  }
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

// where activation n sits in its shared row: a pad word after every 16, so
// the 16 threads of an output, each reading its own 16 contiguous inputs,
// hit 16 different banks
__device__ __forceinline__ int apos(int n) { return n + (n >> 4); }

struct Policy {
  const uint16_t* w[kNLayers];
  const uint16_t* b[kNLayers];
  int in[kNLayers], out[kNLayers], kp[kNLayers];
  int greedy;
};

// The rows of each layer that block `rank` of a cluster of `cs` holds in
// its shared memory (contiguous, ceil(out / nb) a block, the last blocks
// fewer), and where each layer's rows start in its slice.  The nb blocks
// are the whole cluster when `lead` is set, else blocks 1..cs-1: block 0
// then holds no rows, and its slab takes their place.
struct Slice {
  int lo[kNLayers], n[kNLayers];
  int off[kNLayers];   // where layer k's weight rows start (bf16 elements)
  int boff[kNLayers];  // where its biases start (floats, after the weights)
  int elems, belems;   // the slice's weights and biases
};

__device__ void plan_slice(const Policy& P, int cs, int lead, int rank,
                           Slice& S) {
  const int nb = lead ? cs : cs - 1, q = lead ? rank : rank - 1;
  int off = 0, boff = 0;
  for (int k = 0; k < kNLayers; ++k) {
    const int per = (P.out[k] + nb - 1) / nb;
    const int lo = q < 0 ? P.out[k] : q * per;
    S.lo[k] = lo < P.out[k] ? lo : P.out[k];
    S.n[k] = max(0, min(per, P.out[k] - lo));
    S.off[k] = off;
    S.boff[k] = boff;
    off += S.n[k] * P.kp[k];
    boff += S.n[k];
  }
  S.elems = off;
  S.belems = boff;
}

// The slice's biases (floats) follow its weights, 16-byte aligned.
__device__ __forceinline__ float* slice_biases(uint16_t* wsm, const Slice& S) {
  return reinterpret_cast<float*>(wsm) + (S.elems * 2 + 15) / 16 * 4;
}

// This block's slice of the weights and biases into shared memory (every
// thread).
template <int NT>
__device__ void load_slice(const Policy& P, const Slice& S, uint16_t* wsm,
                           int tid) {
  float* bsm = slice_biases(wsm, S);
  for (int k = 0; k < kNLayers; ++k) {
    const uint4* src =
        reinterpret_cast<const uint4*>(P.w[k] + (long long)S.lo[k] * P.kp[k]);
    uint4* dst = reinterpret_cast<uint4*>(wsm + S.off[k]);
    const int n16 = S.n[k] * P.kp[k] / 8;
    for (int q = tid; q < n16; q += NT) dst[q] = __ldg(src + q);
    for (int q = tid; q < S.n[k]; q += NT)
      bsm[S.boff[k] + q] = bf16_bits(P.b[k][S.lo[k] + q]);
  }
}

// This block's rows [lo, lo + nr) of one bf16 Dense, from its slice `wsm`,
// against `xs` [KP] (bit-reversed at `apos`, shared).  An output's KP
// products, in that order, are summed by the halving tree, which there is
// the pairwise tree of contiguous ranges: TPO = KP / EPT threads each sum
// EPT contiguous products by it (the leaves' levels), then shuffles add
// neighbouring threads' sums (the levels above), every thread of the
// output ending with the whole sum.  With `relu` output o goes to
// out[apos(bitrev(o, kp_out))] (the next layer's order) in every block of
// the cluster; without it to out[o] in block 0's shared memory.
template <int KP, int NT>
__device__ void dense_rows(float (&x)[16], bool load_x, const float* xs,
                           const uint16_t* wsm, const float* bsm, int lo,
                           int nr, float* out, int kp_out, bool relu, int cs,
                           int tid) {
  constexpr int EPT = KP < 16 ? KP : 16;  // products per thread
  constexpr int TPO = KP / EPT;           // threads per output (<= 32)
  constexpr int OPP = NT / TPO;           // outputs per pass of the block
  constexpr int NQ = EPT / 8;             // 16-byte loads per thread
  constexpr int U = 4;                    // passes in flight
  namespace cg = cooperative_groups;
  const cg::cluster_group cl = cg::this_cluster();
  const int c = tid % TPO, g = tid / TPO;
  // the thread's inputs, the same for every output of the layer
  if (load_x)
#pragma unroll
    for (int e = 0; e < EPT; ++e) x[e] = xs[apos(c * EPT + e)];
  for (int base = 0; base < nr; base += U * OPP) {
    uint4 wq[U][NQ];
    float bias[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int o = base + u * OPP + g;
      if (o < nr) {
        const uint4* wv = reinterpret_cast<const uint4*>(wsm + o * KP + c * EPT);
#pragma unroll
        for (int h = 0; h < NQ; ++h) wq[u][h] = wv[h];
        bias[u] = bsm[o];
      } else {
#pragma unroll
        for (int h = 0; h < NQ; ++h) wq[u][h] = make_uint4(0u, 0u, 0u, 0u);
        bias[u] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * OPP >= nr) break;  // the same for the whole block
      float p[EPT];
#pragma unroll
      for (int h = 0; h < NQ; ++h) {
        const uint32_t w4[4] = {wq[u][h].x, wq[u][h].y, wq[u][h].z, wq[u][h].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = h * 8 + 2 * e;
          p[idx] = __fmul_rn(x[idx], __uint_as_float(w4[e] << 16));
          p[idx + 1] = __fmul_rn(x[idx + 1], __uint_as_float(w4[e] & 0xffff0000u));
        }
      }
#pragma unroll
      for (int h = 1; h < EPT; h <<= 1)
#pragma unroll
        for (int e = 0; e < EPT; e += 2 * h) p[e] = __fadd_rn(p[e], p[e + h]);
      float sum = p[0];
#pragma unroll
      for (int h = 1; h < TPO; h <<= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(kAll, sum, h));
      // every thread of the output holds the sum: the output goes to
      // block q from its thread c = q (mod TPO), the stores in parallel
      const int o = base + u * OPP + g;
      if (o < nr) {
        const float y = bf16_round(sum);
        float z = bf16_round(__fadd_rn(y, bias[u]));
        if (relu) {
          z = z > 0.0f ? z : 0.0f;
          const int at = apos(bitrev(lo + o, kp_out));
          for (int q = c; q < cs; q += TPO) cl.map_shared_rank(out, q)[at] = z;
        } else if (c == 0) {
          cl.map_shared_rank(out, 0)[lo + o] = z;
        }
      }
    }
  }
}

template <int NT>
__device__ void dense_rows_kp(int kp, float (&x)[16], bool load_x,
                              const float* xs, const uint16_t* wsm,
                              const float* bsm, int lo, int nr, float* out,
                              int kp_out, bool relu, int cs, int tid) {
  switch (kp) {
#define DENSE_CASE(K)                                                       \
    case K:                                                                 \
      dense_rows<K, NT>(x, load_x, xs, wsm, bsm, lo, nr, out, kp_out,       \
                        relu, cs, tid);                                     \
      break;
    DENSE_CASE(8) DENSE_CASE(16) DENSE_CASE(32) DENSE_CASE(64)
    DENSE_CASE(128) DENSE_CASE(256)
    default: dense_rows<512, NT>(x, load_x, xs, wsm, bsm, lo, nr, out,
                                 kp_out, relu, cs, tid);
#undef DENSE_CASE
  }
}

// Encoder (3 ReLU layers) and actor (ReLU hidden, two heads) over the
// cluster: every block computes its slice's rows of each layer from its
// shared memory, writing each ReLU layer's outputs into every block's next
// row (act1, act0, ...; bit-reversed at `apos`) and the heads' logits into
// block 0's logit[0..n_dc) and logit[32..32+n_g) (`logit_len`); a cluster
// barrier ends each layer.  The layer's inputs must be in every block's
// act0 (and the cluster synchronized) when it is called; every thread of
// every block calls it.  Not inlined: it keeps its own registers (the
// lane's state is live around the call in block 0) and is built once per
// block width.
template <int NT>
__device__ __noinline__ void forward_cluster(const Policy& P, const Slice& S,
                                const uint16_t* wsm, float* act0, float* act1,
                                float* logit, int cs, int tid) {
  namespace cg = cooperative_groups;
  const float* bsm = slice_biases(const_cast<uint16_t*>(wsm), S);
  float x[16];
  for (int k = 0; k < 4; ++k) {
    const float* xs = (k & 1) ? act1 : act0;
    float* out = (k & 1) ? act0 : act1;
    const int kp_out = P.kp[k + 1];
    for (int m = tid; m < kp_out; m += NT)
      if (bitrev(m, kp_out) >= P.out[k]) out[apos(m)] = 0.0f;
    dense_rows_kp<NT>(P.kp[k], x, true, xs, wsm + S.off[k], bsm + S.boff[k],
                      S.lo[k], S.n[k], out, kp_out, true, cs, tid);
    cg::this_cluster().sync();
  }
  // the heads share their input (layer 3 wrote act0), and so the registers
  dense_rows_kp<NT>(P.kp[4], x, true, act0, wsm + S.off[4], bsm + S.boff[4],
                    S.lo[4], S.n[4], logit, 0, false, cs, tid);
  dense_rows_kp<NT>(P.kp[5], x, false, act0, wsm + S.off[5], bsm + S.boff[5],
                    S.lo[5], S.n[5], logit + 32, 0, false, cs, tid);
  cg::this_cluster().sync();
}

// The lane's block asks its cluster for one forward: `obs` [in[0]] float32
// in natural order becomes the first layer's input in every block, every
// other block is told to run the forward, and the cluster runs it.  Only
// block 0 calls it (its threads all), while the others wait in
// `serve_forwards`.
template <int NT>
__device__ void forward(const Policy& P, const Slice& S, const uint16_t* wsm,
                        const float* obs, float* act0, float* act1,
                        float* logit, int* cmd, int cs, int tid) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cl = cg::this_cluster();
  const int kp0 = P.kp[0];
  for (int e = tid; e < kp0 * cs; e += NT) {  // (input n, block q) a thread
    const int n = e % kp0, q = e / kp0;
    const int r = bitrev(n, kp0);
    const float v = r < P.in[0] ? bf16_round(obs[r]) : 0.0f;
    cl.map_shared_rank(act0, q)[apos(n)] = v;
  }
  if (tid > 0 && tid < cs) *cl.map_shared_rank(cmd, tid) = CMD_FORWARD;
  cl.sync();
  forward_cluster<NT>(P, S, wsm, act0, act1, logit, cs, tid);
}

// The other blocks of a lane's cluster: run the forwards block 0 asks for
// until it says the chunk is over (every thread; block 0 sends the
// command, then synchronizes the cluster).
template <int NT>
__device__ void serve_forwards(const Policy& P, const Slice& S,
                               const uint16_t* wsm, float* act0, float* act1,
                               float* logit, const int* cmd, int cs, int tid) {
  namespace cg = cooperative_groups;
  for (;;) {
    cg::this_cluster().sync();
    if (*cmd == CMD_EXIT) return;
    forward_cluster<NT>(P, S, wsm, act0, act1, logit, cs, tid);
  }
}

// Block 0's last word to its cluster (every thread of block 0).
template <int NT>
__device__ void release_cluster(int* cmd, int cs, int tid) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cl = cg::this_cluster();
  if (tid > 0 && tid < cs) *cl.map_shared_rank(cmd, tid) = CMD_EXIT;
  cl.sync();
}

// The policy's layer widths from the launch's integers (thread 0).
__device__ void policy_from(Policy& P, void* const* w, const int* ints) {
  const int n_dc = ints[I_NDC], n_g = ints[I_MAXGPU];
  const int widths[kNLayers + 1] = {ints[I_OBS_DIM], ints[I_WH0], ints[I_WH1],
                                    ints[I_WLAT],    ints[I_WAH], n_dc, n_g};
  for (int k = 0; k < kNLayers; ++k) {
    P.w[k] = reinterpret_cast<const uint16_t*>(w[2 * k]);
    P.b[k] = reinterpret_cast<const uint16_t*>(w[2 * k + 1]);
  }
  for (int k = 0; k < 4; ++k) {
    P.in[k] = widths[k];
    P.out[k] = widths[k + 1];
  }
  P.in[4] = P.in[5] = widths[4];
  P.out[4] = n_dc;
  P.out[5] = n_g;
  for (int k = 0; k < kNLayers; ++k) P.kp[k] = pow2_at_least(P.in[k]);
  P.greedy = ints[I_GREEDY];
}

// A head of n actions (n <= 32 * kS) on one warp, action a at lane a % 32
// of register slot a / 32 (kS slots: 1, or kSlots for a wider head):
// rl/nets.py `masked_log_softmax` (the infeasible logits at -1e9, the
// exponentials
// summed by the halving tree over pow2(n): its levels of distance >= 32 in
// a lane's registers, slot s + half / 32 into slot s, the last five by
// shuffles), then jax.random.categorical(split(key)[which], logp)
// (Gumbel-max over uniform(tiny, 1), action a drawing counter a, the first
// maximum wins), or the first argmax when greedy, over the slots whose bit
// is set in `own` only: every warp that calls it computes the whole
// log-softmax, and draws and writes logp[a] (where logp is given) for its
// own slots.  Returns that first maximum (every lane): its action (kNone
// when the warp has no action) and its value in *v.
constexpr int kNone = 1 << 30;

template <int kS>
__device__ int head_sample(const float* logit, const int* mask, int n,
                           float* logp, uint32_t k0, uint32_t k1,
                           uint32_t which, bool greedy, int lane,
                           unsigned own, float* v) {
  float sh[kS], e[kS];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int a = 32 * s + lane;
    sh[s] = a < n ? (mask[a] ? logit[a] : kNegMask) : -CUDART_INF_F;
    mx = fmaxf(mx, sh[s]);
  }
  const float m = warp_max(mx);
  const int p = pow2_at_least(n);
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    sh[s] = __fsub_rn(sh[s], m);
    e[s] = 32 * s + lane < n ? expf(sh[s]) : 0.0f;
  }
#pragma unroll
  for (int hs = kS / 2; hs >= 1; hs >>= 1)
    if (64 * hs <= p)  // the level of distance 32 hs
#pragma unroll
      for (int s = 0; s < hs; ++s) e[s] = __fadd_rn(e[s], e[s + hs]);
  for (int half = (p < 32 ? p : 32) >> 1; half >= 1; half >>= 1) {
    const float o = __shfl_down_sync(kAll, e[0], half);
    if (lane < half) e[0] = __fadd_rn(e[0], o);
  }
  const float lse = logf(__shfl_sync(kAll, e[0], 0));
  uint32_t c0 = 0, c1 = 0;
  if (!greedy) tf::child(k0, k1, which, c0, c1);
  float bv = 0.0f;
  int best = kNone;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int a = 32 * s + lane;
    if (!((own >> s) & 1u) || a >= n) continue;
    const float lp = __fsub_rn(sh[s], lse);
    if (logp != nullptr) logp[a] = lp;
    float va = lp;
    if (!greedy) {
      uint32_t o0, o1;
      tf::threefry(c0, c1, 0u, (uint32_t)a, o0, o1);
      const float span = __fsub_rn(1.0f, kTiny);
      const float f = tf::unit_float(o0 ^ o1);
      const float u = fmaxf(kTiny, __fadd_rn(__fmul_rn(f, span), kTiny));
      const float gum = -logf(-logf(u));
      va = __fadd_rn(gum, lp);
    }
    if (best == kNone || va > bv) {  // a lane's slots rise: ties stay
      bv = va;
      best = a;
    }
  }
  // the first maximum: a larger value, or an equal one at a lower index
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kAll, bv, off);
    const int ob = __shfl_xor_sync(kAll, best, off);
    if (ob != kNone && (best == kNone || ov > bv || (ov == bv && ob < best))) {
      bv = ov;
      best = ob;
    }
  }
  *v = bv;
  return best;
}

// The GPU-count head wider than a warp (head_sample over kSlots), not
// inlined: the slots' code keeps its own registers (the lane's state is
// live around the call in block 0)
__device__ __noinline__ int head_sample_wide(const float* logit,
                                             const int* mask, int n,
                                             float* logp, uint32_t k0,
                                             uint32_t k1, bool greedy,
                                             int lane, unsigned own,
                                             float* v) {
  return head_sample<kSlots>(logit, mask, n, logp, k0, k1, 1u, greedy, lane,
                             own, v);
}

// Both heads (n_dc <= 32, n_dc + n_g <= kMaxHeads), the actions into
// *a_dc / *a_g and, where `logp` is given, the log-probabilities into
// logp[0..n_dc) and logp[32..32+n_g).  `ka` is the step's action key.
// Every thread calls it; read the actions after a barrier.  kWide (n_g >
// 32): the DC head on the block's last warp, the GPU-count head's slots s
// on warps s mod NW, each warp's first maximum then the first across the
// warps, a lower index winning ties.  Otherwise each head on a warp of its
// own (warps 0 and 1; warp 0 in a one-warp block): a separate instance,
// so the kernels at the published widths carry none of the wide code.
template <int NT, bool kWide>
__device__ void sample_heads(const float* logit, const int* mdc, int n_dc,
                             const int* mg, int n_g, float* logp, uint32_t ka0,
                             uint32_t ka1, bool greedy, int* a_dc, int* a_g,
                             int tid) {
  constexpr int NW = NT / 32;
  const int lane = tid & 31, warp = tid >> 5;
  float v;
  float* lg = logp == nullptr ? nullptr : logp + 32;
  if constexpr (!kWide) {
    if (warp == 0) {
      const int a = head_sample<1>(logit, mdc, n_dc, logp, ka0, ka1, 0u,
                                   greedy, lane, 1u, &v);
      if (lane == 0) *a_dc = a;
    }
    if (warp == (NT > 32 ? 1 : 0)) {
      const int a = head_sample<1>(logit + 32, mg, n_g, lg, ka0, ka1, 1u,
                                   greedy, lane, 1u, &v);
      if (lane == 0) *a_g = a;
    }
    return;
  }
  __shared__ float cand_v[NW];
  __shared__ int cand_a[NW];
  if (warp == NW - 1) {
    const int a = head_sample<1>(logit, mdc, n_dc, logp, ka0, ka1, 0u, greedy,
                                 lane, 1u, &v);
    if (lane == 0) *a_dc = a;
  }
  const int ns = (n_g + 31) >> 5;      // the GPU-count head's slots
  const int nw = ns < NW ? ns : NW;    // the warps that draw them
  if (warp < nw) {
    unsigned own = 0;  // slots warp, warp + NW, ...
    for (int s = warp; s < kSlots; s += NW) own |= 1u << s;
    const int a = head_sample_wide(logit + 32, mg, n_g, lg, ka0, ka1, greedy,
                                   lane, own, &v);
    if (lane == 0) {
      if (nw == 1) *a_g = a;
      cand_v[warp] = v;
      cand_a[warp] = a;
    }
  }
  if (nw > 1) {  // the same for the whole block
    bar<NT>();
    if (tid == 0) {
      float bv = cand_v[0];
      int best = cand_a[0];
      for (int w = 1; w < nw; ++w)  // warp w's actions follow warp w - 1's
        if (cand_a[w] != kNone && (best == kNone || cand_v[w] > bv)) {
          bv = cand_v[w];
          best = cand_a[w];
        }
      *a_g = best;
    }
  }
}

}  // namespace rlk

}  // namespace


namespace {

// Everything one lane's block needs; every thread holds a copy.  NT threads
// (NW warps); thread `tid` is lane `lane` of warp `warp`; kWide: RL mode
// with a GPU-count head wider than a warp (`rlk::sample_heads`); kExt: the
// extended heuristic instance (carbon_cost, debug, bandit, eco and weighted
// routing, the log tick's control), whose code the default_policy /
// joint_nf instance does not carry.
template <int NT, bool kWide = false, bool kExt = false,
          typename TimeT = float>
struct Lane {
  static constexpr int NW = NT / 32;
  // the double clock's instance (see the head note)
  static constexpr bool kD = sizeof(TimeT) == 8;
  SmallT<TimeT>& sm;
  int tid, lane, warp, n_sum;
  int par;  // the parity of the head's argmin accumulators (sm.amin)
  int J, P, n_dc, n_f, Q, W, n_tab, k_drain, default_f, algo_jnf, perf_first,
      inf_priority, reserve, maxgpu, f_hi, f_lo, scale_out_low;
  TimeT end, li;
  int* si;      // [N_JI, J] shared
  float* sf;    // [N_JF, J] shared
  TimeT* sd;    // double instances: [4, J] shared, the time columns
  // double instances: each warp's least (key, slot, value) per argmin
  unsigned long long* wkey;  // [3, kMaxWarps] shared
  double* wval;              // [3, kMaxWarps] shared
  int* widx;                 // [3, kMaxWarps] shared
  float* vals;  // [P] shared scratch
  float* scr;   // [n_sum, P] shared scratch: a row per DC-summing warp
  float* red_v; // [kRed / 2] shared: the value of each warp's argmin
  int* red_i;   // [kRed / 2] shared: the warps' first EMPTY slots
  TimeT* recs;  // [n_dc, 2, Q, N_REC] global (this lane's)
  float* lat_buf;
  float* em_t;
  int* em_branch;
  float* em_cluster;
  float* em_job;
  const float* sizes;  // [S, n_tab] (this lane's)
  const TimeT* tnext;
  const float* transfer;  // [n_ing, n_dc, 2]
  const float* netlat;    // [n_ing, n_dc]
  const float* egrid;     // E_grid_cap [n_dc, 2, n_cap, n_f]
  int n_cap;
  // the extended instance
  Ext* xs;                // shared
  int adm, route, eco_obj, cap;
  float power_cap, cap_thr, w_lat, w_e, w_c, w_cost, w_q;
  const float* price;     // [24]
  const float* carbon;    // [n_dc]
  int* band_n;            // [n_dc, 2, n_f] (this lane's)
  float* band_s;
  int* band_t;
  // RL mode
  int rl, obs_dim, K, n_g;
  float sla_thr, neg_w, sla_ms, inv_kwh;
  const rlk::Policy* pol;   // shared
  const rlk::Slice* slice;  // shared: this block's rows of each layer
  const uint16_t* wsm;      // shared: those rows' weights
  int* cmd;                 // shared: the word the cluster's blocks read
  int cs;                   // blocks in the lane's cluster
  rlk::P99Scratch p99s;
  float* obs;    // [kMaxObs] shared
  float* act0;   // [kActLen] shared (at one offset in every block)
  float* act1;   // [kActLen] shared (likewise)
  float* logit;  // [logit_len(n_g)] shared: DC head at 0, GPU-count head at 32
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
  // a time column of the slab (JF_TING, JF_TAVAIL, JF_TSTART, JF_PT)
  __device__ __forceinline__ TimeT& TF(int f, int j) {
    if constexpr (kD) return sd[time_col(f) * J + j];
    else return sf[f * J + j];
  }
  __device__ __forceinline__ void bar() { rlk::bar<NT>(); }

  // ------------------------------------------------ block-wide slab passes

  // A block argmin in before()'s order of each thread's (key, index,
  // value): a warp's by two REDUX (the least key, then the least index
  // with it), then one shared 64-bit atomic min per warp into *acc; the
  // warp's winning value goes to red_v[s][warp], where the owner of the
  // block's winner (slot j's thread is j mod NT) left it.  Read both after
  // a barrier.
  __device__ __forceinline__ void argmin_post(unsigned long long* acc, int s,
                                              uint32_t key, int idx, float v) {
    const uint32_t wk = __reduce_min_sync(kAll, key);
    const int wj = __reduce_min_sync(kAll, key == wk ? idx : 0x7fffffff);
    const float wv = __shfl_sync(kAll, v, (wj % NT) & 31);
    if (lane == 0 && wk != 0xffffffffu) {
      atomicMin(acc, ((unsigned long long)wk << 32) | (unsigned)wj);
      red_v[s * kMaxWarps + warp] = wv;
    }
  }
  // the winner of argmin_post's slot s: its index, its value
  __device__ __forceinline__ int argmin_index(unsigned long long a) {
    return (int)(unsigned)(a & 0xffffffffu);
  }
  __device__ __forceinline__ float argmin_value(int s, int idx) {
    return red_v[s * kMaxWarps + ((idx % NT) >> 5)];
  }
  // The double instances' block argmin: a warp's least 64-bit key by two
  // REDUX (its high word, then the low word among those), the least index
  // with it, the value from that slot's lane; lane 0 posts all three for
  // slot s (every warp that takes part posts, so nothing stale remains).
  __device__ __forceinline__ void argmin_post64(int s, uint64_t key, int idx,
                                                double v) {
    const uint32_t hi = __reduce_min_sync(kAll, (uint32_t)(key >> 32));
    const uint32_t lo = __reduce_min_sync(
        kAll, (uint32_t)(key >> 32) == hi ? (uint32_t)key : 0xffffffffu);
    const uint64_t wk = ((uint64_t)hi << 32) | lo;
    const int wj = __reduce_min_sync(kAll, key == wk ? idx : 0x7fffffff);
    const double wv = __shfl_sync(kAll, v, (wj % NT) & 31);
    if (lane == 0) {
      wkey[s * kMaxWarps + warp] = wk;
      widx[s * kMaxWarps + warp] = wj;
      wval[s * kMaxWarps + warp] = wv;
    }
  }
  // the least (key, index) over the first nw warps' posts of slot s, after
  // the barrier: its index, its value in v
  __device__ __forceinline__ int argmin_read64(int s, int nw, TimeT& v) {
    unsigned long long bk = wkey[s * kMaxWarps];
    int bj = widx[s * kMaxWarps], bw = 0;
    for (int w = 1; w < nw; ++w) {
      const unsigned long long k = wkey[s * kMaxWarps + w];
      const int j = widx[s * kMaxWarps + w];
      if (k < bk || (k == bk && j < bj)) {
        bk = k;
        bj = j;
        bw = w;
      }
    }
    v = (TimeT)wval[s * kMaxWarps + bw];
    return bj;
  }

  // first EMPTY slot, or J when the slab is full (every thread calls it;
  // the result is on every thread)
  __device__ int first_empty() {
    int fe = J;
    for (int j = tid; j < J; j += NT)
      if (I(JI_STATUS, j) == ST_EMPTY) {
        fe = j;
        break;
      }
    fe = __reduce_min_sync(kAll, fe);
    if constexpr (NW == 1) return fe;
    if (lane == 0) red_i[warp] = fe;
    bar();
    return __reduce_min_sync(kAll, lane < NW ? red_i[lane] : J);
  }

  // Per-DC fixed-tree sums of vals[0..J) into out[d] (every thread calls it,
  // after a barrier that follows the writes to vals; ends with a barrier):
  // warp w < n_sum sums DCs w, w + n_sum, ... in its own scratch row.  For
  // each DC, the values of its slots (zero elsewhere and in the padding to
  // P) reduced by the reference's halving tree.  Levels with half >= 32
  // pair slots of one lane (j and j + half are congruent mod 32); the last
  // five levels are warp shuffles, element i taking element i + half.
  // With `only_dirty`, DCs whose flag in sm.dirty is clear keep their
  // out[d].
  __device__ void dc_tree_sums(float* out, bool only_dirty) {
    if (warp < n_sum) {
      for (int d = warp; d < n_dc; d += n_sum) {
        if (only_dirty && !sm.dirty[d]) continue;
        float v = P <= 32 * kRegSlots ? dc_lane_sum_regs(d)
                                      : dc_lane_sum_shared(d, scr + warp * P);
        for (int half = (P < 32 ? P : 32) >> 1; half >= 1; half >>= 1) {
          const float o = __shfl_down_sync(kAll, v, half);
          if (lane < half) v = v + o;
        }
        if (lane == 0) out[d] = v;
      }
    }
    bar();
  }

  // The levels with half >= 32 of DC d's tree, on this lane's elements
  // j = lane + 32 k: in registers (P <= 32 kRegSlots), element k taking
  // element k + half / 32 ...
  __device__ float dc_lane_sum_regs(int d) {
    const int n = P >> 5;  // elements per lane (0: P < 32, one element)
    float v[kRegSlots];
#pragma unroll
    for (int k = 0; k < kRegSlots; ++k) {
      const int j = lane + 32 * k;
      v[k] = (k < (n > 0 ? n : 1) && j < J && I(JI_DC, j) == d) ? vals[j] : 0.0f;
    }
#pragma unroll
    for (int h = kRegSlots / 2; h >= 1; h >>= 1)
      if (h < n)
#pragma unroll
        for (int k = 0; k < h; ++k) v[k] = v[k] + v[k + h];
    return v[0];
  }
  // ... or in this warp's scratch row (a larger slab)
  __device__ float dc_lane_sum_shared(int d, float* s) {
    for (int j = lane; j < P; j += 32)
      s[j] = (j < J && I(JI_DC, j) == d) ? vals[j] : 0.0f;
    for (int half = P >> 1; half >= 32; half >>= 1)
      for (int j = lane; j < half; j += 32) s[j] = s[j] + s[j + half];
    return lane < P ? s[lane] : 0.0f;
  }

  // ------------------------------------------------ scalar helpers (thread 0)

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

  __device__ void rec_from_slab(int j, TimeT* rec) {
    rec[R_SIZE] = F(JF_SIZE, j);
    rec[R_SEQ] = (TimeT)I(JI_SEQ, j);
    rec[R_INGRESS] = (TimeT)I(JI_INGRESS, j);
    rec[R_T_INGRESS] = TF(JF_TING, j);
    rec[R_T_AVAIL] = TF(JF_TAVAIL, j);
    rec[R_NET_LAT] = F(JF_NETLAT, j);
    rec[R_UNITS_DONE] = F(JF_UDONE, j);
    rec[R_T_START] = TF(JF_TSTART, j);
    rec[R_PREEMPT_COUNT] = (TimeT)I(JI_PCOUNT, j);
    rec[R_PREEMPT_T] = TF(JF_PT, j);
    rec[R_TOTAL_PREEMPT] = F(JF_TPT, j);
  }

  // _ring_push: append, or count a drop when the ring is full
  __device__ void ring_push(int dcj, int jt, const TimeT* rec) {
    const int q = dcj * 2 + jt;
    const int tail = sm.qtail[q];
    if (wsub(tail, sm.qhead[q]) < Q) {
      TimeT* row = recs + ((long long)q * Q + iremainder(tail, Q)) * N_REC;
      for (int k = 0; k < N_REC; ++k) row[k] = rec[k];
      sm.qtail[q] = wadd(tail, 1);
    } else {
      sm.n_dropped = wadd(sm.n_dropped, 1);
    }
  }

  // whether _ring_head finds a record to start at dcj (any thread)
  __device__ bool ring_ready(int dcj) {
    const int q0 = dcj * 2, q1 = dcj * 2 + 1;
    const bool has0 = wsub(sm.qtail[q0], sm.qhead[q0]) > 0;
    const bool has1 = wsub(sm.qtail[q1], sm.qhead[q1]) > 0;
    return (has0 && free_for(dcj, 0) > 0) || (has1 && free_for(dcj, 1) > 0);
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
    const TimeT* row =
        recs + ((long long)q * Q + iremainder(sm.qhead[q], Q)) * N_REC;
    for (int k = 0; k < N_REC; ++k) sm.rec[k] = row[k];
    found = has_i || has_t;
    return jt;
  }

  // _decide_start_vals + _start_from_rec: commit `rec` to RUNNING at slot
  __device__ void start_from_rec(int slot, int dcj, int jt, const TimeT* rec) {
    const int fr = free_for(dcj, jt);
    const int cur = sm.cur_f[dcj];
    int n_d, f_d, new_f;
    if (kExt && adm == ADM_BANDIT) {
      n_d = fr < maxgpu ? fr : maxgpu;
      f_d = bandit_select(dcj * 2 + jt);
      new_f = cur;
    } else if (kExt ? adm != ADM_HEUR : algo_jnf) {
      // a table of first-minimum cells: joint_nf's and debug's built at
      // launch, carbon_cost's for the hour of the decision
      if (kExt && adm == ADM_CC) {
        const int h = hour_of(sm.t);
        if (h != xs->cc_hour) cc_tables(h);
      }
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
    const TimeT t = sm.t;
    const TimeT t_start0 = rec[R_T_START];
    const bool resuming = rec[R_PREEMPT_T] > 0.0f;
    I(JI_STATUS, slot) = ST_RUNNING;
    I(JI_JTYPE, slot) = jt;
    I(JI_INGRESS, slot) = (int)rec[R_INGRESS];
    I(JI_DC, slot) = dcj;
    I(JI_SEQ, slot) = (int)rec[R_SEQ];
    F(JF_SIZE, slot) = (float)rec[R_SIZE];
    F(JF_UDONE, slot) = (float)rec[R_UNITS_DONE];
    I(JI_N, slot) = n_st;
    I(JI_FIDX, slot) = f_d;
    F(JF_SPU, slot) = spu;
    F(JF_WATTS, slot) = watts;
    TF(JF_TING, slot) = rec[R_T_INGRESS];
    TF(JF_TAVAIL, slot) = rec[R_T_AVAIL];
    TF(JF_TSTART, slot) = t_start0 <= 0.0f ? t : t_start0;
    F(JF_NETLAT, slot) = (float)rec[R_NET_LAT];
    I(JI_PCOUNT, slot) = (int)rec[R_PREEMPT_COUNT];
    TF(JF_PT, slot) = 0.0f;
    F(JF_TPT, slot) = (float)rec[R_TOTAL_PREEMPT] +
                      (resuming ? (float)(t - rec[R_PREEMPT_T]) : 0.0f);
    sm.busy[dcj] = wadd(sm.busy[dcj], n_st);
    sm.cur_f[dcj] = new_f;
    sm.dirty[dcj] = 1;
  }

  // ------------------------------------------------ the extended instance
  // (thread 0 unless said otherwise)

  // bandit_select for (dc, jtype) q: the first arm never pulled, else the
  // first maximum of mean + sqrt(2 ln t / n); the select count advances
  __device__ int bandit_select(int q) {
    const int t = wadd(*band_t, 1);
    const int* N = band_n + q * n_f;
    const float* S = band_s + q * n_f;
    int f = -1;
    for (int k = 0; k < n_f; ++k)
      if (N[k] < 1) {
        f = k;
        break;
      }
    if (f < 0) {
      const float lt = xla_log(fmaxf((float)t, 1.0f));
      float best = 0.0f;
      for (int k = 0; k < n_f; ++k) {
        const float ns = (float)(N[k] > 1 ? N[k] : 1);
        const float mean = N[k] > 0 ? S[k] / ns : 0.0f;
        const float ucb = mean + sqrtf((lt * 2.0f) / ns);
        if (k == 0 || ucb > best || (isnan(ucb) && !isnan(best))) {
          best = ucb;
          f = k;
        }
      }
    }
    *band_t = t;
    return f;
  }

  // carbon_cost's admission table for hour h: each (dc, jtype)'s first
  // minimum of E * (price * kKwh) over the capped grid when the price is
  // positive, else of E * ci
  __device__ void cc_tables(int h) {
    const float pr = price[h];
    const float pc = pr * kKwh;
    for (int q = 0; q < 2 * n_dc; ++q) {
      const float ci = carbon[q >> 1];
      const float* eg = egrid + (long long)q * n_cap * n_f;
      float bv = 0.0f;
      int bi = 0;
      for (int k = 0; k < n_cap * n_f; ++k) {
        const float v = pr > 0.0f ? eg[k] * pc : eg[k] * ci;
        if (k == 0 || before(v, k, bv, bi)) {
          bv = v;
          bi = k;
        }
      }
      sm.jnf_n[q] = bi / n_f + 1;
      sm.jnf_f[q] = bi % n_f;
    }
    xs->cc_hour = h;
  }

  // route_eco's first half for the hour key: each (dc, jtype)'s energy per
  // unit at its first-minimum cell of the objective's grid score
  __device__ void eco_tables(int key, float pc) {
    for (int q = 0; q < 2 * n_dc; ++q) {
      const float ci = carbon[q >> 1];
      const float* eg = egrid + (long long)q * n_cap * n_f;
      float bv = 0.0f;
      int bi = 0;
      for (int k = 0; k < n_cap * n_f; ++k) {
        const float v = eco_obj == ECO_ENERGY   ? eg[k]
                        : eco_obj == ECO_CARBON ? eg[k] * ci
                                                : eg[k] * pc;
        if (k == 0 || before(v, k, bv, bi)) {
          bv = v;
          bi = k;
        }
      }
      xs->eco_e[q] = eg[bi];
    }
    xs->eco_key = key;
  }

  // the DC an arrival of (ing, jt, size) is routed to: route_eco's or
  // route_weighted's first minimum over the DCs
  __device__ int route_det(int ing, int jt, float size) {
    const int h = hour_of(sm.t);
    const float pc = price[h] * kKwh;
    if (route == RT_ECO) {
      const int key = eco_obj == ECO_COST ? h : 0;
      if (key != xs->eco_key) eco_tables(key, pc);
    }
    float bv = 0.0f;
    int bd = 0;
    for (int d = 0; d < n_dc; ++d) {
      const float e_job = xs->eco_e[d * 2 + jt] * size;
      float v;
      if (route == RT_ECO) {
        v = eco_obj == ECO_ENERGY   ? e_job
            : eco_obj == ECO_CARBON ? (e_job * kKwh) * carbon[d]
                                    : e_job * pc;
      } else {  // RouterPolicy.score, summed left to right
        const int ql = wadd(wsub(sm.qtail[2 * d], sm.qhead[2 * d]),
                            wsub(sm.qtail[2 * d + 1], sm.qhead[2 * d + 1]));
        v = w_lat * netlat[ing * n_dc + d];
        v = v + w_e * e_job;
        v = v + w_c * ((e_job * kKwh) * carbon[d]);
        v = v + w_cost * (e_job * pc);
        v = v + w_q * (float)ql;
      }
      if (d == 0 || before(v, d, bv, bd)) {
        bv = v;
        bd = d;
      }
    }
    return bd;
  }

  // task_power_w(n, f) of (dc, jtype) q
  __device__ float task_power(int q, float f, int n) {
    const int n2 = n > 0 ? n : 0;
    const float f2 = clamp_min(f, 0.0f);
    const float gp = fmulp(sm.pa[q], (f2 * f2) * f2) + fmulp(sm.pb[q], f2) +
                     sm.pg[q];
    return fmulp((float)n2, gp);
  }

  // tree_sum_last over the DCs of x (thread 0)
  __device__ float dc_total(const float* x) {
    float v[kMaxDC];
    int p = 1;
    while (p < n_dc) p <<= 1;
    for (int i = 0; i < p; ++i) v[i] = i < n_dc ? x[i] : 0.0f;
    while (p > 1) {
      p >>= 1;
      for (int i = 0; i < p; ++i) v[i] = v[i] + v[i + p];
    }
    return v[0];
  }

  // every DC's _dc_power again where a controller changed a running job's
  // watts (every thread; ends with a barrier)
  __device__ void refresh_powers() {
    for (int j = tid; j < J; j += NT)
      vals[j] = I(JI_STATUS, j) == ST_RUNNING ? F(JF_WATTS, j) : 0.0f;
    bar();
    dc_tree_sums(sm.active, true);
    if (tid < n_dc) {
      const int d = tid;
      sm.powers[d] = sm.active[d] +
                     fmulp((float)wsub(sm.total[d], sm.busy[d]), sm.idle_w[d]);
      sm.dirty[d] = 0;
    }
    bar();
  }

  // _control at the top of a log tick (every thread; ends with a barrier):
  // idle DCs to ladder index 0 (eco_route / carbon_cost under a cap), or a
  // cap controller when the fleet's power exceeds cap - margin
  __device__ void control() {
    if (cap == CAP_IDLE) {
      if (tid < n_dc && sm.busy[tid] == 0) sm.cur_f[tid] = 0;
      bar();
      return;
    }
    long long c0 = 0;
    if (tid == 0) {
      c0 = clock64();
      xs->total = dc_total(sm.powers);
      xs->live = xs->total > cap_thr;
    }
    bar();
    const int need = xs->live;
    bar();  // read by every thread before thread 0 writes it again
    if (!need) return;
    if (cap == CAP_UNIFORM) cap_uniform();
    else if (cap == CAP_GREEDY) cap_greedy();
    if (tid == 0) {
      xs->ticks += 1;
      xs->cycles += clock64() - c0;
    }
  }

  // _cap_uniform: lower by one step the DC whose step saves the most power
  // while the deficit lasts (every thread)
  __device__ void cap_uniform() {
    if (tid == 0) {
      xs->deficit = clamp_min(xs->total - power_cap, 0.0f);
      xs->live = xs->deficit > 1e-6f;
    }
    bar();
    while (xs->live) {
      // each DC's running power clamped to its level, then one level lower
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = tid; j < J; j += NT) {
          float v = 0.0f;
          if (I(JI_STATUS, j) == ST_RUNNING) {
            const int d = I(JI_DC, j);
            const int lv = pass == 0 ? sm.cur_f[d]
                                     : (sm.cur_f[d] > 0 ? sm.cur_f[d] - 1 : 0);
            const int fi = I(JI_FIDX, j) < lv ? I(JI_FIDX, j) : lv;
            v = task_power(d * 2 + I(JI_JTYPE, j), sm.freq[fi], I(JI_N, j));
          }
          vals[j] = v;
        }
        bar();
        dc_tree_sums(pass == 0 ? xs->ctl_now : xs->ctl_lo, false);
      }
      if (tid == 0) {
        xs->iters += 1;
        int best = 0;
        float bdp = 0.0f;
        for (int d = 0; d < n_dc; ++d) {
          const float dp = sm.cur_f[d] > 0 ? xs->ctl_now[d] - xs->ctl_lo[d] : 0.0f;
          if (d == 0 || dp > bdp || (isnan(dp) && !isnan(bdp))) {
            bdp = dp;
            best = d;
          }
        }
        const bool ok = bdp > 1e-9f;
        xs->best = ok ? best : -1;
        if (ok) {
          const int nl = sm.cur_f[best] > 0 ? sm.cur_f[best] - 1 : 0;
          xs->newl = nl;
          sm.cur_f[best] = nl;
          sm.dirty[best] = 1;
          xs->deficit = xs->deficit - bdp;
        }
        xs->live = ok && xs->deficit > 1e-6f;
      }
      bar();
      const int b = xs->best;
      if (b >= 0) {  // clamp the DC's running jobs, refresh their physics
        const int nl = xs->newl;
        for (int j = tid; j < J; j += NT) {
          if (I(JI_STATUS, j) != ST_RUNNING || I(JI_DC, j) != b) continue;
          const int fi = I(JI_FIDX, j) < nl ? I(JI_FIDX, j) : nl;
          float spu, watts;
          row_tp(b, I(JI_JTYPE, j), I(JI_N, j), fi, spu, watts);
          I(JI_FIDX, j) = fi;
          F(JF_SPU, j) = spu;
          F(JF_WATTS, j) = watts;
        }
      }
      bar();
    }
    refresh_powers();
  }

  // _cap_greedy: apply the cheapest ladder step k -> k-1 of any running job
  // by rho = dP / dV (first minimum over the job-major [J, n_f - 1] atoms)
  // while the fleet's power exceeds the cap (every thread)
  __device__ void cap_greedy() {
    if (tid == 0) xs->live = xs->total > power_cap;
    bar();
    const int n_at = n_f - 1;
    while (xs->live) {
      if (tid == 0) xs->gmin = ~0ull;
      bar();
      uint32_t bk = 0xffffffffu;
      int bi = 0x7fffffff;
      for (int j = tid; j < J; j += NT) {
        if (I(JI_STATUS, j) != ST_RUNNING) continue;
        const int q = I(JI_DC, j) * 2 + I(JI_JTYPE, j), n = I(JI_N, j);
        const int top = I(JI_FIDX, j) < n_at ? I(JI_FIDX, j) : n_at;
        float p0 = task_power(q, sm.freq[0], n);
        float v0 = 1.0f / step_time(q, sm.freq[0], n);
        for (int k = 1; k <= top; ++k) {
          const float p1 = task_power(q, sm.freq[k], n);
          const float v1 = 1.0f / step_time(q, sm.freq[k], n);
          const float dp = clamp_min(p1 - p0, 0.0f);
          const float dv = clamp_min(v1 - v0, 0.0f);
          if (dv > 0.0f) {
            const float rho = dp / clamp_min(dv, 1e-12f);
            const uint32_t key = order_key(rho);
            if (isfinite(rho) && key < bk) {
              bk = key;
              bi = j * n_at + (k - 1);
            }
          }
          p0 = p1;
          v0 = v1;
        }
      }
      const uint32_t wk = __reduce_min_sync(kAll, bk);
      const int wi = __reduce_min_sync(kAll, bk == wk ? bi : 0x7fffffff);
      if (lane == 0 && wk != 0xffffffffu)
        atomicMin(&xs->gmin, ((unsigned long long)wk << 32) | (unsigned)wi);
      bar();
      if (tid == 0) {
        xs->iters += 1;
        const unsigned long long g = xs->gmin;
        xs->best = -1;
        if (g != ~0ull) {
          const int idx = (int)(unsigned)(g & 0xffffffffu);
          const int j = idx / n_at, tgt = idx % n_at;
          const int dcj = I(JI_DC, j);
          float spu, watts;
          row_tp(dcj, I(JI_JTYPE, j), I(JI_N, j), tgt, spu, watts);
          I(JI_FIDX, j) = tgt;
          F(JF_SPU, j) = spu;
          F(JF_WATTS, j) = watts;
          sm.dirty[dcj] = 1;
          xs->best = j;
        }
      }
      bar();
      if (xs->best < 0) break;
      refresh_powers();
      if (tid == 0) xs->live = dc_total(sm.powers) > power_cap;
      bar();
    }
  }

  // _drain_queues(masked=True, xfer=...): at most k_drain starts; iteration
  // 0 is the xfer start when xfer_j >= 0; stops at the first iteration that
  // starts nothing (every thread calls it, after a barrier; it returns after
  // one, or where no thread has written since the last)
  __device__ void drain(int dcj, bool enabled, int xfer_j) {
    for (int it = 0; it < k_drain; ++it) {
      if (xfer_j >= 0 && it == 0) {
        if (tid == 0) {
          TimeT rec[N_REC];
          rec_from_slab(xfer_j, rec);
          start_from_rec(xfer_j, dcj, I(JI_JTYPE, xfer_j), rec);
        }
        bar();
        continue;
      }
      // nothing to start: the first EMPTY slot is not needed (every thread
      // reads the same rings and counts)
      if (!enabled || !ring_ready(dcj)) return;
      const int fe = first_empty();
      if (tid == 0) {
        bool found;
        const int jt = ring_head(dcj, found);
        const int ok = found && fe < J;
        sm.flag = ok;
        if (ok) {
          start_from_rec(fe, dcj, jt, sm.rec);
          sm.qhead[dcj * 2 + jt] = wadd(sm.qhead[dcj * 2 + jt], 1);
        }
      }
      bar();
      if (!sm.flag) return;
    }
  }

  // ------------------------------------------------ B1a: head + accrual

  __device__ void head(int i) {
    // what thread 0 rewrites below, read by every thread before the barrier
    const TimeT t = sm.t;
    const int done0 = sm.done, started0 = sm.started;
    const TimeT next_log = sm.next_log_t;
    const int p = par;
    par ^= 1;
    // the per-event key split, a child per thread: (key, k_ev) =
    // split(key), or under RL (key, k_ev, k_act) = split(key, 3)
    if (warp == NW - 1 && lane < (rl ? 3 : 2)) {
      uint32_t c0, c1;
      tf::child(sm.k0, sm.k1, (uint32_t)lane, c0, c1);
      sm.kc[2 * lane] = c0;
      sm.kc[2 * lane + 1] = c1;
    }
    // each thread's argmins over its slots (ascending: a tie keeps the
    // first), its first EMPTY slot and the dc_sum input
    int jf = 0x7fffffff, jx = 0x7fffffff, ia = 0x7fffffff, fe = J;
    TimeT bf = CUDART_INF_F, bx = CUDART_INF_F, ba = CUDART_INF_F;
    if constexpr (kD) {
      // the double clock: 64-bit keys, posted a warp at a time
      uint64_t kf = ~0ull, kx = ~0ull, ka = ~0ull;
      for (int j = tid; j < J; j += NT) {
        const int st = I(JI_STATUS, j);
        const bool running = st == ST_RUNNING;
        const float runT = running ? F(JF_SPU, j) : CUDART_INF_F;
        const bool fin_ok = isfinite(runT);
        const float rem = clamp_min(F(JF_SIZE, j) - F(JF_UDONE, j), 0.0f);
        // the float32 product, then the clock's add
        const TimeT tf = fin_ok ? t + (TimeT)fmulp(rem, runT) : (TimeT)CUDART_INF_F;
        const uint64_t k1 = order_key(tf);
        if (k1 < kf) {
          kf = k1;
          jf = j;
          bf = tf;
        }
        const TimeT ta = st == ST_XFER ? TF(JF_TAVAIL, j) : (TimeT)CUDART_INF_F;
        const uint64_t k2 = order_key(ta);
        if (k2 < kx) {
          kx = k2;
          jx = j;
          bx = ta;
        }
        if (st == ST_EMPTY && j < fe) fe = j;
        vals[j] = running ? F(JF_WATTS, j) : 0.0f;
      }
      for (int s = tid; s < 2 * n_ing; s += NT) {
        const TimeT v = sm.next_arr[s];
        const uint64_t k3 = order_key(v);
        if (k3 < ka) {
          ka = k3;
          ia = s;
          ba = v;
        }
      }
      argmin_post64(0, kf, jf, bf);
      argmin_post64(1, kx, jx, bx);
      if (warp * 32 < 2 * n_ing) argmin_post64(2, ka, ia, ba);
    } else {
      uint32_t kf = 0xffffffffu, kx = 0xffffffffu, ka = 0xffffffffu;
      for (int j = tid; j < J; j += NT) {
        const int st = I(JI_STATUS, j);
        const bool running = st == ST_RUNNING;
        const float runT = running ? F(JF_SPU, j) : CUDART_INF_F;
        const bool fin_ok = isfinite(runT);
        const float rem = clamp_min(F(JF_SIZE, j) - F(JF_UDONE, j), 0.0f);
        const float tf = fin_ok ? t + fmulp(rem, runT) : CUDART_INF_F;
        const uint32_t k1 = order_key(tf);
        if (k1 < kf) {
          kf = k1;
          jf = j;
          bf = tf;
        }
        const float ta = st == ST_XFER ? F(JF_TAVAIL, j) : CUDART_INF_F;
        const uint32_t k2 = order_key(ta);
        if (k2 < kx) {
          kx = k2;
          jx = j;
          bx = ta;
        }
        if (st == ST_EMPTY && j < fe) fe = j;
        // the dc_sum input: running jobs' cached watts
        vals[j] = running ? F(JF_WATTS, j) : 0.0f;
      }
      for (int s = tid; s < 2 * n_ing; s += NT) {
        const float v = sm.next_arr[s];
        const uint32_t k3 = order_key(v);
        if (k3 < ka) {
          ka = k3;
          ia = s;
          ba = v;
        }
      }
      argmin_post(&sm.amin[p][0], 0, kf, jf, bf);
      argmin_post(&sm.amin[p][1], 1, kx, jx, bx);
      if (warp * 32 < 2 * n_ing) argmin_post(&sm.amin[p][2], 2, ka, ia, ba);
    }
    fe = __reduce_min_sync(kAll, fe);
    if (lane == 0) atomicMin(&sm.afe[p], fe);
    bar();
    // active power per DC: the tree is a pure function of the running slots
    // of that DC, so only a DC whose running set changed since its last
    // sum (a finish or a start there) is summed again
    dc_tree_sums(sm.active, true);
    if constexpr (kD) {
      const int nw_arr = (2 * n_ing + 31) / 32 < NW ? (2 * n_ing + 31) / 32 : NW;
      jf = argmin_read64(0, NW, bf);
      jx = argmin_read64(1, NW, bx);
      ia = argmin_read64(2, nw_arr, ba);
    } else {
      jf = argmin_index(sm.amin[p][0]);
      jx = argmin_index(sm.amin[p][1]);
      ia = argmin_index(sm.amin[p][2]);
      bf = argmin_value(0, jf);
      bx = argmin_value(1, jx);
      ba = argmin_value(2, ia);
    }
    fe = sm.afe[p];
    // the event choice, on every thread from the values read above
    const TimeT cand[4] = {bf, bx, ba, next_log};
    int kind = 0;
    TimeT tn = cand[0];
    for (int k = 1; k < 4; ++k) {
      if (before(cand[k], k, tn, kind)) {
        tn = cand[k];
        kind = k;
      }
    }
    const bool past_end = (tn > end) || !isfinite(tn) || done0;
    const TimeT t_adv = past_end ? end : tn;
    const TimeT dt = clamp_min(t_adv - t, (TimeT)0);
    // the progress pass's gap (float32 under either clock)
    const float dt_f = (float)dt;
    // the accrual, a DC per thread
    if (tid < n_dc) {
      const int d = tid;
      const bool accrue = started0 && !done0;
      sm.dirty[d] = 0;
      const int idle_n = wsub(sm.total[d], sm.busy[d]);
      const float pw = sm.active[d] + fmulp((float)idle_n, sm.idle_w[d]);
      sm.powers[d] = pw;
      // fmul_pinned in the clock's type (float32 x clock)
      const TimeT e_inc = fmulp((TimeT)pw, dt);
      const TimeT u_inc = fmulp((TimeT)sm.busy[d], dt);
      sm.energy[d] = sm.energy[d] + (accrue ? e_inc : (TimeT)0);
      sm.util[d] = sm.util[d] + (accrue ? u_inc : (TimeT)0);
    }
    if (tid == 0) {
      // the other parity's accumulators, for the next event
      for (int k = 0; k < 3; ++k) sm.amin[p ^ 1][k] = ~0ull;
      sm.afe[p ^ 1] = 0x7fffffff;
      sm.t_first = started0 ? sm.t_first : t_adv;
      sm.t = t_adv;
      sm.dt = dt_f;
      sm.started = 1;
      const int done = done0 || past_end;
      sm.done = done;
      const int branch = done ? EV_NOOP : kind;
      sm.branch = branch;
      sm.k0 = sm.kc[0];
      sm.k1 = sm.kc[1];
      sm.kev0 = sm.kc[2];
      sm.kev1 = sm.kc[3];
      if (rl) {
        sm.ka0 = sm.kc[4];
        sm.ka1 = sm.kc[5];
      }
      em_t[i] = (float)t_adv;
      if (branch != EV_NOOP) em_branch[i] = branch;
      sm.j_fin = jf;
      sm.j_x = jx;
      sm.a_idx = ia;
      sm.has_slot = fe < J;
      sm.slot = fe < J ? fe : 0;
      sm.can = free_for(I(JI_DC, jx), I(JI_JTYPE, jx)) > 0;
    }
    // job progress over the gap (every slot; running ones advance)
    for (int j = tid; j < J; j += NT) {
      const bool running = I(JI_STATUS, j) == ST_RUNNING;
      const float runT = running ? F(JF_SPU, j) : CUDART_INF_F;
      const bool fin_ok = isfinite(runT);
      const float prog = fin_ok ? dt_f / (fin_ok ? runT : 1.0f) : 0.0f;
      F(JF_UDONE, j) = minimum(F(JF_SIZE, j), F(JF_UDONE, j) + prog);
    }
    bar();
  }

  // ------------------------------------------------ B1b: planners + commit

  __device__ void finish(int i) {  // thread 0
    const int j = sm.j_fin;
    const int dcj = I(JI_DC, j), jt = I(JI_JTYPE, j);
    const TimeT t = sm.t;
    const int n = I(JI_N, j);
    const float f_used = sm.freq[I(JI_FIDX, j)];
    const float size_j = F(JF_SIZE, j);
    const float span = (float)tmod(t, li);
    const float acc = span / F(JF_SPU, j);
    const float Tp = F(JF_SPU, j), Pp = F(JF_WATTS, j);
    const float Ep = Tp * Pp;
    const float soj = (float)clamp_min(t - TF(JF_TSTART, j), (TimeT)0);
    float* row = em_job + (long long)i * kJobCols;
    row[0] = (float)I(JI_SEQ, j);
    row[1] = (float)I(JI_INGRESS, j);
    row[2] = (float)jt;
    row[3] = size_j;
    row[4] = (float)dcj;
    row[5] = f_used;
    row[6] = (float)n;
    row[7] = F(JF_NETLAT, j);
    row[8] = (float)TF(JF_TSTART, j);
    row[9] = (float)t;
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
    sm.p99_ok[jt] = 0;
    sm.lat_count[jt] = wadd(sm.lat_count[jt], 1);
    sm.lat_ptr[jt] = iremainder(wadd(sm.lat_ptr[jt], 1), W);
    sm.n_fin[jt] = wadd(sm.n_fin[jt], 1);
    sm.units_fin[jt] = sm.units_fin[jt] + size_j;
    if (rl) rl_valid[j] = 0;
    if (kExt && adm == ADM_BANDIT) {  // the finished arm's reward
      const int a = (dcj * 2 + jt) * n_f + I(JI_FIDX, j);
      band_n[a] = wadd(band_n[a], 1);
      band_s[a] = band_s[a] - Ep;
    }
  }

  __device__ void arrival() {  // thread 0
    const int s = sm.a_idx;  // stream = ingress * 2 + jtype
    const int ing = s >> 1, jt = s & 1;
    const TimeT t = sm.t;
    int idx = wsub(sm.arr_count[s], sm.c0[s]);
    if (idx > n_tab - 1) idx = n_tab - 1;
    if (idx < 0) idx = 0;
    const float size = sizes[(long long)s * n_tab + idx];
    const TimeT t_next_arr = tnext[(long long)s * n_tab + idx];
    const int dc_sel = (kExt && route != RT_RANDOM)
                           ? route_det(ing, jt, size)
                           : tf::randint(sm.kev0, sm.kev1, n_dc);
    const float xfer_s = transfer[(ing * n_dc + dc_sel) * 2 + jt];
    const float nl = netlat[ing * n_dc + dc_sel];
    const TimeT t_avail = t + (TimeT)xfer_s;
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
      TF(JF_TING, j) = t;
      TF(JF_TAVAIL, j) = t_avail;
      TF(JF_TSTART, j) = 0.0f;
      F(JF_NETLAT, j) = nl;
      I(JI_PCOUNT, j) = 0;
      TF(JF_PT, j) = 0.0f;
      F(JF_TPT, j) = 0.0f;
    } else {
      TimeT rec[N_REC];
      for (int k = 0; k < N_REC; ++k) rec[k] = 0.0f;
      rec[R_SIZE] = size;
      rec[R_SEQ] = (TimeT)jid;
      rec[R_INGRESS] = (TimeT)ing;
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
    if constexpr (kExt) {
      if (cap != CAP_NONE) control();
    }
    for (int j = tid; j < J; j += NT) {
      const bool running = I(JI_STATUS, j) == ST_RUNNING;
      const float tpt = running ? 1.0f / F(JF_SPU, j) : 0.0f;
      vals[j] = fmulp(tpt, (float)li);
    }
    if (tid < n_dc) {
      sm.run_tot[tid] = 0;
      sm.run_inf[tid] = 0;
    }
    bar();
    dc_tree_sums(sm.red, false);
    // running jobs per DC: a warp's counts, then the warps' added (integers:
    // any order)
    for (int d = 0; d < n_dc; ++d) {
      int c_tot = 0, c_inf = 0;
      for (int j = tid; j < J; j += NT) {
        if (I(JI_DC, j) == d && I(JI_STATUS, j) == ST_RUNNING) {
          ++c_tot;
          if (I(JI_JTYPE, j) == 0) ++c_inf;
        }
      }
      c_tot = __reduce_add_sync(kAll, c_tot);
      c_inf = __reduce_add_sync(kAll, c_inf);
      if (lane == 0 && c_tot > 0) {
        atomicAdd(&sm.run_tot[d], c_tot);
        atomicAdd(&sm.run_inf[d], c_inf);
      }
    }
    bar();
    // a DC's cluster row per thread
    if (tid < n_dc) {
      const int d = tid;
      const TimeT t = sm.t;
      const TimeT elapsed = clamp_min(t - sm.t_first, kD ? (TimeT)1e-9 : (TimeT)1e-9f);
      // XLA's reciprocal for `/ 1000.0`, in the clock's type
      const TimeT inv_1000 = (TimeT)1 / (TimeT)1000;
      sm.acc[d] = sm.acc[d] + sm.red[d];
      const int busy = sm.busy[d], total = sm.total[d];
      float* row = em_cluster + ((long long)i * n_dc + d) * kClusterCols;
      row[0] = (float)t;
      row[1] = sm.freq[sm.cur_f[d]];
      row[2] = (float)busy;
      row[3] = (float)wsub(total, busy);
      row[4] = (float)sm.run_tot[d];
      row[5] = (float)sm.run_inf[d];
      row[6] = (float)wsub(sm.run_tot[d], sm.run_inf[d]);
      row[7] = (float)wsub(sm.qtail[2 * d], sm.qhead[2 * d]);
      row[8] = (float)wsub(sm.qtail[2 * d + 1], sm.qhead[2 * d + 1]);
      row[9] = (float)busy * sm.inv_total[d];
      row[10] = (float)(sm.util[d] / ((TimeT)total * elapsed));
      row[11] = sm.acc[d];
      row[12] = sm.powers[d];
      row[13] = (float)(sm.energy[d] * inv_1000);
    }
    if (tid == 0) sm.next_log_t = sm.next_log_t + li;
    bar();
  }

  // ------------------------------------------------ one event

  // Every branch ends with a barrier after its last shared write (or writes
  // nothing after the head's), so the next head reads a settled state.
  __device__ void step(int i) {
    head(i);
    const int branch = sm.branch;
    if (branch == EV_NOOP) return;
    if (branch == EV_FINISH) {
      if (tid == 0) finish(i);
      bar();
      drain(I(JI_DC, sm.j_fin), true, -1);
    } else if (branch == EV_XFER) {
      const int j = sm.j_x;
      const int dcj = I(JI_DC, j), jt = I(JI_JTYPE, j);
      if (!sm.can) {  // queue-on-full: evict the row into the ring
        if (tid == 0) {
          TimeT rec[N_REC];
          rec_from_slab(j, rec);
          I(JI_STATUS, j) = ST_EMPTY;
          ring_push(dcj, jt, rec);
        }
        bar();
      } else {  // iteration 0 of the shared drain is the xfer start
        drain(dcj, false, j);
      }
    } else if (branch == EV_ARRIVAL) {
      if (tid == 0) arrival();
      bar();
    } else if (branch == EV_LOG) {
      log_tick(i);
    }
    if (tid == 0) sm.n_events = wadd(sm.n_events, 1);
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
  // argmin at that n (thread 0)
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
  // stamp the start / close a preemption wait (thread 0)
  __device__ void start_req(int j, int dcj, int jt, int n_d, int f_d,
                            int new_f, TimeT t_start0, TimeT pt0,
                            float tpt0) {
    const int fr = free_for(dcj, jt);
    const int m = n_d < fr ? n_d : fr;
    const int n_st = m > 1 ? m : 1;
    float spu, watts;
    row_tp(dcj, jt, n_st, f_d, spu, watts);
    const TimeT t = sm.t;
    I(JI_STATUS, j) = ST_RUNNING;
    I(JI_N, j) = n_st;
    I(JI_FIDX, j) = f_d;
    TF(JF_TSTART, j) = t_start0 <= 0.0f ? t : t_start0;
    TF(JF_PT, j) = 0.0f;
    F(JF_TPT, j) = tpt0 + (pt0 > 0.0f ? (float)(t - pt0) : 0.0f);
    F(JF_SPU, j) = spu;
    F(JF_WATTS, j) = watts;
    sm.busy[dcj] = wadd(sm.busy[dcj], n_st);
    sm.cur_f[dcj] = new_f;
    sm.dirty[dcj] = 1;
  }

  // the finish branch's partial transition (`_plan_finish`'s chsac record),
  // read before the commit retires the row (every thread; the scalars on
  // thread 0)
  __device__ void fin_record(int i) {
    const int j = sm.j_fin;
    for (int k = tid; k < obs_dim; k += NT)
      e_s0[(long long)i * obs_dim + k] = rl_obs0[(long long)j * obs_dim + k];
    for (int d = tid; d < n_dc; d += NT)
      e_mdc0[(long long)i * n_dc + d] = rl_mdc0[(long long)j * n_dc + d];
    for (int g = tid; g < n_g; g += NT)
      e_mg0[(long long)i * n_g + g] = rl_mg0[(long long)j * n_g + g];
    if (tid == 0) {
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
      sm.fin_soj = (float)clamp_min(sm.t - TF(JF_TSTART, j), (TimeT)0);
      sm.fin_over = (float)(over > 0 ? over : 0);
    }
  }

  // chsac arrival planner: the pregenerated draw, no routing (the tail
  // routes), the XFER placeholder row (DC 0, t_avail inf) or a drop
  // (thread 0)
  __device__ void arrival_rl() {
    const int s = sm.a_idx;
    const int ing = s >> 1, jt = s & 1;
    int idx = wsub(sm.arr_count[s], sm.c0[s]);
    if (idx > n_tab - 1) idx = n_tab - 1;
    if (idx < 0) idx = 0;
    const float size = sizes[(long long)s * n_tab + idx];
    const TimeT t_next_arr = tnext[(long long)s * n_tab + idx];
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
      TF(JF_TING, j) = sm.t;
      TF(JF_TAVAIL, j) = CUDART_INF_F;
      TF(JF_TSTART, j) = 0.0f;
      F(JF_NETLAT, j) = 0.0f;
      I(JI_PCOUNT, j) = 0;
      TF(JF_PT, j) = 0.0f;
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
  // busy/total, free/total, f, log1p(q_inf)/4, log1p(q_trn)/4] (every
  // thread)
  __device__ void build_obs() {
    const float inv7 = 1.0f / 7.0f;
    // the day's reciprocal in the clock's type (XLA's `/ 86400.0`)
    const TimeT inv_day = (TimeT)1 / (TimeT)86400;
    for (int k = tid; k < obs_dim; k += NT) {
      float v;
      if (k == 0) {
        v = (float)(tmod(sm.t, (TimeT)86400) * inv_day);
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

  // the RL trace of slot j <- this step's (obs, action, masks) (every
  // thread)
  __device__ void write_trace(int j) {
    for (int k = tid; k < obs_dim; k += NT)
      rl_obs0[(long long)j * obs_dim + k] = obs[k];
    for (int d = tid; d < n_dc; d += NT)
      rl_mdc0[(long long)j * n_dc + d] = (uint8_t)sm.mdc[d];
    for (int g = tid; g < n_g; g += NT)
      rl_mg0[(long long)j * n_g + g] = (uint8_t)sm.mg[g];
    if (tid == 0) {
      rl_adc[j] = sm.a_dc;
      rl_ag[j] = sm.a_g;
      rl_valid[j] = 1;
    }
  }

  // the policy tail (`_tail_head` + `_policy_tail_planned` + `_commit_tail`);
  // every thread calls it after a barrier; it ends with one
  __device__ void tail(int i) {
    const int req = sm.req_kind, req_idx = sm.req_idx;
    // B3: the p99 of a window whose contents changed since its last p99
    const bool stale[2] = {!sm.p99_ok[0], !sm.p99_ok[1]};
    if (stale[0] || stale[1]) {
      const float* bufs[2] = {lat_buf, lat_buf + W};
      const int counts[2] = {sm.lat_count[0], sm.lat_count[1]};
      rlk::windowed_p99<NT>(bufs, counts, stale, W, K, sm.p99, p99s, tid);
      if (tid < 2) sm.p99_ok[tid] = 1;
    }
    // the running power of DCs whose running set changed (for P_now)
    for (int j = tid; j < J; j += NT)
      vals[j] = I(JI_STATUS, j) == ST_RUNNING ? F(JF_WATTS, j) : 0.0f;
    bar();
    dc_tree_sums(sm.active, true);
    build_obs();
    bar();
    if (tid == 0) {
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
      sm.g_cap = slack ? cap1 : max_free;  // count g + 1 feasible up to it
      // costs: [p99 ms, P_now, gpu_over, energy]
      const int jf = sm.fin_jt, df = sm.fin_dcj;
      const float p99_ms = sm.lat_count[jf] >= 5 ? sm.p99[jf] * 1000.0f
                                                : sm.fin_soj * 1000.0f;
      const float p_now =
          sm.active[df] +
          fmulp((float)wsub(sm.total[df], sm.busy[df]), sm.idle_w[df]);
      TimeT e_sum = sm.energy[0];
      for (int d = 1; d < n_dc; ++d) e_sum = e_sum + sm.energy[d];
      float* c = e_costs + (long long)i * 4;
      c[0] = p99_ms;
      c[1] = p_now;
      c[2] = sm.fin_over;
      c[3] = (float)e_sum;
    }
    bar();
    for (int k = tid; k < obs_dim; k += NT)
      e_s1[(long long)i * obs_dim + k] = obs[k];
    for (int d = tid; d < n_dc; d += NT)
      e_mdc[(long long)i * n_dc + d] = (uint8_t)sm.mdc[d];
    for (int g = tid; g < n_g; g += NT) {
      const int on = g + 1 <= sm.g_cap;
      sm.mg[g] = on;
      e_mg[(long long)i * n_g + g] = (uint8_t)on;
    }
    if (req == REQ_NONE) {
      // the xfer branch's start rides this commit
      if (tid == 0 && sm.st_on)
        start_req(sm.st_j, sm.st_dcj, sm.st_jt, sm.st_n, sm.st_f, sm.st_newf,
                  sm.st_t0, sm.st_pt0, sm.st_tpt0);
      bar();
      return;
    }
    // B4: one forward and the two samples (only when the action is used)
    rlk::forward<NT>(*pol, *slice, wsm, obs, act0, act1, logit, cmd, cs, tid);
    rlk::sample_heads<NT, kWide>(logit, sm.mdc, n_dc, sm.mg, n_g, nullptr,
                                 sm.ka0, sm.ka1, pol->greedy, &sm.a_dc,
                                 &sm.a_g, tid);
    bar();
    const int a_dc = sm.a_dc;
    if (req == REQ_ROUTE) {
      const int slot = req_idx;
      if (tid == 0) {
        const int jt_s = I(JI_JTYPE, slot), ing_s = I(JI_INGRESS, slot);
        I(JI_DC, slot) = a_dc;
        TF(JF_TAVAIL, slot) =
            sm.t + (TimeT)transfer[(ing_s * n_dc + a_dc) * 2 + jt_s];
        F(JF_NETLAT, slot) = netlat[ing_s * n_dc + a_dc];
      }
      write_trace(slot);
      bar();
      return;
    }
    // REQ_DRAIN: the finishing DC's ring head, re-materialized into the
    // slot the finish freed and started where the policy sends it
    if (tid == 0) {
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
        const TimeT* rec = sm.rec;
        I(JI_JTYPE, slot) = jt_sel;
        I(JI_INGRESS, slot) = (int)rec[R_INGRESS];
        I(JI_DC, slot) = a_dc;
        I(JI_SEQ, slot) = (int)rec[R_SEQ];
        F(JF_SIZE, slot) = (float)rec[R_SIZE];
        F(JF_UDONE, slot) = (float)rec[R_UNITS_DONE];
        TF(JF_TING, slot) = rec[R_T_INGRESS];
        TF(JF_TAVAIL, slot) = rec[R_T_AVAIL];
        F(JF_NETLAT, slot) = (float)rec[R_NET_LAT];
        I(JI_PCOUNT, slot) = (int)rec[R_PREEMPT_COUNT];
        start_req(slot, a_dc, jt_sel, n, f, sm.cur_f[a_dc], rec[R_T_START],
                  rec[R_PREEMPT_T], (float)rec[R_TOTAL_PREEMPT]);
        sm.qhead[dcj * 2 + jt_sel] = wadd(sm.qhead[dcj * 2 + jt_sel], 1);
      }
    }
    bar();
    if (sm.flag) write_trace(sm.fin_slot);
    bar();
  }

  // one chsac_af event: the branches defer routing and the post-finish
  // drain to the policy tail
  __device__ void step_rl(int i) {
    head(i);
    const int branch = sm.branch;
    // thread 0 resets the step's request, then runs its branch's scalar
    // part; the tail reads both after its first barrier
    if (tid == 0) {
      sm.req_kind = REQ_NONE;
      sm.req_idx = 0;
      sm.fin_jt = 0;
      sm.fin_dcj = 0;
      sm.fin_slot = 0;
      sm.fin_soj = 0.0f;
      sm.fin_over = 0.0f;
      sm.st_on = 0;
    }
    if (branch == EV_FINISH) {
      fin_record(i);
      if (tid == 0) {
        finish(i);
        sm.req_kind = REQ_DRAIN;
        sm.req_idx = sm.fin_dcj;
      }
      bar();
    } else if (branch == EV_XFER) {
      if (tid == 0) {
        const int j = sm.j_x;
        const int dcj = I(JI_DC, j), jt = I(JI_JTYPE, j);
        if (!sm.can) {  // queue-on-full: evict the row into the ring
          TimeT rec[N_REC];
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
          sm.st_t0 = TF(JF_TSTART, j);
          sm.st_pt0 = TF(JF_PT, j);
          sm.st_tpt0 = F(JF_TPT, j);
        }
      }
      bar();
    } else if (branch == EV_ARRIVAL) {
      if (tid == 0) arrival_rl();
      bar();
    } else if (branch == EV_LOG) {
      log_tick(i);
    } else {  // the run's end: the tail reads the reset request
      bar();
    }
    tail(i);
    if (tid == 0 && branch != EV_NOOP) sm.n_events = wadd(sm.n_events, 1);
  }

  // a step after the end: the same record as the step that reached it
  __device__ void copy_record(int src, int dst) {
    for (int k = tid; k < obs_dim; k += NT)
      e_s1[(long long)dst * obs_dim + k] = e_s1[(long long)src * obs_dim + k];
    for (int d = tid; d < n_dc; d += NT)
      e_mdc[(long long)dst * n_dc + d] = e_mdc[(long long)src * n_dc + d];
    for (int g = tid; g < n_g; g += NT)
      e_mg[(long long)dst * n_g + g] = e_mg[(long long)src * n_g + g];
    if (tid < 4) e_costs[(long long)dst * 4 + tid] = e_costs[(long long)src * 4 + tid];
  }

  int n_ing;
};

}  // namespace

namespace {

// kRL: chsac_af's RL mode.  A separate instantiation, so the heuristic
// kernel carries none of the RL code's registers or stack; NT: the block's
// threads (the wrapper's choice, one of kernel_of's below); kWide: RL mode
// with more than 32 GPU-count actions; kExt: the extended heuristic
// instance (`Lane`); TimeT: the clock's type (this build's `Clock`).
template <bool kRL, int NT, bool kWide, bool kExt, typename TimeT>
__global__ void __launch_bounds__(NT)
    event_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ SmallT<TimeT> sm;
  __shared__ typename ExtOf<kExt>::T xs_sm;
  __shared__ rlk::Policy pol;
  __shared__ rlk::Slice slice;
  const int tid = threadIdx.x;
  // RL mode: a cluster of cs blocks per lane; block 0 runs the lane, the
  // others hold their slices of the policy's weights and serve its forwards
  const int cs = kRL ? a.i[I_CLUSTER] : 1;
  const int r = blockIdx.x / cs;
  const int J = a.i[I_J], P = a.i[I_P], n_dc = a.i[I_NDC];
  const int n_ing = a.i[I_NING], S = 2 * n_ing, n_f = a.i[I_NF];
  const int Q = a.i[I_Q], W = a.i[I_W], n_tab = a.i[I_NTAB];
  const int n_steps = a.i[I_NSTEPS], n_cap = a.i[I_NCAP];
  Lane<NT, kWide, kExt, TimeT> L{sm};
  constexpr bool kD = sizeof(TimeT) == 8;
  L.tid = tid;
  L.lane = tid & 31;
  L.warp = tid >> 5;
  L.par = 0;
  L.n_sum = a.i[I_SUM_WARPS];
  float* base = dyn;  // the slab, after the cluster's rows in RL mode
  if constexpr (kRL) {
    namespace cg = cooperative_groups;
    const int rank = (int)cg::this_cluster().block_rank();
    if (tid == 0) {
      rlk::policy_from(pol, a.p + P_W0, a.i);
      rlk::plan_slice(pol, cs, a.i[I_LEAD], rank, slice);
    }
    __syncthreads();
    // every block: the activation rows, the logits and the command word at
    // the same offsets, then its weight slice; in block 0 the slab after
    // its own slice (none without `lead`)
    L.act0 = dyn;
    L.act1 = L.act0 + kActLen;
    L.logit = L.act1 + kActLen;
    const int n_logit = logit_len(a.i[I_MAXGPU]);
    L.cmd = reinterpret_cast<int*>(L.logit + n_logit);
    uint16_t* wsm = reinterpret_cast<uint16_t*>(L.logit + n_logit + 4);
    base = rlk::slice_biases(wsm, slice) + (slice.belems + 3) / 4 * 4;
    rlk::load_slice<NT>(pol, slice, wsm, tid);
    if (tid == 0) *L.cmd = 0;
    cg::this_cluster().sync();
    if (rank != 0) {
      rlk::serve_forwards<NT>(pol, slice, wsm, L.act0, L.act1, L.logit, L.cmd,
                              cs, tid);
      return;
    }
    L.pol = &pol;
    L.slice = &slice;
    L.wsm = wsm;
    L.cs = cs;
  }
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
#ifdef DCG_CLOCK64
  L.end = a.d[D_END];
  L.li = a.d[D_LOG_INTERVAL];
#else
  L.end = a.f[F_END];
  L.li = a.f[F_LOG_INTERVAL];
#endif
  L.n_ing = n_ing;
  L.si = reinterpret_cast<int*>(base);
  L.sf = base + N_JI * J;
  L.vals = base + (N_JI + N_JF) * J;
  L.scr = L.vals + P;
  L.red_v = L.scr + (P > 32 * kRegSlots ? L.n_sum * P : 0);
  L.red_i = reinterpret_cast<int*>(L.red_v + kRed / 2);
  L.recs = lane_ptr<TimeT>(a, P_Q_RECS, (long long)n_dc * 2 * Q * N_REC, r);
  L.lat_buf = lane_ptr<float>(a, P_LAT_BUF, 2LL * W, r);
  L.em_t = lane_ptr<float>(a, P_EM_T, n_steps, r);
  L.em_branch = lane_ptr<int>(a, P_EM_BRANCH, n_steps, r);
  L.em_cluster = lane_ptr<float>(a, P_EM_CLUSTER,
                                 (long long)n_steps * n_dc * kClusterCols, r);
  L.em_job = lane_ptr<float>(a, P_EM_JOB, (long long)n_steps * kJobCols, r);
  L.sizes = lane_ptr<const float>(a, P_SIZES, (long long)S * n_tab, r);
  L.tnext = lane_ptr<const TimeT>(a, P_TNEXT, (long long)S * n_tab, r);
  L.transfer = reinterpret_cast<const float*>(a.p[P_TRANSFER]);
  L.netlat = reinterpret_cast<const float*>(a.p[P_NETLAT]);
  L.egrid = reinterpret_cast<const float*>(a.p[P_EGRID]);
  L.n_cap = n_cap;
  long long t_launch = 0;
  if constexpr (kExt) {
    L.xs = &xs_sm;
    L.adm = a.i[I_ADM];
    L.route = a.i[I_ROUTE];
    L.eco_obj = a.i[I_ECO_OBJ];
    L.cap = a.i[I_CAP];
    L.power_cap = a.f[F_POWER_CAP];
    L.cap_thr = a.f[F_CAP_THR];
    L.w_lat = a.f[F_W_LAT];
    L.w_e = a.f[F_W_E];
    L.w_c = a.f[F_W_C];
    L.w_cost = a.f[F_W_COST];
    L.w_q = a.f[F_W_Q];
    L.price = reinterpret_cast<const float*>(a.p[P_PRICE]);
    L.carbon = reinterpret_cast<const float*>(a.p[P_CARBON]);
    L.band_n = lane_ptr<int>(a, P_BAND_N, (long long)n_dc * 2 * n_f, r);
    L.band_s = lane_ptr<float>(a, P_BAND_S, (long long)n_dc * 2 * n_f, r);
    L.band_t = lane_ptr<int>(a, P_BAND_T, 1, r);
    if (tid == 0) {
      t_launch = clock64();
      xs_sm.cc_hour = -1;
      xs_sm.eco_key = -1;
      xs_sm.ticks = xs_sm.iters = xs_sm.cycles = 0;
    }
  }
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
    // RL scratch after the block-reduction words: the latency windows and
    // the observation (the heads' log-probabilities are not kept).  B3's
    // lane maxima and lists use the activation rows, which only a forward
    // writes (never during B3)
    static_assert(2 * kMaxWarps * 32 <= kActLen && 2 * kCand <= kActLen,
                  "B3's scratch fits in an activation row");
    L.lat_buf = L.red_v + kRed;
    L.obs = L.lat_buf + 2 * W;
    L.p99s.lmax = L.act0;
    L.p99s.cand = L.act1;
    L.p99s.tau = sm.tau;
    L.p99s.n_cand = sm.n_cand;
    L.p99s.s_bits = sm.s_bits;
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
    for (int k = tid; k < 2 * W; k += NT) L.lat_buf[k] = lat_global[k];
  }
  if constexpr (kD) {
    // the time columns and the warps' argmins after the float slab (8-byte
    // aligned; event_scan_smem_bytes counts them)
    float* end_f = kRL ? L.obs + kMaxObs : L.red_v + kRed;
    const uintptr_t at = (reinterpret_cast<uintptr_t>(end_f) + 7) & ~(uintptr_t)7;
    L.sd = reinterpret_cast<TimeT*>(at);
    L.wkey = reinterpret_cast<unsigned long long*>(L.sd + 4LL * J);
    L.wval = reinterpret_cast<double*>(L.wkey + 3 * kMaxWarps);
    L.widx = reinterpret_cast<int*>(L.wval + 3 * kMaxWarps);
  }

  // ---- load: the slab into shared memory, lane state into `sm`
  for (int f = 0; f < 18; ++f) {
    if (kD && kJobTime[f] >= 0) {
      const TimeT* src = lane_ptr<const TimeT>(a, P_JOBS + f, J, r);
      TimeT* dst = L.sd + kJobTime[f] * J;
      for (int j = tid; j < J; j += NT) dst[j] = src[j];
      continue;
    }
    const int* src = lane_ptr<const int>(a, P_JOBS + f, J, r);
    int* dst = kJobIsF[f] ? reinterpret_cast<int*>(L.sf) + kJobCol[f] * J
                          : L.si + kJobCol[f] * J;
    for (int j = tid; j < J; j += NT) dst[j] = src[j];
  }
  for (int d = tid; d < n_dc; d += NT) {
    sm.dirty[d] = 1;
    sm.busy[d] = lane_ptr<int>(a, P_BUSY, n_dc, r)[d];
    sm.cur_f[d] = lane_ptr<int>(a, P_CUR_F, n_dc, r)[d];
    sm.energy[d] = lane_ptr<TimeT>(a, P_ENERGY, n_dc, r)[d];
    sm.util[d] = lane_ptr<TimeT>(a, P_UTIL, n_dc, r)[d];
    sm.acc[d] = lane_ptr<float>(a, P_ACC, n_dc, r)[d];
    const int tot = reinterpret_cast<const int*>(a.p[P_TOTAL])[d];
    sm.total[d] = tot;
    sm.idle_w[d] = reinterpret_cast<const float*>(a.p[P_IDLE_W])[d];
    sm.inv_total[d] = 1.0f / (float)(tot > 1 ? tot : 1);
  }
  for (int q = tid; q < 2 * n_dc; q += NT) {
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
    if constexpr (kExt) {
      if (L.adm == ADM_TABLE && !L.algo_jnf) {
        // debug: the fixed GPU count, and the fixed ladder index or the
        // first energy minimum of the UNcapped grid's row
        sm.jnf_n[q] = a.i[I_NUM_FIXED];
        int fi = a.i[I_FIXED_F];
        if (fi < 0) {
          const float* row = reinterpret_cast<const float*>(a.p[P_EGRID_FULL]) +
                             ((long long)q * a.i[I_NMAX] + a.i[I_DEBUG_ROW]) * n_f;
          float rv = row[0];
          fi = 0;
          for (int k = 1; k < n_f; ++k)
            if (before(row[k], k, rv, fi)) {
              rv = row[k];
              fi = k;
            }
        }
        sm.jnf_f[q] = fi;
      }
      if (L.route == RT_WEIGHTED) {  // each (dc, jtype)'s least energy
        float m = eg[0];
        for (int k = 1; k < n_cap * n_f; ++k) m = fminf(m, eg[k]);
        xs_sm.eco_e[q] = m;
      }
    }
  }
  for (int k = tid; k < n_f; k += NT)
    sm.freq[k] = reinterpret_cast<const float*>(a.p[P_FREQ])[k];
  for (int s = tid; s < S; s += NT) {
    sm.next_arr[s] = lane_ptr<TimeT>(a, P_NEXT_ARR, S, r)[s];
    sm.arr_count[s] = lane_ptr<int>(a, P_ARR_COUNT, S, r)[s];
    sm.c0[s] = lane_ptr<int>(a, P_C0, S, r)[s];
  }
  if (tid == 0) {
    sm.t = lane_ptr<TimeT>(a, P_T, 1, r)[0];
    const int64_t* key = lane_ptr<int64_t>(a, P_KEY, 2, r);
    sm.k0 = (uint32_t)key[0];
    sm.k1 = (uint32_t)key[1];
    sm.jid = lane_ptr<int>(a, P_JID, 1, r)[0];
    sm.started = lane_ptr<uint8_t>(a, P_STARTED, 1, r)[0] != 0;
    sm.t_first = lane_ptr<TimeT>(a, P_T_FIRST, 1, r)[0];
    sm.next_log_t = lane_ptr<TimeT>(a, P_NEXT_LOG, 1, r)[0];
    sm.n_events = lane_ptr<int>(a, P_N_EVENTS, 1, r)[0];
    sm.n_dropped = lane_ptr<int>(a, P_N_DROP, 1, r)[0];
    sm.done = lane_ptr<uint8_t>(a, P_DONE, 1, r)[0] != 0;
    for (int k = 0; k < 2; ++k) {
      sm.n_fin[k] = lane_ptr<int>(a, P_N_FIN, 2, r)[k];
      sm.units_fin[k] = lane_ptr<float>(a, P_UNITS_FIN, 2, r)[k];
      sm.lat_count[k] = lane_ptr<int>(a, P_LAT_COUNT, 2, r)[k];
      sm.lat_ptr[k] = lane_ptr<int>(a, P_LAT_PTR, 2, r)[k];
      sm.p99_ok[k] = 0;
      sm.afe[k] = 0x7fffffff;
      for (int q = 0; q < 3; ++q) sm.amin[k][q] = ~0ull;
    }
  }
  L.bar();

  // ---- the chunk
  int rec_row = -1;  // RL: the step whose record every later step repeats
  for (int i = 0; i < n_steps; ++i) {
    if (sm.done) {  // after the end each step only advances the key
      if (tid == 0) {
        uint32_t n0, n1;
        tf::child(sm.k0, sm.k1, 0u, n0, n1);
        sm.k0 = n0;
        sm.k1 = n1;
        L.em_t[i] = (float)sm.t;
      }
      if constexpr (kRL) {  // and, under RL, emits the final state's record
        if (rec_row < 0) {
          if (tid == 0) {
            sm.req_kind = REQ_NONE;
            sm.fin_jt = sm.fin_dcj = sm.fin_slot = 0;
            sm.fin_soj = sm.fin_over = 0.0f;
            sm.st_on = 0;
          }
          L.bar();
          L.tail(i);
          rec_row = i;
        } else {
          L.copy_record(rec_row, i);
        }
      }
      continue;
    }
    if constexpr (kRL) {
      L.step_rl(i);
      if (sm.done) rec_row = i;
    } else {
      L.step(i);
    }
  }
  L.bar();
  if constexpr (kRL) rlk::release_cluster<NT>(L.cmd, cs, tid);

  // ---- write back
  for (int f = 0; f < 18; ++f) {
    if (kD && kJobTime[f] >= 0) {
      TimeT* dst = lane_ptr<TimeT>(a, P_JOBS + f, J, r);
      const TimeT* src = L.sd + kJobTime[f] * J;
      for (int j = tid; j < J; j += NT) dst[j] = src[j];
      continue;
    }
    int* dst = lane_ptr<int>(a, P_JOBS + f, J, r);
    const int* src = kJobIsF[f]
                         ? reinterpret_cast<const int*>(L.sf) + kJobCol[f] * J
                         : L.si + kJobCol[f] * J;
    for (int j = tid; j < J; j += NT) dst[j] = src[j];
  }
  for (int d = tid; d < n_dc; d += NT) {
    lane_ptr<int>(a, P_BUSY, n_dc, r)[d] = sm.busy[d];
    lane_ptr<int>(a, P_CUR_F, n_dc, r)[d] = sm.cur_f[d];
    lane_ptr<TimeT>(a, P_ENERGY, n_dc, r)[d] = sm.energy[d];
    lane_ptr<TimeT>(a, P_UTIL, n_dc, r)[d] = sm.util[d];
    lane_ptr<float>(a, P_ACC, n_dc, r)[d] = sm.acc[d];
  }
  for (int q = tid; q < 2 * n_dc; q += NT) {
    lane_ptr<int>(a, P_Q_HEAD, 2 * n_dc, r)[q] = sm.qhead[q];
    lane_ptr<int>(a, P_Q_TAIL, 2 * n_dc, r)[q] = sm.qtail[q];
  }
  for (int s = tid; s < S; s += NT) {
    lane_ptr<TimeT>(a, P_NEXT_ARR, S, r)[s] = sm.next_arr[s];
    lane_ptr<int>(a, P_ARR_COUNT, S, r)[s] = sm.arr_count[s];
  }
  if constexpr (kRL)
    for (int k = tid; k < 2 * W; k += NT) lat_global[k] = L.lat_buf[k];
  if constexpr (kExt) {
    if (tid == 0 && a.p[P_CTL] != nullptr) {
      long long* ctl = lane_ptr<long long>(a, P_CTL, 4, r);
      ctl[0] = xs_sm.ticks;
      ctl[1] = xs_sm.iters;
      ctl[2] = xs_sm.cycles;
      ctl[3] = clock64() - t_launch;
    }
  }
  if (tid == 0) {
    lane_ptr<TimeT>(a, P_T, 1, r)[0] = sm.t;
    int64_t* key = lane_ptr<int64_t>(a, P_KEY, 2, r);
    key[0] = (int64_t)sm.k0;
    key[1] = (int64_t)sm.k1;
    lane_ptr<int>(a, P_JID, 1, r)[0] = sm.jid;
    lane_ptr<uint8_t>(a, P_STARTED, 1, r)[0] = sm.started ? 1 : 0;
    lane_ptr<TimeT>(a, P_T_FIRST, 1, r)[0] = sm.t_first;
    lane_ptr<TimeT>(a, P_NEXT_LOG, 1, r)[0] = sm.next_log_t;
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
// widths up to kMaxWidth, heads of n_dc <= 32 and n_g >= 1 actions with
// n_dc + n_g <= kMaxHeads, K >= 1, weights.
bool policy_ok(const Args& a) {
  const int obs_dim = a.i[I_OBS_DIM];
  if (obs_dim < 5 || obs_dim > kMaxObs || a.i[I_PERC_K] < 1) return false;
  if (a.i[I_NDC] > kMaxDC || a.i[I_MAXGPU] < 1 ||
      a.i[I_NDC] + a.i[I_MAXGPU] > kMaxHeads)
    return false;
  const int w[4] = {a.i[I_WH0], a.i[I_WH1], a.i[I_WLAT], a.i[I_WAH]};
  for (int k = 0; k < 4; ++k)
    if (w[k] < 5 || w[k] > kMaxWidth) return false;
  for (int k = 0; k < 2 * kNLayers; ++k)
    if (a.p[P_W0 + k] == nullptr) return false;
  return true;
}

#ifndef DCG_CLOCK64
// ---------------------------------------------------------------- standalone
// B3 and B4 over a batch through the same device functions (chip_smoke.py
// holds them against their plain versions; the main path never calls it).
// Block b (NT threads): the p99 of ring b (b < B) and the policy on row b
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

template <int NT, bool kWide>
__global__ void __launch_bounds__(NT) rl_tail_batch_kernel(const TailArgs a) {
  namespace cg = cooperative_groups;
  // the cluster's rows, as in the event scan: the activation rows, the
  // logits and the command word, then the weight slice
  extern __shared__ __align__(16) float dyn[];
  __shared__ rlk::Policy P;
  __shared__ rlk::Slice slice;
  __shared__ float obs[kMaxObs], logp[kLogitLen], p99[2];
  __shared__ float lmax[2 * NT], cand[2 * kCand], tau[2];
  __shared__ int mdc[kMaxDC], mg[kMaxHeads], n_cand[2], s_bits[4];
  __shared__ int acts[2];
  const int cs = a.i[I_CLUSTER];
  const int b = blockIdx.x / cs, tid = threadIdx.x;
  const int rank = (int)cg::this_cluster().block_rank();
  const int W = a.W, K = a.i[I_PERC_K];
  const int n_dc = a.i[I_NDC], n_g = a.i[I_MAXGPU], obs_dim = a.i[I_OBS_DIM];
  if (tid == 0) {
    rlk::policy_from(P, a.p + T_W0, a.i);
    rlk::plan_slice(P, cs, a.i[I_LEAD], rank, slice);
  }
  __syncthreads();
  float* act0 = dyn;
  float* act1 = act0 + kActLen;
  float* logit = act1 + kActLen;
  int* cmd = reinterpret_cast<int*>(logit + logit_len(n_g));
  uint16_t* wsm = reinterpret_cast<uint16_t*>(logit + logit_len(n_g) + 4);
  rlk::load_slice<NT>(P, slice, wsm, tid);
  if (tid == 0) *cmd = 0;
  cg::this_cluster().sync();
  if (rank != 0) {
    rlk::serve_forwards<NT>(P, slice, wsm, act0, act1, logit, cmd, cs, tid);
    return;
  }
  if (b < a.B) {
    const float* buf = reinterpret_cast<const float*>(a.p[T_LAT]) + (long long)b * W;
    const float* bufs[2] = {buf, buf};
    const int count = reinterpret_cast<const int*>(a.p[T_LAT_COUNT])[b];
    const int counts[2] = {count, count};
    const bool on[2] = {true, false};
    const rlk::P99Scratch sc{lmax, cand, tau, n_cand, s_bits};
    rlk::windowed_p99<NT>(bufs, counts, on, W, K, p99, sc, tid);
    if (tid == 0) reinterpret_cast<float*>(a.p[T_P99])[b] = p99[0];
  }
  if (b < a.M) {
    const float* o = reinterpret_cast<const float*>(a.p[T_OBS]) + (long long)b * obs_dim;
    for (int k = tid; k < obs_dim; k += NT) obs[k] = o[k];
    const uint8_t* md = reinterpret_cast<const uint8_t*>(a.p[T_MDC]) + (long long)b * n_dc;
    const uint8_t* mgp = reinterpret_cast<const uint8_t*>(a.p[T_MG]) + (long long)b * n_g;
    if (tid < n_dc) mdc[tid] = md[tid] != 0;
    for (int k = tid; k < n_g; k += NT) mg[k] = mgp[k] != 0;
    rlk::bar<NT>();
    rlk::forward<NT>(P, slice, wsm, obs, act0, act1, logit, cmd, cs, tid);
    const int64_t* key = reinterpret_cast<const int64_t*>(a.p[T_KEYS]) + 2LL * b;
    rlk::sample_heads<NT, kWide>(logit, mdc, n_dc, mg, n_g, logp,
                                 (uint32_t)key[0], (uint32_t)key[1], P.greedy,
                                 &acts[0], &acts[1], tid);
    rlk::bar<NT>();
    if (tid == 0) {
      reinterpret_cast<int*>(a.p[T_ADC])[b] = acts[0];
      reinterpret_cast<int*>(a.p[T_AG])[b] = acts[1];
    }
    float* ld = reinterpret_cast<float*>(a.p[T_LOGP_DC]) + (long long)b * n_dc;
    float* lg = reinterpret_cast<float*>(a.p[T_LOGP_G]) + (long long)b * n_g;
    if (tid < n_dc) ld[tid] = logp[tid];
    for (int k = tid; k < n_g; k += NT) lg[k] = logp[32 + k];
  }
  rlk::bar<NT>();
  rlk::release_cluster<NT>(cmd, cs, tid);
}

#endif  // DCG_CLOCK64

// The block widths each mode is built for (kernels/event_scan.py
// BLOCK_WIDTHS; the wrapper picks one); RL mode in a second instance for
// GPU-count heads wider than a warp; every instance for this build's clock.
template <bool kRL, bool kWide, bool kExt>
void (*kernel_of(int threads))(Args) {
  switch (threads) {
    case 32: return event_scan_kernel<kRL, 32, kWide, kExt, Clock>;
    case 256: return event_scan_kernel<kRL, 256, kWide, kExt, Clock>;
    default: return nullptr;
  }
}

void (*kernel_of(const int* ints))(Args) {
  const int threads = ints[I_THREADS];
  if (!ints[I_RL])
    return ints[I_EXT] ? kernel_of<false, false, true>(threads)
                       : kernel_of<false, false, false>(threads);
  return ints[I_MAXGPU] > 32 ? kernel_of<true, true, false>(threads)
                             : kernel_of<true, false, false>(threads);
}

#ifndef DCG_CLOCK64
void (*tail_kernel_of(const int* ints))(TailArgs) {
  const bool wide = ints[I_MAXGPU] > 32;
  switch (ints[I_THREADS]) {
    case 32: return wide ? rl_tail_batch_kernel<32, true>
                         : rl_tail_batch_kernel<32, false>;
    case 256: return wide ? rl_tail_batch_kernel<256, true>
                          : rl_tail_batch_kernel<256, false>;
    default: return nullptr;
  }
}
#endif  // DCG_CLOCK64

}  // namespace

// The longest weight slice (bf16 weights, then the float biases) when nb
// blocks split every layer's rows, ceil(out / nb) each (`plan_slice`).
static long long slice_bytes(const int* ints, int nb) {
  const int widths[kNLayers + 1] = {ints[I_OBS_DIM], ints[I_WH0], ints[I_WH1],
                                    ints[I_WLAT],    ints[I_WAH], ints[I_NDC],
                                    ints[I_MAXGPU]};
  long long elems = 0, belems = 0;
  for (int k = 0; k < kNLayers; ++k) {
    const int in = k < 4 ? widths[k] : widths[4];
    const int out = widths[k + 1];
    int kp = 1;
    while (kp < in) kp <<= 1;
    elems += (long long)((out + nb - 1) / nb) * kp;
    belems += (out + nb - 1) / nb;
  }
  return (elems * 2 + 15) / 16 * 16 + (belems + 3) / 4 * 16;
}

// The dynamic shared memory of an RL cluster's blocks: the activation
// rows, the logits and the command word at one offset in every block, then
// each block's weight slice; block 0 holds its lane's `slab` bytes after
// its own slice (I_LEAD) or in place of one.
static long long cluster_block_bytes(const int* ints, long long slab) {
  const int cs = ints[I_CLUSTER];
  const long long rest =
      ints[I_LEAD] ? slice_bytes(ints, cs) + slab
                   : (slice_bytes(ints, cs - 1) > slab ? slice_bytes(ints, cs - 1)
                                                       : slab);
  return 4LL * (2 * kActLen + logit_len(ints[I_MAXGPU]) + 4) + rest;
}

static bool cluster_ok(const int* ints) {
  const int cs = ints[I_CLUSTER];
  return cs >= 1 && cs <= kMaxCluster && (ints[I_LEAD] || cs >= 2);
}

// A launch of `kernel` in clusters of cs blocks.
template <typename A>
static cudaError_t launch_clusters(void (*kernel)(A), int blocks, int threads,
                            long long smem, int cs, cudaStream_t stream,
                            const A& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

#ifndef DCG_CLOCK64
// Plain C entry point of the standalone launch: `ptrs` N_TAIL_PTRS device
// pointers (TailPtr order), `ints` the event scan's N_INTS (I_THREADS the
// block width, I_CLUSTER and I_LEAD the row's cluster) followed by B, W
// and M.  Returns the cudaError_t of the
// launch, -1 for tables of the wrong length, -2 for shapes the device code
// does not take.
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
  auto kernel = tail_kernel_of(a.i);
  const int cs = a.i[I_CLUSTER];
  if (a.B < 0 || a.M < 0 || a.W < 1 || !policy_ok(chk) || kernel == nullptr ||
      !cluster_ok(a.i))
    return -2;
  const int grid = a.B > a.M ? a.B : a.M;
  if (grid == 0) return (int)cudaSuccess;
  const long long smem = cluster_block_bytes(a.i, 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_clusters(kernel, grid * cs, a.i[I_THREADS], smem, cs,
                        (cudaStream_t)stream, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif  // DCG_CLOCK64

// The dynamic shared memory of a launch's blocks (`ints` in INT_NAMES
// order).  A lane's slab: the job fields, the [P] row of the slots' values,
// a [P] row per DC-summing warp when P exceeds the trees kept in registers,
// the block-reduction words, and in RL mode the latency windows, the
// observation and the log-probabilities; in RL mode inside its cluster's
// rows (`cluster_block_bytes`; B3's scratch shares their activation rows).
// The double clock's build adds the [4, J] double time columns and the
// warps' argmins after an 8-byte alignment pad.
extern "C" long long DCG_ENTRY(event_scan_smem_bytes)(const int* ints) {
  const int J = ints[I_J], P = ints[I_P], rl = ints[I_RL];
  const long long rl_part = rl ? 2LL * ints[I_W] + kMaxObs : 0;
  const long long rows =
      P > 32 * kRegSlots ? (long long)ints[I_SUM_WARPS] * P : 0;
  long long slab =
      4LL * ((N_JI + N_JF) * (long long)J + P + rows + kRed + rl_part);
  if (sizeof(Clock) == 8) slab += 8 + 32LL * J + kWarpMinBytes;
  return rl ? cluster_block_bytes(ints, slab) : slab;
}

// Plain C entry point (bound with ctypes).  `ptrs` holds N_PTRS device
// pointers in PTR_NAMES order, `ints` N_INTS and `floats` N_FLTS values (the
// counts are checked against this build's).  Launches R blocks of
// ints[I_THREADS] threads on `stream`, ints[I_SUM_WARPS] of whose warps sum
// the DCs' power trees; in RL mode R clusters of ints[I_CLUSTER] such
// blocks, which hold the policy's weights between them (block 0 too when
// ints[I_LEAD] is set).  Returns the cudaError_t of the launch (0 on
// success), -1 for a table of the wrong length, -2 for a shape the kernel
// does not take (too many DCs, streams or frequency levels, a block width it
// is not built for), -3 when the slab does not fit in shared memory.  The
// double clock's build (event_scan64_launch) takes N_DBLS doubles after
// the floats: the run's end and log interval.
#ifdef DCG_CLOCK64
extern "C" int event_scan64_launch(const uint64_t* ptrs, int n_ptrs,
                                   const int* ints, int n_ints,
                                   const float* floats, int n_floats,
                                   const double* doubles, int n_doubles,
                                   void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_floats != N_FLTS ||
      n_doubles != N_DBLS)
    return -1;
  Args a;
  for (int k = 0; k < N_DBLS; ++k) a.d[k] = doubles[k];
#else
extern "C" int event_scan_launch(const uint64_t* ptrs, int n_ptrs,
                                 const int* ints, int n_ints,
                                 const float* floats, int n_floats,
                                 void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_floats != N_FLTS) return -1;
  Args a;
#endif
  for (int k = 0; k < N_PTRS; ++k) a.p[k] = (void*)ptrs[k];
  for (int k = 0; k < N_INTS; ++k) a.i[k] = ints[k];
  for (int k = 0; k < N_FLTS; ++k) a.f[k] = floats[k];
  const int R = a.i[I_R], threads = a.i[I_THREADS], sum_warps = a.i[I_SUM_WARPS];
  if (R <= 0 || a.i[I_NSTEPS] <= 0) return (int)cudaSuccess;
  if (a.i[I_NDC] < 1 || a.i[I_NDC] > kMaxDC || 2 * a.i[I_NING] > kMaxS ||
      a.i[I_NF] < 1 || a.i[I_NF] > kMaxF || a.i[I_J] < 1 || a.i[I_Q] < 1 ||
      a.i[I_W] < 1 || a.i[I_NTAB] < 1)
    return -2;
  auto kernel = kernel_of(a.i);
  const int cs = a.i[I_RL] ? a.i[I_CLUSTER] : 1;
  if (kernel == nullptr || sum_warps < 1 || sum_warps > threads / 32) return -2;
  if (a.i[I_RL] && (!policy_ok(a) || !cluster_ok(a.i))) return -2;
  if (a.i[I_EXT] &&
      (a.i[I_RL] || a.p[P_PRICE] == nullptr || a.p[P_CARBON] == nullptr ||
       a.p[P_BAND_N] == nullptr || a.p[P_BAND_S] == nullptr ||
       a.p[P_BAND_T] == nullptr || a.p[P_EGRID_FULL] == nullptr ||
       a.i[I_DEBUG_ROW] < 0 || a.i[I_DEBUG_ROW] >= a.i[I_NMAX]))
    return -2;
  const long long smem = DCG_ENTRY(event_scan_smem_bytes)(a.i);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + (long long)(sizeof(SmallT<Clock>) + sizeof(rlk::Policy) +
                         sizeof(rlk::Slice) + (a.i[I_EXT] ? sizeof(Ext) : 0)) >
      optin)
    return -3;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.i[I_RL]) {
    err = launch_clusters(kernel, R * cs, threads, smem, cs,
                          (cudaStream_t)stream, a);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<R, threads, (size_t)smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
