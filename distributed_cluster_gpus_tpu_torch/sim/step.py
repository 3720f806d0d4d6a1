"""The step program in plain torch: B1's plain version.

Counterpart of ``distributed_cluster_gpus_tpu/sim/engine.py``'s ``_step`` for
the programs the port runs: the heuristic algorithms (``default_policy``,
``joint_nf``, ``carbon_cost``, ``debug``, ``eco_route``, ``bandit`` and the
power-cap controllers ``cap_uniform`` / ``cap_greedy``, any of them with
``--router-weights`` routing where the reference honours it) and
``chsac_af``'s acting path, ring queues, one event per step (superstep
K=1), faults / signals / telemetry off, the write-plan commit.
Every step:

1. computes the next event time as a min over the arrival clocks, the
   projected finish times of running jobs, pending WAN-transfer
   completions and the log tick (ties: finish < xfer < arrival < log, then
   lowest index, as ``jnp.argmin``/``torch.argmin`` both break them);
2. accrues energy (``E += P * dt``), GPU time and job progress over the
   exact inter-event gap;
3. applies that one event through its planner and the shared commit, then
   the step's single ring push and the post-switch queue drain;
4. under ``chsac_af`` (:meth:`StepProgram._step_rl`) there is no post-switch
   drain: the policy tail reads both windows' p99 (B3), builds the
   observation and masks, runs the policy once when a routing or drain
   decision is pending (B4), emits the step's RL transition record, and a
   second commit applies the route, or materializes and starts the head of
   the finishing DC's ring where the policy sends it.

:class:`StepProgram` holds one (fleet, params)'s constants on one device and
runs this step over a single state (:meth:`StepProgram.scan_plain`).  It is
the plain version that ``kernels/event_scan.py`` holds the B1 kernel against
and runs for a CPU state; it never runs on the card's main path.  Unlike the
JAX step, which runs every branch masked under ``lax.switch``, the plain
step reads the event kind back to the host once per event (together with
the few integers the branch indexes by) and runs only the branch that
fires; a queue drain reads one flag per admitted job.  Float values round
exactly as the JAX program rounds them (``fmul_pinned`` products, the fixed
``tree_sum_last`` association, float32 throughout), so given the reference's
arrival tables the run is bit-identical; ``tests/test_torch_engine.py``
holds it so.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device
from ..models.structs import (ALGO_BANDIT, ALGO_CAP_GREEDY, ALGO_CAP_UNIFORM,
                              ALGO_CARBON_COST, ALGO_CHSAC_AF, ALGO_DEBUG,
                              ALGO_ECO_ROUTE, ALGO_JOINT_NF, FleetSpec,
                              JobSlab, JobStatus, QRec, SimParams, SimState)
from ..network import RouterPolicy
from ..ops import prng
from ..ops.arrivals import tmod
from ..ops.bandit import bandit_select, bandit_update
from ..ops.physics import (LatencyCoeffs, PowerCoeffs, fmul_pinned,
                           step_time_s, task_power_w, tree_sum_last)
from ..ops.optimizers import min_n_for_sla
from . import algos

EV_FINISH, EV_XFER, EV_ARRIVAL, EV_LOG, EV_NOOP = 0, 1, 2, 3, 4

# ---------------------------------------------------------------------------
# The float64 clock's float64 arithmetic.  Under the float64 clock the JAX
# package runs in jax's x64 mode, so besides the clock its unpinned draws
# and weak-typed promotions turn float64.  Every equation of the reference's
# programs whose output is float64, as (primitive, JAX package or optax
# site), by program, each site with the port's code that computes it the
# same way (``tests/test_torch_clock64_sites.py`` walks the jaxprs and holds
# the lists equal, so a site the port misses is named there).
# ---------------------------------------------------------------------------

_E = "distributed_cluster_gpus_tpu/sim/engine.py:"
_A = "distributed_cluster_gpus_tpu/ops/arrivals.py:"
_W = "distributed_cluster_gpus_tpu/workload/compiler.py:"
#: JAX site -> (its float64 primitives, the port's code)
X64_STEP = {
    "distributed_cluster_gpus_tpu/ops/physics.py:73": (
        ("mul",), "StepProgram._head: fmul_pinned(powers / busy in the clock's "
                  "dtype, dt)"),
    "distributed_cluster_gpus_tpu/ops/physics.py:74": (
        ("add", "mul"), "StepProgram._head: fmul_pinned's float64 fence"),
    _E + "1538": (("add", "rem"), "StepProgram._plan_finish: tmod(t, log_interval)"),
    _E + "1544": (("max", "sub"), "StepProgram._plan_finish: the sojourn"),
    _E + "2798": (("max", "sub"), "StepProgram._handle_log: elapsed"),
    _E + "2799": (("div", "mul"), "StepProgram._handle_log: util_avg"),
    _E + "2819": (("div",), "StepProgram._handle_log: energy_j * inv_1000 "
                            "(XLA's reciprocal)"),
    _E + "2839": (("add",), "StepProgram._handle_log: next_log_t"),
    _E + "2985": (("add",), "StepProgram._head: t_fin_all (the float32 "
                            "product widened)"),
    _E + "3019": (("max", "sub"), "StepProgram._head: dt"),
    _E + "3030": (("add",), "StepProgram._head: energy_j"),
    _E + "3031": (("add",), "StepProgram._head: util_gpu_time"),
}
#: the heuristic programs' own sites
X64_HEURISTIC = {
    _E + "1123": (("sub",), "StepProgram._start_from_rec: the resumed job's "
                            "preempt time"),
    _E + "1771": (("add",), "StepProgram._plan_arrival: t_avail"),
}
#: the hour of the eco sites (eco_route, carbon_cost, weighted routing)
X64_HOUR = {
    _E + "723": (("add", "div", "rem", "round", "sign", "sub"),
                 "algos.hour_of: XLA's floor_divide"),
}
#: chsac_af's acting step's own sites
X64_RL = {
    _E + "1878": (("sub",), "StepProgram._commit_tail: the preempt time"),
    _E + "3503": (("reduce_sum",), "StepProgram._tail: the energy sum "
                                   "(a left fold)"),
    _E + "3620": (("add",), "StepProgram._tail: the routed t_avail"),
    "distributed_cluster_gpus_tpu/sim/algos.py:271": (
        ("div",), "algos.rl_obs: t_frac (the reciprocal of the day)"),
}
#: WorkloadProgram.tables (B2's plain version,
#: kernels/arrival_tables.arrival_tables_reference)
X64_TABLES = {
    _A + "47": (("add", "rem"), "ops.arrivals.tmod"),
    _A + "59": (("add", "bitcast_convert_type", "log1p", "max", "mul", "neg",
                 "sub"), "ops.prng.uniform64 / exponential64"),
    _A + "145": (("mul",), "ops.arrivals.sinusoid_gap_from_cum: phase0"),
    _A + "146": (("cos",), "sinusoid_gap_from_cum: cos0"),
    _A + "149": (("add", "cos", "mul", "sub"), "sinusoid_gap_from_cum: "
                                               "gap_integral"),
    _A + "153": (("div",), "sinusoid_gap_from_cum: lo"),
    _A + "154": (("div", "min"), "sinusoid_gap_from_cum: hi"),
    _A + "155": (("add", "div", "mul"), "sinusoid_gap_from_cum: hi"),
    _A + "159": (("add", "mul"), "sinusoid_gap_from_cum: mid"),
    _A + "164": (("add", "mul"), "sinusoid_gap_from_cum: the result"),
    _A + "190": (("max", "sub"), "ops.arrivals.sample_job_size: u"),
    _A + "191": (("div", "pow"), "sample_job_size: the Pareto size"),
    _A + "192": (("add", "bitcast_convert_type", "erf_inv", "max", "mul",
                  "sub"), "ops.prng.normal64 / erfinv_f64"),
    _A + "196": (("add", "exp", "max"), "sample_job_size: the log-normal size"),
    _A + "197": (("mul",), "sample_job_size"),
    _W + "292": (("div",), "arrival_tables_reference: e * (1 / rate) "
                           "(XLA's reciprocal)"),
    _W + "303": (("add",), "arrival_tables_reference: the anchor"),
    _W + "311": (("add",), "arrival_tables_reference: epoch + delta"),
    _W + "364": (("add",), "arrival_tables_reference: the left fold"),
}
#: WorkloadProgram.init_clocks (draw #0: ops.arrivals.next_interarrival)
X64_INIT_CLOCKS = {
    _A + "46": (("mul",), "ops.arrivals.lambda_t"),
    _A + "47": (("add", "div", "mul", "rem", "sin"), "ops.arrivals.lambda_t"),
    _A + "52": (("max",), "lambda_t: the clamp"),
    _A + "59": (("add", "bitcast_convert_type", "log1p", "max", "mul", "neg",
                 "sub"), "ops.prng.uniform64 / exponential64"),
    _A + "60": (("div",), "ops.arrivals._exponential_safe"),
    _A + "103": (("add",), "next_interarrival: w + gap"),
    _A + "105": (("add",), "next_interarrival: t + w"),
    _A + "106": (("div",), "next_interarrival: the acceptance ratio"),
}
#: sac_train_step: B6b's uniform (rl.replay.replay_sample, x64) and B5c's
#: bias corrections (rl.optim.bias_correction, x64)
X64_UPDATE = {
    "distributed_cluster_gpus_tpu/rl/replay.py:216": (
        ("add", "bitcast_convert_type", "max", "mul", "sub"),
        "rl.replay.replay_sample: u in float64"),
    "optax/_src/transform.py:294": (("pow", "sub"),
                                   "rl.optim.bias_correction: b1"),
    "optax/_src/transform.py:298": (("pow", "sub"),
                                   "rl.optim.bias_correction: b2"),
}


def x64_sites(*tables):
    """The (primitive, JAX site) pairs of the given site tables."""
    return {(prim, site) for t in tables for site, (prims, _) in t.items()
            for prim in prims}
#: the policy tail's pending decision: none, route an arrival, drain a ring
REQ_NONE, REQ_ROUTE, REQ_DRAIN = 0, 1, 2

CLUSTER_COLS = (
    "time_s", "freq", "busy", "free", "run_total", "run_inf", "run_train",
    "q_inf", "q_train", "util_inst", "util_avg", "acc_job_unit", "power_W",
    "energy_kJ",
)
JOB_COLS = (
    "jid", "ingress", "type", "size", "dc", "f_used", "n_gpus", "net_lat_s",
    "start_s", "finish_s", "latency_s", "preempt_count", "T_pred", "P_pred",
    "E_pred",
)


# ---------------------------------------------------------------------------
# fixed-association reductions over the tiny DC axis
# ---------------------------------------------------------------------------

def dc_count(vals, dc_idx, n_dc: int):
    """Integer per-DC counts (exact under any order)."""
    m = dc_idx[None, :] == torch.arange(n_dc, device=dc_idx.device)[:, None]
    return torch.where(m, vals[None, :].to(torch.int32),
                       torch.zeros((), dtype=torch.int32,
                                   device=dc_idx.device)).sum(-1, dtype=torch.int32)


def dc_sum(vals, dc_idx, n_dc: int):
    """Per-DC float sum as a masked [n_dc, J] fixed-tree reduce."""
    m = dc_idx[None, :] == torch.arange(n_dc, device=dc_idx.device)[:, None]
    return tree_sum_last(torch.where(m, vals[None, :].to(torch.float32),
                                     torch.zeros((), dtype=torch.float32,
                                                 device=dc_idx.device)))


class StepProgram:
    """One (fleet, params)'s constants on one device and the plain step
    loop over them (``sim.engine.Engine`` is one, with its workload)."""

    def __init__(self, fleet: FleetSpec, params: SimParams, device="cuda"):
        self.fleet = fleet
        self.params = params
        self.device = dev = resolve_device(device)
        td = params.tdtype
        f32 = dict(dtype=torch.float32, device=dev)
        self.td = td
        self.freq_levels = torch.tensor(fleet.freq_levels, **f32)
        self.total_gpus = torch.tensor(fleet.total_gpus, dtype=torch.int32,
                                       device=dev)
        self.E_grid = torch.tensor(fleet.E_grid, **f32)
        # grid searches honour the per-job GPU cap
        self.E_grid_cap = self.E_grid[:, :, :min(fleet.n_max, params.max_gpus_per_job), :]
        self.transfer_s = torch.tensor(fleet.transfer_s, **f32)
        self.net_lat_s = torch.tensor(fleet.net_lat_s, **f32)
        self.power = PowerCoeffs(*(torch.tensor(c, **f32) for c in fleet.power))
        self.latency = LatencyCoeffs(*(torch.tensor(c, **f32)
                                       for c in fleet.latency))
        self.idle_w = torch.where(torch.tensor(fleet.power_gating, device=dev),
                                  torch.tensor(fleet.p_sleep, **f32),
                                  torch.tensor(fleet.p_idle, **f32))
        self.end = torch.tensor(params.duration, dtype=td, device=dev)
        self.log_interval = torch.tensor(params.log_interval, dtype=td, device=dev)
        self.inf = torch.tensor(math.inf, dtype=td, device=dev)
        self.zero_f = torch.zeros((), **f32)
        self.zero_td = torch.zeros((), dtype=td, device=dev)
        self.inv_total = 1.0 / torch.clamp(self.total_gpus, min=1).to(torch.float32)
        self.inv_1000 = 1.0 / torch.tensor(1000.0, dtype=td, device=dev)
        self.k_drain = max(params.max_gpus_per_job,
                           min(params.num_fixed_gpus, params.job_cap))
        self.default_f_idx = fleet.default_f_idx
        self.rl = params.algo == ALGO_CHSAC_AF
        # the eco sites' static tables (no signal timelines: the hourly
        # price and the per-DC carbon intensity)
        self.price_hourly = torch.tensor(fleet.price_hourly, **f32)
        self.carbon = torch.tensor(fleet.carbon, **f32)
        #: each (dc, jtype)'s least energy per unit over the capped grid
        #: (``route_weighted``'s E_unit)
        self.E_unit_min = self.E_grid_cap.reshape(
            fleet.n_dc, 2, -1).min(dim=-1).values
        # routing: the policy tail (chsac_af), eco, the weighted score or
        # uniform-random
        self.route = ("rl" if self.rl else "eco" if params.algo == ALGO_ECO_ROUTE
                      else "weighted" if params.router_weights is not None
                      else "random")
        self.router = (RouterPolicy(*params.router_weights)
                       if params.router_weights is not None else None)
        #: debug's frequency at its fixed GPU count, per (dc, jtype): the
        #: fixed ladder index, or the energy argmin on the UNcapped grid at
        #: row n - 1 (a negative row counts from the end and any row is
        #: clamped into the grid, as XLA's indexing does)
        row = params.num_fixed_gpus - 1
        self.debug_row = row = min(max(row + fleet.n_max if row < 0 else row, 0),
                                   fleet.n_max - 1)
        if params.fixed_freq is not None:
            self.debug_f = torch.full((fleet.n_dc, 2),
                                      algos.f_idx_of(fleet, params.fixed_freq),
                                      dtype=torch.int32, device=dev)
        else:
            self.debug_f = torch.argmin(self.E_grid[:, :, row, :],
                                        dim=-1).to(torch.int32)
        self.cap_on = (params.power_cap > 0
                       and params.algo in (ALGO_CAP_UNIFORM, ALGO_CAP_GREEDY))
        #: ``policy_apply(sac, obs, mask_dc, mask_g, key) -> (a_dc, a_g)``,
        #: the chsac_af policy (set by ``sim.engine.Engine``)
        self.policy_apply = None
        if self.rl:
            self.obs_dim = params.obs_dim(fleet.n_dc)
            self.n_g = params.max_gpus_per_job
            self.obs_consts = {
                "total_f": self.total_gpus.to(torch.float32),
                "freq_levels": self.freq_levels,
                "inv7": 1.0 / torch.tensor(7.0, **f32),
                # the day's reciprocal in the clock's dtype (XLA's rewrite
                # of ``/ 86400.0`` under either clock)
                "inv_day": 1.0 / torch.tensor(86400.0, dtype=td, device=dev)}
            self.inv_kwh = 1.0 / torch.tensor(3.6e6, **f32)
            self.neg_w = torch.tensor(-params.rl_energy_weight, **f32)
            self.c005 = torch.tensor(0.05, **f32)
            self.c1000 = torch.tensor(1000.0, **f32)
        #: the plain loop's count over its last lane: events and host reads
        #: (event heads + drain flags)
        self._plain = {"events": 0, "host_reads": 0}
        #: the cap controllers' log ticks (those where the fleet's power
        #: called for control) and iterations since construction
        self.ctl_ticks = 0
        self.ctl_iters = 0
        #: cap_greedy's iterations whose cheapest rho more than one atom
        #: shares (the first, job-major, wins)
        self.ctl_ties = 0
        self._consts = None

    def kernel_consts(self):
        """The fleet constants the event-scan kernel reads, contiguous, by
        the names of ``kernels/event_scan.PTR_NAMES``."""
        if self._consts is None:
            c = {"freq_levels": self.freq_levels, "total_gpus": self.total_gpus,
                 "E_grid_cap": self.E_grid_cap, "transfer_s": self.transfer_s,
                 "net_lat_s": self.net_lat_s, "idle_w": self.idle_w,
                 "E_grid": self.E_grid, "price_hourly": self.price_hourly,
                 "carbon": self.carbon}
            for grp, coeffs in (("power", self.power), ("latency", self.latency)):
                for name, v in zip(coeffs._fields, coeffs):
                    c[f"{grp}.{name}"] = v
            self._consts = {k: v.contiguous() for k, v in c.items()}
        return self._consts

    # ---------------- vector helpers over the slab ----------------

    def _row_TP(self, dcj, jt, n, f_idx):
        """Scalar (seconds-per-unit, watts) at (dc, jtype, n, f)."""
        pc = PowerCoeffs(*(a[dcj, jt] for a in self.power))
        tc = LatencyCoeffs(*(a[dcj, jt] for a in self.latency))
        f = self.freq_levels[f_idx]
        return (step_time_s(n, f, tc).to(torch.float32),
                task_power_w(n, f, pc).to(torch.float32))

    def _dc_power(self, jobs: JobSlab, busy):
        """[n_dc] power: running jobs' cached watts plus the idle floor."""
        p_job = torch.where(jobs.status == JobStatus.RUNNING, jobs.watts,
                            self.zero_f)
        active = dc_sum(p_job, jobs.dc, self.fleet.n_dc)
        idle = fmul_pinned(self.total_gpus - busy, self.idle_w)
        return active + idle

    def _queue_lens(self, st: SimState):
        cnt = st.queues.tail - st.queues.head
        return cnt[:, 0], cnt[:, 1]

    def _free_for(self, busy, dcj: int, jt):
        """Free GPUs at DC ``dcj`` for a job of type ``jt``; training jobs
        may not dip into the per-DC inference reserve."""
        free = self.total_gpus[dcj] - busy[dcj]
        r = self.params.reserve_inf_gpus
        if r <= 0:
            return free
        if isinstance(jt, int):
            return torch.clamp(free - r, min=0) if jt == 1 else free
        return torch.where(jt == 1, torch.clamp(free - r, min=0), free)

    # ---------------- queue rings ----------------

    def _rec_pack(self, size, seq, ingress, t_ingress, t_avail, net_lat_s,
                  units_done=None, t_start=None, preempt_count=None,
                  preempt_t=None, total_preempt_time=None):
        """One ring record in the time dtype; omitted fields are zero."""
        zero = self.zero_td
        vals = [zero] * QRec.N_FIELDS
        vals[QRec.SIZE] = size
        vals[QRec.SEQ] = seq
        vals[QRec.INGRESS] = ingress
        vals[QRec.T_INGRESS] = t_ingress
        vals[QRec.T_AVAIL] = t_avail
        vals[QRec.NET_LAT_S] = net_lat_s
        for i, v in ((QRec.UNITS_DONE, units_done), (QRec.T_START, t_start),
                     (QRec.PREEMPT_COUNT, preempt_count),
                     (QRec.PREEMPT_T, preempt_t),
                     (QRec.TOTAL_PREEMPT_TIME, total_preempt_time)):
            if v is not None:
                vals[i] = v
        return torch.stack([torch.as_tensor(v, device=self.device).to(self.td)
                            for v in vals])

    def _rec_from_slab(self, jobs: JobSlab, j: int):
        return self._rec_pack(
            jobs.size[j], jobs.seq[j], jobs.ingress[j], jobs.t_ingress[j],
            jobs.t_avail[j], jobs.net_lat_s[j], jobs.units_done[j],
            jobs.t_start[j], jobs.preempt_count[j], jobs.preempt_t[j],
            jobs.total_preempt_time[j])

    def _ring_push(self, st: SimState, push) -> None:
        """Append the step's push request; a full ring counts a drop.  The
        ring row, tail and drop counter update in place, predicated on the
        ring's fill level without a host read."""
        dcj, jt, rec = push["dcj"], push["jt"], push["rec"]
        q = st.queues
        Q = q.recs.shape[2]
        tail = q.tail[dcj, jt]
        ok = (tail - q.head[dcj, jt]) < Q
        pos = torch.remainder(tail, Q).to(torch.int64)
        row = q.recs[dcj, jt]
        cur = row.index_select(0, pos.reshape(1))[0]
        row.index_copy_(0, pos.reshape(1), torch.where(ok, rec, cur)[None])
        q.tail[dcj, jt] += ok.to(torch.int32)
        st.n_dropped += (~ok).to(torch.int32)

    def _ring_head(self, st: SimState, dcj: int):
        """(record, jt, found) at DC ``dcj``'s ring heads honouring inference
        priority and free-GPU gating (``found`` and ``jt`` as device
        tensors)."""
        q = st.queues
        Q = q.recs.shape[2]
        head, tail = q.head[dcj], q.tail[dcj]
        has = (tail - head) > 0
        busy = st.dc.busy
        has_i = has[0] & (self._free_for(busy, dcj, 0) > 0)
        has_t = has[1] & (self._free_for(busy, dcj, 1) > 0)
        one = torch.ones((), dtype=torch.int32, device=self.device)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.params.inf_priority:
            jt = torch.where(has_i, zero, one)
        else:
            jt = torch.where(has_t, one, zero)
        pos = torch.remainder(head, Q).to(torch.int64)
        recs = q.recs[dcj]  # [2, Q, F]
        rec_i = recs[0].index_select(0, pos[0:1])[0]
        rec_t = recs[1].index_select(0, pos[1:2])[0]
        rec = torch.where(jt == 0, rec_i, rec_t)
        return rec, jt, has_i | has_t

    # ---------------- admission ----------------

    def _decide_nf_core(self, st: SimState, dcj: int, jt, free, cur_f):
        """The non-RL, non-bandit admission dispatch: (n, f_idx, new DC
        ladder index)."""
        p = self.params
        if p.algo == ALGO_JOINT_NF:
            n, f_idx = algos.admit_joint_nf(self.E_grid_cap, dcj, jt)
            return n, f_idx, cur_f
        if p.algo == ALGO_CARBON_COST:
            price = self.price_hourly[algos.hour_of(st.t)]
            n, f_idx = algos.admit_carbon_cost(self.E_grid_cap, dcj, jt, price,
                                               self.carbon[dcj])
            return n, f_idx, cur_f
        if p.algo == ALGO_DEBUG:
            n = torch.full_like(cur_f, p.num_fixed_gpus)
            return n, self.debug_f[dcj, jt], cur_f
        q_inf_len = (st.queues.tail[dcj, 0] - st.queues.head[dcj, 0])
        n, new_dc_f = algos.heuristic_select(p, self.fleet, jt, free, cur_f,
                                             q_inf_len)
        return n, new_dc_f, new_dc_f

    def _decide_start_vals(self, st: SimState, dcj: int, jt):
        """`_decide_nf_core` (or the bandit's select) plus `_start_job`'s
        clamp and physics refresh; the bandit's new select count last (None
        for the other algorithms), for the caller to commit."""
        free = self._free_for(st.dc.busy, dcj, jt)
        cur_f = st.dc.cur_f_idx[dcj]
        t_sel = None
        if self.params.algo == ALGO_BANDIT:
            n_d = torch.clamp(free, max=self.params.max_gpus_per_job)
            f_d, t_sel = bandit_select(st.bandit, dcj, jt)
            new_dc_f = cur_f
        else:
            n_d, f_d, new_dc_f = self._decide_nf_core(st, dcj, jt, free, cur_f)
        n_st = torch.clamp(torch.minimum(n_d.to(torch.int32), free), min=1)
        f_d = f_d.to(torch.int32)
        spu, watts = self._row_TP(dcj, jt, n_st, f_d)
        return n_st, f_d, new_dc_f.to(torch.int32), spu, watts, t_sel

    # ---------------- queue drain ----------------

    def _drain_queues(self, st: SimState, dcj: int, enabled: bool,
                      xfer_j: Optional[int] = None) -> None:
        """Start queued jobs at ``dcj`` while GPUs are free (reference
        `_drain_queues(masked=True, xfer=...)`, ring body, in place).

        At most ``k_drain`` iterations.  Iteration 0 doubles as the step's
        xfer admission when ``xfer_j`` is given (the caller passes it only
        when the DC can start the job).  An iteration that starts nothing
        leaves the state as it was, so every later one would start nothing
        too: the loop stops at the first such iteration, which it learns
        from one host read per iteration."""
        for i in range(self.k_drain):
            direct = xfer_j is not None and i == 0
            if direct:
                jobs = st.jobs
                slot, dc_t = xfer_j, dcj
                rec = self._rec_from_slab(jobs, slot)
                jt_t = jobs.jtype[slot].clone()
            else:
                if not enabled:
                    return
                rec, jt_t, found = self._ring_head(st, dcj)
                empty = (st.jobs.status == JobStatus.EMPTY).to(torch.int32)
                slot_t = torch.argmax(empty)
                ok_t = found & (empty[slot_t] == 1)
                ok, jt_sel, slot = torch.stack([
                    ok_t.to(torch.int64), jt_t.to(torch.int64), slot_t]).tolist()
                self._plain["host_reads"] += 1
                if not ok:
                    return
                dc_t = dcj
            self._start_from_rec(st, slot, dc_t, jt_t, rec)
            if not direct:
                st.queues.head[dcj, jt_sel] += 1

    def _start_from_rec(self, st: SimState, slot: int, dcj: int, jt, rec):
        """Commit a record straight to RUNNING at ``slot`` with the decided
        (n, f) and refreshed physics (the masked drain body's one write
        chain), in place."""
        n_st, f_d, new_dc_f, spu, watts, t_sel = self._decide_start_vals(
            st, dcj, jt)
        if t_sel is not None:
            st.bandit.t = t_sel
        jobs = st.jobs
        t = st.t
        t_start0 = rec[QRec.T_START]
        resuming = rec[QRec.PREEMPT_T] > 0.0
        jobs.status[slot] = JobStatus.RUNNING
        jobs.jtype[slot] = jt
        jobs.ingress[slot] = rec[QRec.INGRESS].to(torch.int32)
        jobs.dc[slot] = dcj
        jobs.seq[slot] = rec[QRec.SEQ].to(torch.int32)
        jobs.size[slot] = rec[QRec.SIZE].to(torch.float32)
        jobs.units_done[slot] = rec[QRec.UNITS_DONE].to(torch.float32)
        jobs.n[slot] = n_st
        jobs.f_idx[slot] = f_d
        jobs.spu[slot] = spu
        jobs.watts[slot] = watts
        jobs.t_ingress[slot] = rec[QRec.T_INGRESS]
        jobs.t_avail[slot] = rec[QRec.T_AVAIL]
        jobs.t_start[slot] = torch.where(t_start0 <= 0.0, t, t_start0)
        jobs.net_lat_s[slot] = rec[QRec.NET_LAT_S].to(torch.float32)
        jobs.preempt_count[slot] = rec[QRec.PREEMPT_COUNT].to(torch.int32)
        jobs.preempt_t[slot] = 0.0
        jobs.total_preempt_time[slot] = (
            rec[QRec.TOTAL_PREEMPT_TIME].to(torch.float32)
            + torch.where(resuming, (t - rec[QRec.PREEMPT_T]).to(torch.float32),
                          self.zero_f))
        st.dc.busy[dcj] += n_st
        st.dc.cur_f_idx[dcj] = new_dc_f

    # ---------------- planners + the shared commit ----------------

    def _plan_finish(self, st: SimState, j: int, dcj: int, jt: int):
        """Finish planner: accounting values and the job-log row; the slab
        is untouched until the commit."""
        jobs = st.jobs
        t = st.t
        n = jobs.n[j]
        f_used = self.freq_levels[jobs.f_idx[j]]
        size_j = jobs.size[j]
        span = tmod(t, self.log_interval).to(torch.float32)
        acc = span / jobs.spu[j]
        T_pred, P_pred = jobs.spu[j], jobs.watts[j]
        E_pred = T_pred * P_pred
        sojourn = torch.clamp(t - jobs.t_start[j], min=0.0).to(torch.float32)
        f = torch.float32
        job_row = torch.stack([
            jobs.seq[j].to(f), jobs.ingress[j].to(f), jobs.jtype[j].to(f),
            size_j, jobs.dc[j].to(f), f_used, n.to(f), jobs.net_lat_s[j],
            jobs.t_start[j].to(f), t.to(f), sojourn, jobs.preempt_count[j].to(f),
            T_pred, P_pred, E_pred])
        plan = {"kind": EV_FINISH, "row": j, "dc_row": dcj, "fin_jt": jt,
                "units_done": size_j.clone(), "busy_delta": n.clone(),
                "acc_add": acc, "fin_size": size_j.clone(), "sojourn": sojourn}
        if self.params.algo == ALGO_BANDIT:
            # the finished arm's reward, committed before the post-finish
            # drain's selects read the counts
            plan["bandit"] = (jobs.f_idx[j].clone(), E_pred)
        return plan, job_row

    def _plan_xfer(self, st: SimState, j: int, dcj: int, jt: int, can: bool):
        """Xfer planner: queue-on-full evicts the row into the ring; the
        start itself rides iteration 0 of the shared drain."""
        plan = {"kind": EV_XFER, "row": j, "evict": not can}
        push = None
        if not can:
            push = {"dcj": dcj, "jt": jt, "rec": self._rec_from_slab(st.jobs, j)}
        return plan, push

    def _plan_arrival(self, st: SimState, ing: int, jt: int, k_ev, pre,
                      has_slot: bool, slot: int):
        """Arrival planner: the pregenerated draw at the stream's cursor,
        the routing (eco, weighted or uniform-random), the XFER placement
        (or a ring spill when the slab is full) and the stream-clock advance
        (applied here, in place)."""
        stream = ing * 2 + jt
        n_tab = pre["sizes"].shape[1]
        idx = torch.clamp(st.arr_count[ing, jt] - pre["c0"][stream],
                          max=n_tab - 1).to(torch.int64)
        size = pre["sizes"][stream].index_select(0, idx.reshape(1))[0]
        t_next_arr = pre["tnext"][stream].index_select(0, idx.reshape(1))[0]
        if self.route == "random":
            dc_sel = prng.randint_int(k_ev, self.fleet.n_dc)
        else:
            price = self.price_hourly[algos.hour_of(st.t)]
            if self.route == "eco":
                dc_t = algos.route_eco(self.E_grid_cap, jt, size,
                                       self.params.eco_objective, price,
                                       self.carbon)
            else:
                q_inf, q_trn = self._queue_lens(st)
                dc_t = algos.route_weighted(
                    self.router, self.net_lat_s[ing], self.E_unit_min[:, jt],
                    size, price, self.carbon, q_inf + q_trn)
            dc_sel = int(dc_t)
            self._plain["host_reads"] += 1
        transfer = self.transfer_s[ing, dc_sel, jt]
        net_lat = self.net_lat_s[ing, dc_sel]
        t_avail = st.t + transfer.to(self.td)
        jid = st.jid_counter.clone()
        plan = {"kind": EV_ARRIVAL, "row": slot, "place": has_slot,
                "jtype": jt, "ingress": ing, "dc": dc_sel, "seq": jid,
                "size": size, "t_ingress": st.t.clone(), "t_avail": t_avail,
                "net_lat_s": net_lat}
        push = None
        if not has_slot:
            push = {"dcj": dc_sel, "jt": jt,
                    "rec": self._rec_pack(size, jid, ing, st.t, t_avail, net_lat)}
        st.jid_counter += 1
        st.next_arrival[ing, jt] = t_next_arr.to(self.td)
        st.arr_count[ing, jt] += 1
        return plan, push

    def _commit_plan(self, st: SimState, plan) -> None:
        """Apply one step's plan: one write per touched slab field, the busy
        refresh, the latency-window push and the finish counters (in place)."""
        jobs = st.jobs
        j = plan["row"]
        kind = plan["kind"]
        if kind == EV_ARRIVAL:
            if not plan["place"]:
                return
            jobs.status[j] = JobStatus.XFER
            jobs.jtype[j] = plan["jtype"]
            jobs.ingress[j] = plan["ingress"]
            jobs.dc[j] = plan["dc"]
            jobs.seq[j] = plan["seq"]
            jobs.size[j] = plan["size"]
            jobs.units_done[j] = 0.0
            jobs.n[j] = 0
            jobs.f_idx[j] = self.default_f_idx
            jobs.t_ingress[j] = plan["t_ingress"]
            jobs.t_avail[j] = plan["t_avail"]
            jobs.t_start[j] = 0.0
            jobs.net_lat_s[j] = plan["net_lat_s"]
            jobs.preempt_count[j] = 0
            jobs.preempt_t[j] = 0.0
            jobs.total_preempt_time[j] = 0.0
            jobs.rl_valid[j] = False
            return
        if kind == EV_XFER:
            if plan["evict"]:
                jobs.status[j] = JobStatus.EMPTY
            return
        # EV_FINISH
        dcj, jt = plan["dc_row"], plan["fin_jt"]
        jobs.status[j] = JobStatus.EMPTY
        jobs.units_done[j] = plan["units_done"]
        jobs.rl_valid[j] = False
        busy = st.dc.busy
        busy[dcj] -= plan["busy_delta"]
        torch.clamp_(busy, min=0)
        st.dc.acc_job_unit[dcj] += plan["acc_add"]
        lat = st.lat
        W = lat.buf.shape[1]
        ptr = lat.ptr[jt].to(torch.int64)
        lat.buf[jt].index_copy_(0, ptr.reshape(1), plan["sojourn"].reshape(1))
        lat.count[jt] += 1
        lat.ptr[jt] = torch.remainder(lat.ptr[jt] + 1, W)
        st.n_finished[jt] += 1
        st.units_finished[jt] += plan["fin_size"]
        if "bandit" in plan:
            f_arm, cost = plan["bandit"]
            bandit_update(st.bandit, dcj, jt, f_arm, cost)

    # ---------------- the log tick ----------------

    def _control(self, st: SimState) -> None:
        """The power-cap control at the top of a log tick (reference
        ``_control``), in place: under ``eco_route`` / ``carbon_cost`` idle
        DCs drop to ladder index 0; under the cap controllers, when the
        fleet's power exceeds ``power_cap - cap_margin_w``, the controller
        runs."""
        p = self.params
        if p.power_cap <= 0:
            return
        if p.algo in (ALGO_ECO_ROUTE, ALGO_CARBON_COST):
            idle = st.dc.busy == 0
            st.dc.cur_f_idx = torch.where(idle, torch.zeros_like(st.dc.cur_f_idx),
                                          st.dc.cur_f_idx)
            return
        if not self.cap_on:
            return
        need = self._total_power(st) > torch.tensor(
            p.power_cap - p.cap_margin_w, dtype=torch.float32, device=self.device)
        self._plain["host_reads"] += 1
        if not bool(need):
            return
        self.ctl_ticks += 1
        if p.algo == ALGO_CAP_UNIFORM:
            self._cap_uniform(st)
        else:
            self._cap_greedy(st)

    def _total_power(self, st: SimState):
        """The fleet's power: the DCs' ``_dc_power`` by the fixed tree."""
        return tree_sum_last(self._dc_power(st.jobs, st.dc.busy))

    def _job_coeffs(self, jobs: JobSlab):
        pc = PowerCoeffs(*(a[jobs.dc, jobs.jtype] for a in self.power))
        tc = LatencyCoeffs(*(a[jobs.dc, jobs.jtype] for a in self.latency))
        return pc, tc

    def _cap_uniform(self, st: SimState) -> None:
        """Uniform DC downclock (reference ``_cap_uniform``): while the
        deficit ``total - power_cap`` (no margin) exceeds 1e-6, lower by one
        ladder step the DC whose step saves the most power (the first
        maximum; a saving must exceed 1e-9), clamping every running job
        there to the new level and refreshing its cached physics.  Each
        saving is the masked tree sum of the DC's running jobs' power
        clamped to its level, less the same one level lower.  One host
        read per iteration (``self.ctl_iters`` counts them)."""
        p, fleet = self.params, self.fleet
        jobs = st.jobs
        f32 = torch.float32
        deficit = torch.clamp(self._total_power(st) - torch.tensor(
            p.power_cap, dtype=f32, device=self.device), min=0.0)
        live = bool(deficit > 1e-6)
        d_idx = torch.arange(fleet.n_dc, device=self.device)
        while live:
            self.ctl_iters += 1
            pc, _ = self._job_coeffs(jobs)
            cur = st.dc.cur_f_idx
            run_in = ((jobs.status == JobStatus.RUNNING)[None, :]
                      & (jobs.dc[None, :] == d_idx[:, None]))  # [n_dc, J]

            def power_at(level):  # [n_dc] per-DC clamped power
                f_cl = self.freq_levels[torch.minimum(jobs.f_idx[None, :],
                                                      level[:, None])]
                pw = task_power_w(jobs.n[None, :], f_cl,
                                  PowerCoeffs(*(c[None, :] for c in pc)))
                return tree_sum_last(torch.where(run_in, pw, self.zero_f))

            p_now = power_at(cur)
            p_lo = power_at(torch.clamp(cur - 1, min=0))
            dps = torch.where(cur > 0, p_now - p_lo, self.zero_f)
            best = torch.argmax(dps)
            best_dp = dps[best]
            ok = bool(best_dp > 1e-9)
            self._plain["host_reads"] += 1
            if ok:
                b = int(best)
                new_level = torch.clamp(cur[b] - 1, min=0)
                in_dc = (jobs.status == JobStatus.RUNNING) & (jobs.dc == b)
                jobs.f_idx = torch.where(in_dc, torch.minimum(jobs.f_idx, new_level),
                                         jobs.f_idx)
                pc, tc = self._job_coeffs(jobs)
                f = self.freq_levels[jobs.f_idx]
                jobs.spu = torch.where(in_dc, step_time_s(jobs.n, f, tc),
                                       jobs.spu).to(f32)
                jobs.watts = torch.where(in_dc, task_power_w(jobs.n, f, pc),
                                         jobs.watts).to(f32)
                st.dc.cur_f_idx[b] = new_level
                deficit = deficit - best_dp
            live = ok and bool(deficit > 1e-6)

    def _cap_greedy(self, st: SimState) -> None:
        """Atom-ladder downclock (reference ``_cap_greedy``): while the
        fleet's power exceeds ``power_cap``, apply the globally cheapest
        ladder step k -> k-1 below a running job's level, by rho = dP / dV
        over the [J, n_f - 1] atoms (first minimum, job-major), setting the
        job's level to the step's lower end with its cached physics; the
        total is summed again after each atom.  One host read per
        iteration (``self.ctl_iters`` counts them, ``self.ctl_ties`` those
        whose least rho more than one atom shares)."""
        p = self.params
        jobs = st.jobs
        f32 = torch.float32
        levels = self.freq_levels
        n_f = levels.shape[0]
        cap = torch.tensor(p.power_cap, dtype=f32, device=self.device)
        k_idx = torch.arange(1, n_f, device=self.device)
        live = bool(self._total_power(st) > cap)
        while live:
            self.ctl_iters += 1
            pc, tc = self._job_coeffs(jobs)
            pc2 = PowerCoeffs(*(c[:, None] for c in pc))
            tc2 = LatencyCoeffs(*(c[:, None] for c in tc))
            n2 = jobs.n[:, None]
            P_all = task_power_w(n2, levels[None, :], pc2)  # [J, n_f]
            T_all = step_time_s(n2, levels[None, :], tc2)
            V_all = 1.0 / T_all
            dP = torch.clamp(P_all[:, 1:] - P_all[:, :-1], min=0.0)
            dV = torch.clamp(V_all[:, 1:] - V_all[:, :-1], min=0.0)
            running = jobs.status == JobStatus.RUNNING
            below = k_idx[None, :] <= jobs.f_idx[:, None]
            can = running[:, None] & below & (dV > 0)
            rho = torch.where(can, dP / torch.clamp(dV, min=1e-12),
                              torch.full_like(dP, math.inf))
            flat = rho.reshape(-1)
            idx = int(torch.argmin(flat))
            ok = bool(torch.isfinite(flat[idx]))
            self.ctl_ties += int(ok and int((flat == flat[idx]).sum()) > 1)
            self._plain["host_reads"] += 1
            if ok:
                j, tgt = divmod(idx, n_f - 1)
                jobs.f_idx[j] = tgt
                jobs.spu[j] = T_all[j, tgt].to(f32)
                jobs.watts[j] = P_all[j, tgt].to(f32)
            live = ok and bool(self._total_power(st) > cap)

    def _handle_log(self, st: SimState, powers):
        """The control step, then the per-DC cluster row and the log clock
        (``powers``: this step's accrual power; the row takes the DCs' power
        summed again after a cap controller, which changes it)."""
        p, fleet = self.params, self.fleet
        self._control(st)
        if self.cap_on:
            powers = self._dc_power(st.jobs, st.dc.busy)
        jobs = st.jobs
        running = jobs.status == JobStatus.RUNNING
        tpt = torch.where(running, 1.0 / jobs.spu, self.zero_f)
        acc = dc_sum(fmul_pinned(tpt, p.log_interval), jobs.dc, fleet.n_dc)
        st.dc.acc_job_unit = st.dc.acc_job_unit + acc
        one = running.to(torch.int32)
        run_tot = dc_count(one, jobs.dc, fleet.n_dc)
        run_inf = dc_count(torch.where(jobs.jtype == 0, one, torch.zeros_like(one)),
                           jobs.dc, fleet.n_dc)
        q_inf, q_trn = self._queue_lens(st)
        busy = st.dc.busy
        total = self.total_gpus
        # XLA rewrites a division by a compile-time constant into a multiply
        # by its float32 reciprocal; these two divisors are constants there
        util_inst = busy * self.inv_total
        elapsed = torch.clamp(st.t - st.t_first, min=1e-9)
        util_avg = st.dc.util_gpu_time / (total * elapsed)
        f = torch.float32
        rows = torch.stack([
            st.t.to(f).expand(fleet.n_dc),
            self.freq_levels[st.dc.cur_f_idx],
            busy.to(f), (total - busy).to(f), run_tot.to(f), run_inf.to(f),
            (run_tot - run_inf).to(f), q_inf.to(f), q_trn.to(f),
            util_inst.to(f), util_avg.to(f), st.dc.acc_job_unit,
            powers.to(f), (st.dc.energy_j * self.inv_1000).to(f),
        ], dim=-1)
        st.next_log_t = st.next_log_t + self.log_interval
        return rows

    # ---------------- the step ----------------

    def _head(self, st: SimState):
        """Event-min head and exact accrual over [t, t_adv] (in place).

        Returns (host ints [branch, has_slot, slot, can, j_fin, j_x, a_idx,
        dc_fin, jt_fin, dc_x, jt_x], powers) from ONE host read."""
        jobs = st.jobs
        running = jobs.status == JobStatus.RUNNING
        runT = torch.where(running, jobs.spu, self.inf.to(torch.float32))
        fin_ok = torch.isfinite(runT)
        rem = torch.clamp(jobs.size - jobs.units_done, min=0.0)
        # the float32 product, then the clock's add (torch would keep a
        # [J] float32 operand's dtype beside a 0-d float64 clock)
        t_fin_all = torch.where(fin_ok, st.t + fmul_pinned(rem, runT).to(self.td),
                                self.inf)
        j_fin = torch.argmin(t_fin_all)
        t_av_all = torch.where(jobs.status == JobStatus.XFER, jobs.t_avail,
                               self.inf)
        j_x = torch.argmin(t_av_all)
        arr_flat = st.next_arrival.reshape(-1)
        a_idx = torch.argmin(arr_flat)
        cand = torch.stack([t_fin_all[j_fin], t_av_all[j_x], arr_flat[a_idx],
                            st.next_log_t])
        kind = torch.argmin(cand)
        t_next = cand[kind]
        past_end = (t_next > self.end) | ~torch.isfinite(t_next) | st.done
        t_adv = torch.where(past_end, self.end, t_next)
        dt = torch.clamp(t_adv - st.t, min=0.0)
        busy = st.dc.busy
        powers = self._dc_power(jobs, busy)
        # float32 x clock -> the clock's dtype (the product and its fence)
        e_inc = fmul_pinned(powers.to(self.td), dt)
        u_inc = fmul_pinned(busy.to(self.td), dt)
        accrue = st.started_accrual & ~st.done
        st.dc.energy_j = st.dc.energy_j + torch.where(accrue, e_inc, self.zero_f)
        st.dc.util_gpu_time = st.dc.util_gpu_time + torch.where(accrue, u_inc,
                                                                self.zero_f)
        dt_f = dt.to(torch.float32)
        prog = torch.where(fin_ok, dt_f / torch.where(fin_ok, runT,
                                                      torch.ones_like(runT)),
                           self.zero_f)
        jobs.units_done = torch.minimum(jobs.size, jobs.units_done + prog)
        st.t_first = torch.where(st.started_accrual, st.t_first, t_adv)
        st.t = t_adv
        st.started_accrual = torch.ones_like(st.started_accrual)
        st.done = st.done | past_end
        branch = torch.where(st.done, torch.full_like(kind, EV_NOOP), kind)
        empty = (jobs.status == JobStatus.EMPTY).to(torch.int32)
        slot = torch.argmax(empty)
        dc_x, jt_x = jobs.dc[j_x], jobs.jtype[j_x]
        free_x = self.total_gpus[dc_x] - busy[dc_x]
        r = self.params.reserve_inf_gpus
        if r > 0:
            free_x = torch.where(jt_x == 1, torch.clamp(free_x - r, min=0), free_x)
        can = free_x > 0
        i64 = torch.int64
        vals = torch.stack([branch.to(i64), empty[slot].to(i64), slot.to(i64),
                            can.to(i64),
                            j_fin.to(i64), j_x.to(i64), a_idx.to(i64),
                            jobs.dc[j_fin].to(i64), jobs.jtype[j_fin].to(i64),
                            dc_x.to(i64), jt_x.to(i64)]).tolist()
        self._plain["host_reads"] += 1
        return vals, powers

    def _step(self, st: SimState, pre, key_host, em, i: int):
        """One event (reference ``Engine._step``, non-RL planner program).
        Returns the advanced host key pair."""
        (branch, has_slot, slot, can, j_fin, j_x, a_idx,
         dc_fin, jt_fin, dc_x, jt_x), powers = self._head(st)
        key_host, k_ev = prng.split_int(key_host, 2)
        em["t"][i] = st.t.to(torch.float32)
        if branch == EV_NOOP:
            return key_host
        em["branch"][i] = branch
        push = None
        if branch == EV_FINISH:
            plan, job_row = self._plan_finish(st, j_fin, dc_fin, jt_fin)
            em["job"][i] = job_row
            self._commit_plan(st, plan)
            self._drain_queues(st, dc_fin, enabled=True)
        elif branch == EV_XFER:
            plan, push = self._plan_xfer(st, j_x, dc_x, jt_x, bool(can))
            self._commit_plan(st, plan)
            if push is not None:
                self._ring_push(st, push)
            else:  # iteration 0 of the shared drain is the xfer start
                self._drain_queues(st, dc_x, enabled=False, xfer_j=j_x)
        elif branch == EV_ARRIVAL:
            ing, jt = divmod(a_idx, 2)
            plan, push = self._plan_arrival(st, ing, jt, k_ev, pre,
                                            bool(has_slot), slot)
            self._commit_plan(st, plan)
            if push is not None:
                self._ring_push(st, push)
        else:  # EV_LOG
            em["cluster"][i] = self._handle_log(st, powers)
        st.n_events += 1
        return key_host

    def rl_emissions(self, n_steps: int):
        """Zeroed per-step RL transition records ([n_steps, ...] leaves, the
        JAX package's ``emission["rl"]`` keys)."""
        dev, n_dc = self.device, self.fleet.n_dc
        f32, i32, b = torch.float32, torch.int32, torch.bool
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        n, d = n_steps, self.obs_dim
        return {"valid": z((n,), b), "s0": z((n, d), f32), "s1": z((n, d), f32),
                "a_dc": z((n,), i32), "a_g": z((n,), i32),
                "mask_dc0": z((n, n_dc), b), "mask_g0": z((n, self.n_g), b),
                "r": z((n,), f32), "costs": z((n, 4), f32),
                "mask_dc": z((n, n_dc), b), "mask_g": z((n, self.n_g), b)}

    def scan_plain(self, st: SimState, pre, n_steps: int, policy_params=None):
        """The plain step loop over one single state (in place): B1's
        plain version.  ``pre`` holds one lane's tables; ``policy_params`` is
        the chsac_af policy's (``policy_apply``'s first argument).  Returns
        (emissions with ``branch`` [n] int32 and, under chsac_af, ``rl``,
        {"events", "host_reads"})."""
        dev = self.device
        n_dc = self.fleet.n_dc
        em = {"t": torch.zeros((n_steps,), dtype=torch.float32, device=dev),
              "cluster": torch.zeros((n_steps, n_dc, len(CLUSTER_COLS)),
                                     dtype=torch.float32, device=dev),
              "job": torch.zeros((n_steps, len(JOB_COLS)), dtype=torch.float32,
                                 device=dev),
              "branch": [EV_NOOP] * n_steps}
        if self.rl:
            if self.policy_apply is None:
                raise ValueError("chsac_af requires a policy_apply callable")
            em["rl"] = self.rl_emissions(n_steps)
        self._plain = {"events": 0, "host_reads": 1}
        key_host = tuple(st.key.tolist())
        done = bool(st.done)
        i = 0
        while i < n_steps and not done:
            if self.rl:
                key_host = self._step_rl(st, pre, key_host, em, i, policy_params)
            else:
                key_host = self._step(st, pre, key_host, em, i)
            done = em["branch"][i] == EV_NOOP
            if not done:
                self._plain["events"] += 1
            i += 1
        if i < n_steps:
            # the rest of the chunk after `done`: each step only advances
            # the key (t has reached the end, accrual and progress add zero)
            # and, under chsac_af, emits the same record of the final state
            em["t"][i:] = st.t.to(torch.float32)
            if self.rl:
                row, _, _ = self._tail(st, REQ_NONE, 0, self._zero_fin(),
                                       None, policy_params)
                for k, v in row.items():
                    em["rl"][k][i:] = v
            for _ in range(n_steps - i):
                key_host = prng.split_int(key_host, 3 if self.rl else 2)[0]
        st.key = torch.tensor(key_host, dtype=torch.int64, device=dev)
        em["branch"] = torch.tensor(em["branch"], dtype=torch.int32, device=dev)
        return em, dict(self._plain)

    # ---------------- chsac_af: the RL step and its policy tail ----------------

    def _chsac_nf(self, dcj, jt, free, a_g):
        """THE chsac sizing rule: n = clamp(a_g + 1, 1, min(free, cap)),
        f = the energy argmin at that n (int32 tensors)."""
        cap = torch.clamp(free, max=self.params.max_gpus_per_job)
        n = torch.clamp(torch.minimum(a_g + 1, cap), min=1).to(torch.int32)
        # n may exceed the grid's n_max (max_gpus_per_job above it): XLA's
        # gather clamps the row index, and so does the port
        row = torch.clamp(n, max=self.fleet.n_max)
        return n, algos.best_energy_f_idx_at_n(self.E_grid, dcj, jt, row)

    def _zero_fin(self):
        dev, f32, i32 = self.device, torch.float32, torch.int32
        return {"valid": torch.zeros((), dtype=torch.bool, device=dev),
                "s0": torch.zeros((self.obs_dim,), dtype=f32, device=dev),
                "a_dc": torch.zeros((), dtype=i32, device=dev),
                "a_g": torch.zeros((), dtype=i32, device=dev),
                "mask_dc0": torch.zeros((self.fleet.n_dc,), dtype=torch.bool,
                                        device=dev),
                "mask_g0": torch.zeros((self.n_g,), dtype=torch.bool, device=dev),
                "r": self.zero_f, "gpu_over": self.zero_f,
                "jt": 0, "dcj": 0, "slot": 0, "sojourn": self.zero_f}

    def _fin_record(self, st: SimState, j: int, dcj: int, jt: int, plan):
        """The finish branch's partial RL transition (reference
        ``_plan_finish``'s chsac record): s0, the action and masks stored at
        selection time, the reward ``-w E_unit_kWh + 0.05 / n_act`` with
        both products pinned, and ``gpu_over`` against ``min_n_for_sla``."""
        p = self.params
        jobs = st.jobs
        E_pred = jobs.spu[j] * jobs.watts[j]
        E_unit_kwh = E_pred * self.inv_kwh
        n_act = torch.clamp(jobs.rl_a_g[j] + 1, min=1).to(torch.float32)
        r = (fmul_pinned(E_unit_kwh, self.neg_w)
             + fmul_pinned(1.0 / n_act, self.c005))
        tc = LatencyCoeffs(*(a[dcj, jt] for a in self.latency))
        f_used = self.freq_levels[jobs.f_idx[j]]
        n_min = min_n_for_sla(jobs.size[j], f_used, tc, p.sla_p99_ms,
                              p.max_gpus_per_job)
        gpu_over = torch.clamp(jobs.n[j] - n_min, min=0).to(torch.float32)
        return {"valid": jobs.rl_valid[j].clone(), "s0": jobs.rl_obs0[j].clone(),
                "a_dc": jobs.rl_a_dc[j].clone(), "a_g": jobs.rl_a_g[j].clone(),
                "mask_dc0": jobs.rl_mask_dc0[j].clone(),
                "mask_g0": jobs.rl_mask_g0[j].clone(),
                "r": r, "gpu_over": gpu_over, "jt": jt, "dcj": dcj, "slot": j,
                "sojourn": plan["sojourn"]}

    def _plan_arrival_rl(self, st: SimState, ing: int, jt: int, pre,
                         has_slot: bool, slot: int):
        """chsac arrival planner: the pregenerated draw, no routing (the
        policy tail routes), an XFER row placeholder (DC 0, t_avail inf) or
        a drop when the slab is full; the stream clock advances."""
        stream = ing * 2 + jt
        n_tab = pre["sizes"].shape[1]
        idx = torch.clamp(st.arr_count[ing, jt] - pre["c0"][stream],
                          max=n_tab - 1).to(torch.int64)
        size = pre["sizes"][stream].index_select(0, idx.reshape(1))[0]
        t_next_arr = pre["tnext"][stream].index_select(0, idx.reshape(1))[0]
        jid = st.jid_counter.clone()
        plan = {"kind": EV_ARRIVAL, "row": slot, "place": has_slot,
                "jtype": jt, "ingress": ing, "dc": 0, "seq": jid,
                "size": size, "t_ingress": st.t.clone(), "t_avail": self.inf,
                "net_lat_s": self.zero_f}
        if not has_slot:
            st.n_dropped += 1
        st.jid_counter += 1
        st.next_arrival[ing, jt] = t_next_arr.to(self.td)
        st.arr_count[ing, jt] += 1
        return plan

    def _tail(self, st: SimState, req_kind: int, req_idx: int, fin, k_act,
              pp):
        """The policy tail's head and dispatch (reference ``_tail_head`` +
        ``_policy_tail_planned``): (the step's RL record, the tail plan, the
        tail's start request).  The drain's ring pop is applied here."""
        p, fleet = self.params, self.fleet
        jobs, busy = st.jobs, st.dc.busy
        perc2 = algos.windowed_percentile(st.lat.buf, st.lat.count, 99.0)
        q_inf, q_trn = self._queue_lens(st)
        obs = algos.rl_obs(fleet, st.t, busy, st.dc.cur_f_idx, q_inf, q_trn,
                           self.obs_consts)
        extra = 0
        if p.reserve_inf_gpus > 0:
            jt_req = 0
            if req_kind == REQ_ROUTE:
                jt_req = int(jobs.jtype[req_idx])
            elif req_kind == REQ_DRAIN:
                jt_req = int(self._ring_head(st, req_idx)[1])
            extra = p.reserve_inf_gpus if jt_req == 1 else 0
        m_dc, m_g = algos.rl_masks(p, fleet, busy, st.lat.count, perc2,
                                   self.total_gpus, extra)
        jt_f = fin["jt"]
        p99_ms = torch.where(st.lat.count[jt_f] >= 5, perc2[jt_f] * self.c1000,
                             fin["sojourn"] * self.c1000)
        P_now = self._dc_power(jobs, busy)[fin["dcj"]]
        e_sum = st.dc.energy_j[0]
        for d in range(1, fleet.n_dc):  # XLA's sum over a short axis: a left fold
            e_sum = e_sum + st.dc.energy_j[d]
        row = {"valid": fin["valid"], "s0": fin["s0"], "s1": obs,
               "a_dc": fin["a_dc"], "a_g": fin["a_g"],
               "mask_dc0": fin["mask_dc0"], "mask_g0": fin["mask_g0"],
               "r": fin["r"],
               "costs": torch.stack([p99_ms, P_now, fin["gpu_over"],
                                     e_sum.to(torch.float32)]),
               "mask_dc": m_dc, "mask_g": m_g}
        if req_kind == REQ_NONE:
            return row, None, None
        # the forward runs only when its action is used (a step's key split
        # and every emitted value are the same either way)
        key = torch.tensor(k_act, dtype=torch.int64, device=self.device)
        a_dc, a_g = self.policy_apply(pp, obs, m_dc, m_g, key)
        a_dc, a_g = a_dc.to(torch.int32), a_g.to(torch.int32)
        rl = {"rl_obs0": obs, "rl_a_dc": a_dc, "rl_a_g": a_g,
              "rl_mask_dc0": m_dc, "rl_mask_g0": m_g}
        if req_kind == REQ_ROUTE:
            slot = req_idx
            jt_s, ing_s = jobs.jtype[slot], jobs.ingress[slot]
            transfer = self.transfer_s[ing_s, a_dc, jt_s]
            tplan = {"row": slot, "mat": False, "rt": True, "rl": True,
                     "dc": a_dc, "t_avail": st.t + transfer.to(self.td),
                     "net_lat_s": self.net_lat_s[ing_s, a_dc], **rl}
            return row, tplan, None
        # REQ_DRAIN: the finishing DC's ring head, re-materialized into the
        # slot the finish freed and started where the policy sends it
        dcj = req_idx
        rec, jt_sel, found = self._ring_head(st, dcj)
        slot = fin["slot"]
        free_tgt = self._free_for(busy, a_dc, jt_sel)
        ok = bool(found & (free_tgt > 0))
        self._plain["host_reads"] += 1
        n, f_idx = self._chsac_nf(a_dc, jt_sel, free_tgt, a_g)
        tplan = {"row": slot, "mat": ok, "rt": False, "rl": ok, "dc": a_dc,
                 "rec": rec, "jtype": jt_sel, **rl}
        sreq = {"enabled": ok, "j": slot, "n": n, "f_idx": f_idx,
                "new_dc_f": st.dc.cur_f_idx[a_dc].clone(), "dcj": a_dc,
                "jt": jt_sel, "t_start0": rec[QRec.T_START],
                "preempt_t0": rec[QRec.PREEMPT_T],
                "tpt0": rec[QRec.TOTAL_PREEMPT_TIME].to(torch.float32)}
        if ok:
            st.queues.head[dcj, int(jt_sel)] += 1
        return row, tplan, sreq

    def _commit_tail(self, st: SimState, tplan, sreq, row_s) -> None:
        """The chsac step's second commit (reference ``_commit_tail``, ring
        layout), in place: the tail plan's route / materialize and RL-trace
        writes at ``tplan["row"]``, and the step's one start request at
        ``row_s`` (which wins where the two coincide)."""
        jobs = st.jobs
        if tplan is not None:
            j = tplan["row"]
            if tplan["mat"]:
                rec = tplan["rec"]
                jobs.status[j] = JobStatus.QUEUED
                jobs.jtype[j] = tplan["jtype"]
                jobs.ingress[j] = rec[QRec.INGRESS].to(torch.int32)
                jobs.seq[j] = rec[QRec.SEQ].to(torch.int32)
                jobs.size[j] = rec[QRec.SIZE].to(torch.float32)
                jobs.units_done[j] = rec[QRec.UNITS_DONE].to(torch.float32)
                jobs.n[j] = 0
                jobs.f_idx[j] = self.default_f_idx
                jobs.t_ingress[j] = rec[QRec.T_INGRESS]
                jobs.t_avail[j] = rec[QRec.T_AVAIL]
                jobs.t_start[j] = rec[QRec.T_START]
                jobs.net_lat_s[j] = rec[QRec.NET_LAT_S].to(torch.float32)
                jobs.preempt_count[j] = rec[QRec.PREEMPT_COUNT].to(torch.int32)
                jobs.preempt_t[j] = rec[QRec.PREEMPT_T]
                jobs.total_preempt_time[j] = rec[QRec.TOTAL_PREEMPT_TIME].to(
                    torch.float32)
            if tplan["rt"]:
                jobs.t_avail[j] = tplan["t_avail"]
                jobs.net_lat_s[j] = tplan["net_lat_s"]
            if tplan["rl"]:
                jobs.dc[j] = tplan["dc"]
                jobs.rl_obs0[j] = tplan["rl_obs0"]
                jobs.rl_a_dc[j] = tplan["rl_a_dc"]
                jobs.rl_a_g[j] = tplan["rl_a_g"]
                jobs.rl_mask_dc0[j] = tplan["rl_mask_dc0"]
                jobs.rl_mask_g0[j] = tplan["rl_mask_g0"]
            if tplan["mat"] or tplan["rl"]:
                jobs.rl_valid[j] = True
        if sreq is None or not sreq["enabled"]:
            return
        # `_start_job` parity: clamp to free, cached physics, stamps
        dcj, jt = sreq["dcj"], sreq["jt"]
        free = self._free_for(st.dc.busy, dcj, jt)
        n = torch.clamp(torch.minimum(sreq["n"], free), min=1).to(torch.int32)
        f_start = sreq["f_idx"]
        spu, watts = self._row_TP(dcj, jt, n, f_start)
        t = st.t
        j = row_s
        jobs.status[j] = JobStatus.RUNNING
        jobs.n[j] = n
        jobs.f_idx[j] = f_start
        jobs.t_start[j] = torch.where(sreq["t_start0"] <= 0.0, t,
                                      sreq["t_start0"])
        jobs.preempt_t[j] = 0.0
        jobs.total_preempt_time[j] = sreq["tpt0"] + torch.where(
            sreq["preempt_t0"] > 0.0, (t - sreq["preempt_t0"]).to(torch.float32),
            self.zero_f)
        jobs.spu[j] = spu
        jobs.watts[j] = watts
        st.dc.busy[dcj] += n
        st.dc.cur_f_idx[dcj] = sreq["new_dc_f"]

    def _step_rl(self, st: SimState, pre, key_host, em, i: int, pp):
        """One chsac_af event (reference ``Engine._step`` with the planner
        policy tail).  Returns the advanced host key pair."""
        (branch, has_slot, slot, can, j_fin, j_x, a_idx,
         dc_fin, jt_fin, dc_x, jt_x), powers = self._head(st)
        key_host, _k_ev, k_act = prng.split_int(key_host, 3)
        em["t"][i] = st.t.to(torch.float32)
        fin = self._zero_fin()
        req_kind, req_idx, sreq_evt = REQ_NONE, 0, None
        if branch == EV_FINISH:
            plan, job_row = self._plan_finish(st, j_fin, dc_fin, jt_fin)
            fin = self._fin_record(st, j_fin, dc_fin, jt_fin, plan)
            em["job"][i] = job_row
            self._commit_plan(st, plan)
            req_kind, req_idx = REQ_DRAIN, dc_fin
        elif branch == EV_XFER:
            jobs = st.jobs
            if not can:  # queue-on-full: evict the row into its DC's ring
                plan, push = self._plan_xfer(st, j_x, dc_x, jt_x, False)
                self._commit_plan(st, plan)
                self._ring_push(st, push)
            else:  # the start rides the tail's commit
                free = self._free_for(st.dc.busy, dc_x, jt_x)
                n, f_idx = self._chsac_nf(dc_x, jt_x, free, jobs.rl_a_g[j_x])
                sreq_evt = {"enabled": True, "j": j_x, "n": n, "f_idx": f_idx,
                            "new_dc_f": st.dc.cur_f_idx[dc_x].clone(),
                            "dcj": dc_x, "jt": jt_x,
                            "t_start0": jobs.t_start[j_x].clone(),
                            "preempt_t0": jobs.preempt_t[j_x].clone(),
                            "tpt0": jobs.total_preempt_time[j_x].clone()}
        elif branch == EV_ARRIVAL:
            ing, jt = divmod(a_idx, 2)
            plan = self._plan_arrival_rl(st, ing, jt, pre, bool(has_slot), slot)
            self._commit_plan(st, plan)
            if has_slot:
                req_kind, req_idx = REQ_ROUTE, slot
        elif branch == EV_LOG:
            em["cluster"][i] = self._handle_log(st, powers)
        if branch != EV_NOOP:
            em["branch"][i] = branch
        row, tplan, sreq_tail = self._tail(st, req_kind, req_idx, fin, k_act, pp)
        for k, v in row.items():
            em["rl"][k][i] = v
        if branch == EV_XFER:
            self._commit_tail(st, tplan, sreq_evt, j_x)
        else:
            self._commit_tail(st, tplan, sreq_tail,
                              tplan["row"] if tplan is not None else 0)
        if branch != EV_NOOP:
            st.n_events += 1
        return key_host
