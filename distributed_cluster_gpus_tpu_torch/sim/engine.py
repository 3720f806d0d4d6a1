"""Event-exact simulation engine, one event at a time, in plain torch.

Counterpart of ``distributed_cluster_gpus_tpu/sim/engine.py`` for the
program this slice ports: the non-RL heuristic algorithms
(``default_policy``, ``joint_nf``), ring queues, one event per step
(superstep K=1), faults / signals / telemetry off, the write-plan commit.
Every step:

1. computes the next event time as a min over the arrival clocks, the
   projected finish times of running jobs, pending WAN-transfer
   completions and the log tick (ties: finish < xfer < arrival < log, then
   lowest index, as ``jnp.argmin``/``torch.argmin`` both break them);
2. accrues energy (``E += P * dt``), GPU time and job progress over the
   exact inter-event gap;
3. applies that one event through its planner and the shared commit, then
   the step's single ring push and the post-switch queue drain.

Unlike the JAX step, which runs every branch masked under ``lax.switch``,
this step reads the event kind back to the host once per event (together
with the few integers the branch indexes by) and runs only the branch that
fires; a queue drain reads one flag per admitted job.  ``Engine.stats``
counts these host reads per chunk.  Float values round exactly as the JAX
program rounds them (``fmul_pinned`` products, the fixed ``tree_sum_last``
association, float32 throughout), so given the reference's arrival tables
the run is bit-identical; ``tests/test_torch_engine.py`` holds it so.  This
engine is the oracle of the event-scan kernel (ROADMAP queue B item B1).

The state is updated in place (the JAX engine donates its state to the
same effect): ``run_chunk`` returns the object it was given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.structs import (ALGO_JOINT_NF, PORTED_ALGOS, DCArrays,
                              FleetSpec, JobSlab, JobStatus, LatWindow, QRec,
                              QueueRings, SimParams, SimState)
from ..ops import prng
from ..ops.arrivals import tmod
from ..ops.physics import (LatencyCoeffs, PowerCoeffs, fmul_pinned,
                           step_time_s, task_power_w)
from ..workload.compiler import compile_workload
from . import algos

EV_FINISH, EV_XFER, EV_ARRIVAL, EV_LOG, EV_NOOP = 0, 1, 2, 3, 4

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


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a GPU raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def check_ported(params: SimParams) -> None:
    """Refuse configurations whose code paths later slices port."""
    todo = []
    if params.algo not in PORTED_ALGOS:
        todo.append(f"algo {params.algo!r} (ROADMAP queue A items 5, 6 and 9)")
    if params.queue_mode != "ring":
        todo.append("queue_mode 'slab' (ROADMAP queue A item 13)")
    if params.superstep_k != 1:
        todo.append("superstep_k > 1 (ROADMAP queue A item 13)")
    if params.faults is not None:
        todo.append("fault injection (ROADMAP queue A item 11)")
    if params.obs_enabled:
        todo.append("in-loop telemetry (ROADMAP queue A item 12)")
    if params.time_dtype != "float32":
        todo.append("the float64 clock (ROADMAP queue A item 6)")
    if params.router_weights is not None:
        todo.append("weighted routing (ROADMAP queue A item 5)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


# ---------------------------------------------------------------------------
# fixed-association reductions over the tiny DC axis
# ---------------------------------------------------------------------------

def tree_sum_last(x):
    """Sum over the last axis with the reference's fixed halving-tree
    association (zero-padded to a power of two).  Never ``torch.sum`` on
    floats here: its order is not the reference's."""
    n = x.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.cat([x, torch.zeros(x.shape[:-1] + (p - n,), dtype=x.dtype,
                                      device=x.device)], dim=-1)
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


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


def auto_queue_cap(params: SimParams, fleet: FleetSpec, rollouts: int = 1) -> int:
    """Per-(dc, jtype) ring depth that absorbs the whole run's arrivals
    (the reference's sizing rule, clamped to [1024, 2^18])."""
    if params.workload is not None:
        rate = params.workload.mean_rate(fleet.n_ing)
    else:
        rate = 0.0
        if params.inf_mode != "off":
            rate += params.inf_rate * fleet.n_ing
        if params.trn_mode != "off":
            rate += params.trn_rate * fleet.n_ing
    need = int(min(params.duration, 1e7) * rate * 1.3) + 1024
    rec_bytes = QRec.N_FIELDS * (8 if params.time_dtype == "float64" else 4)
    mem_cap = max(1024, int((2 << 30)
                            // (max(1, rollouts) * fleet.n_dc * 2 * rec_bytes)))
    return int(max(1024, min(need, 1 << 18, mem_cap)))


def init_state(key, fleet: FleetSpec, params: SimParams, workload=None,
               device="cuda") -> SimState:
    """Fresh SimState at t=0 with primed arrival clocks, on ``device``.

    ``key`` is an int seed or a [2] key-word tensor (``ops.prng.key``)."""
    dev = resolve_device(device)
    check_ported(params)
    if not torch.is_tensor(key):
        key = prng.key(key, dev)
    key = key.to(dev)
    J = params.job_cap
    n_dc, n_ing = fleet.n_dc, fleet.n_ing
    td = params.tdtype
    ks = prng.split(key, 2)
    key, k_arr = ks[0].clone(), ks[1].clone()
    if workload is None:
        workload = compile_workload(fleet, params, dev)
    clocks = workload.init_clocks(k_arr, td)

    def zf(shape=()):
        return torch.zeros(shape, dtype=td, device=dev)

    def zi(shape=()):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def z32(shape=()):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    jobs = JobSlab(
        status=zi((J,)), jtype=zi((J,)), ingress=zi((J,)), dc=zi((J,)),
        seq=zi((J,)), size=z32((J,)), units_done=z32((J,)),
        n=zi((J,)), f_idx=zi((J,)),
        t_ingress=zf((J,)), t_avail=zf((J,)), t_start=zf((J,)),
        net_lat_s=z32((J,)), preempt_count=zi((J,)), preempt_t=zf((J,)),
        total_preempt_time=z32((J,)), spu=z32((J,)), watts=z32((J,)))
    dc = DCArrays(
        busy=zi((n_dc,)),
        cur_f_idx=torch.full((n_dc,), fleet.default_f_idx, dtype=torch.int32,
                             device=dev),
        energy_j=zf((n_dc,)), util_gpu_time=zf((n_dc,)),
        acc_job_unit=z32((n_dc,)))
    lat = LatWindow(buf=z32((2, params.lat_window)), count=zi((2,)),
                    ptr=zi((2,)))
    if params.queue_cap < 1:
        raise ValueError(
            "queue_cap < 1 with queue_mode='ring': 0 is the CLI auto-size "
            "sentinel — resolve it first (engine.auto_queue_cap)")
    queues = QueueRings(recs=zf((n_dc, 2, params.queue_cap, QRec.N_FIELDS)),
                        head=zi((n_dc, 2)), tail=zi((n_dc, 2)))
    return SimState(
        t=zf(), key=key, jid_counter=torch.ones((), dtype=torch.int32, device=dev),
        started_accrual=torch.zeros((), dtype=torch.bool, device=dev),
        t_first=zf(), dc=dc, jobs=jobs,
        next_arrival=clocks["next_arrival"].to(td),
        arr_key=k_arr,
        arr_count=torch.ones((n_ing, 2), dtype=torch.int32, device=dev),
        arr_cum=clocks["arr_cum"].to(td),
        arr_epoch=clocks["arr_epoch"].to(td),
        next_log_t=torch.tensor(params.log_interval, dtype=td, device=dev),
        lat=lat, queues=queues,
        n_events=zi(), n_finished=zi((2,)), units_finished=z32((2,)),
        n_dropped=zi(), done=torch.zeros((), dtype=torch.bool, device=dev))


class Engine:
    """Stepper for one (fleet, params) on one device (default: the card)."""

    def __init__(self, fleet: FleetSpec, params: SimParams, device="cuda"):
        check_ported(params)
        self.fleet = fleet
        self.params = params
        self.device = dev = resolve_device(device)
        self.workload = compile_workload(fleet, params, dev)
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
        #: host reads of the last run_chunk call (event heads + drain flags)
        self.stats = {"steps": 0, "events": 0, "host_reads": 0}

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
        """The non-RL admission dispatch: (n, f_idx, new DC ladder index)."""
        p = self.params
        if p.algo == ALGO_JOINT_NF:
            n, f_idx = algos.admit_joint_nf(self.E_grid_cap, dcj, jt)
            return n, f_idx, cur_f
        q_inf_len = (st.queues.tail[dcj, 0] - st.queues.head[dcj, 0])
        n, new_dc_f = algos.heuristic_select(p, self.fleet, jt, free, cur_f,
                                             q_inf_len)
        return n, new_dc_f, new_dc_f

    def _decide_start_vals(self, st: SimState, dcj: int, jt):
        """`_decide_nf_core` plus `_start_job`'s clamp and physics refresh."""
        free = self._free_for(st.dc.busy, dcj, jt)
        n_d, f_d, new_dc_f = self._decide_nf_core(st, dcj, jt, free,
                                                  st.dc.cur_f_idx[dcj])
        n_st = torch.clamp(torch.minimum(n_d.to(torch.int32), free), min=1)
        f_d = f_d.to(torch.int32)
        spu, watts = self._row_TP(dcj, jt, n_st, f_d)
        return n_st, f_d, new_dc_f.to(torch.int32), spu, watts

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
                self.stats["host_reads"] += 1
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
        n_st, f_d, new_dc_f, spu, watts = self._decide_start_vals(st, dcj, jt)
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
        uniform-random routing, the XFER placement (or a ring spill when the
        slab is full) and the stream-clock advance (applied here, in place)."""
        stream = ing * 2 + jt
        n_tab = pre["sizes"].shape[1]
        idx = torch.clamp(st.arr_count[ing, jt] - pre["c0"][stream],
                          max=n_tab - 1).to(torch.int64)
        size = pre["sizes"][stream].index_select(0, idx.reshape(1))[0]
        t_next_arr = pre["tnext"][stream].index_select(0, idx.reshape(1))[0]
        dc_sel = prng.randint_int(k_ev, self.fleet.n_dc)
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
            return
        if kind == EV_XFER:
            if plan["evict"]:
                jobs.status[j] = JobStatus.EMPTY
            return
        # EV_FINISH
        dcj, jt = plan["dc_row"], plan["fin_jt"]
        jobs.status[j] = JobStatus.EMPTY
        jobs.units_done[j] = plan["units_done"]
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

    # ---------------- the log tick ----------------

    def _handle_log(self, st: SimState, powers):
        """Per-DC cluster row + the log clock (``powers``: this step's accrual
        power, which nothing in a non-capped log tick changes)."""
        p, fleet = self.params, self.fleet
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
        t_fin_all = torch.where(fin_ok, st.t + fmul_pinned(rem, runT), self.inf)
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
        e_inc = fmul_pinned(powers, dt)
        u_inc = fmul_pinned(busy, dt)
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
        self.stats["host_reads"] += 1
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

    def run_chunk(self, state: SimState, n_steps: int, pre=None):
        """Advance ``n_steps`` events in place; returns (state, emissions).

        ``pre`` injects the chunk's arrival tables ({"sizes", "tnext",
        "cum", "c0"}, e.g. the JAX reference's, converted); None builds them
        with ``workload.tables`` (the B2 kernel on the card).  Emissions are
        per-step records: "t" [n] f32, "cluster_valid"/"job_valid" [n] bool,
        "cluster" [n, n_dc, 14] and "job" [n, 15] f32 (zero where invalid)."""
        st = state
        dev = self.device
        if pre is None:
            pre = self.workload.tables(st, n_steps)
        n_dc = self.fleet.n_dc
        em = {"t": torch.zeros((n_steps,), dtype=torch.float32, device=dev),
              "cluster": torch.zeros((n_steps, n_dc, len(CLUSTER_COLS)),
                                     dtype=torch.float32, device=dev),
              "job": torch.zeros((n_steps, len(JOB_COLS)), dtype=torch.float32,
                                 device=dev),
              "branch": [EV_NOOP] * n_steps}
        self.stats = {"steps": n_steps, "events": 0, "host_reads": 1}
        key_host = tuple(st.key.tolist())
        done = bool(st.done)
        i = 0
        while i < n_steps and not done:
            key_host = self._step(st, pre, key_host, em, i)
            done = em["branch"][i] == EV_NOOP
            if not done:
                self.stats["events"] += 1
            i += 1
        if i < n_steps:
            # the rest of the chunk after `done`: each step only advances
            # the key (t has reached the end, accrual and progress add zero)
            em["t"][i:] = st.t.to(torch.float32)
            for _ in range(n_steps - i):
                key_host = prng.split_int(key_host, 2)[0]
        st.key = torch.tensor(key_host, dtype=torch.int64, device=dev)
        self.workload.advance_carries(st, pre)
        branch = torch.tensor(em.pop("branch"), device=dev)
        em["cluster_valid"] = branch == EV_LOG
        em["job_valid"] = branch == EV_FINISH
        return st, em
