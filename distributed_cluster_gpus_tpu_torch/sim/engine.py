"""Event-exact simulation engine: a chunk of events through the B1 kernel.

Counterpart of ``distributed_cluster_gpus_tpu/sim/engine.py`` for the
programs the port runs (the step itself and its plain version are in
``sim/step.py``).  ``Engine.run_chunk`` runs a chunk through
``kernels/event_scan.py``: on the card the B1 kernel (``csrc/event_scan.cu``)
advances every rollout lane in one launch, and nothing in ``run_chunk``
reads the card; on the CPU the plain step loop
(``StepProgram.scan_plain``) does, lane by lane.

A state either is single or carries a leading lane axis ``[R, ...]`` on every
leaf (``parallel/rollout.py``).  The state is updated in place (the JAX
engine donates its state to the same effect): ``run_chunk`` returns the
object it was given.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.event_scan import event_scan
from ..models.structs import (ALGO_CHSAC_AF, PORTED_ALGOS, DCArrays,
                              FleetSpec, JobSlab, LatWindow, QRec, QueueRings,
                              SignalState, SimParams, SimState, n_lanes,
                              with_lane_axis)
from ..ops import prng
from ..ops.bandit import bandit_init
from ..workload.compiler import compile_workload
from .step import EV_FINISH, EV_LOG, StepProgram


def check_ported(params: SimParams) -> None:
    """Refuse configurations whose code paths later slices port."""
    todo = []
    if params.algo not in PORTED_ALGOS:
        todo.append(f"algo {params.algo!r}")
    if params.elastic_scaling:
        todo.append("elastic scaling (ROADMAP queue A item 13)")
    if params.queue_mode != "ring":
        todo.append("queue_mode 'slab' (ROADMAP queue A item 13)")
    if params.superstep_k != 1:
        todo.append("superstep_k > 1 (ROADMAP queue A item 13)")
    if params.faults is not None:
        todo.append("fault injection (ROADMAP queue A item 11)")
    if params.obs_enabled:
        todo.append("in-loop telemetry (ROADMAP queue A item 12)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))

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
        total_preempt_time=z32((J,)), spu=z32((J,)), watts=z32((J,)),
        rl_obs0=z32((J, params.obs_dim(n_dc))), rl_a_dc=zi((J,)),
        rl_a_g=zi((J,)),
        rl_mask_dc0=torch.zeros((J, n_dc), dtype=torch.bool, device=dev),
        rl_mask_g0=torch.zeros((J, params.max_gpus_per_job), dtype=torch.bool,
                               device=dev),
        rl_valid=torch.zeros((J,), dtype=torch.bool, device=dev))
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
    signals = None
    if workload.signals is not None:
        signals = SignalState(cost_usd=z32((n_dc,)), carbon_g=z32((n_dc,)))
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
        lat=lat, bandit=bandit_init(n_dc, fleet.n_f, dev), queues=queues,
        n_events=zi(), n_finished=zi((2,)), units_finished=z32((2,)),
        n_dropped=zi(), done=torch.zeros((), dtype=torch.bool, device=dev),
        signals=signals)


def _lane0(em):
    return {k: (_lane0(v) if isinstance(v, dict) else v[0]) for k, v in em.items()}


class Engine(StepProgram):
    """Stepper for one (fleet, params) on one device (default: the card).

    ``policy_apply(policy_params, obs, mask_dc, mask_g, key) -> (a_dc, a_g)``
    is required for chsac_af and ignored otherwise.  On the card the B1
    kernel runs the port's own policy (``rl.sac.make_policy_apply``) from
    ``policy_params``' weights; another callable runs only on the CPU."""

    def __init__(self, fleet: FleetSpec, params: SimParams, device="cuda", *,
                 policy_apply=None):
        check_ported(params)
        if params.algo == ALGO_CHSAC_AF and policy_apply is None:
            raise ValueError("chsac_af requires a policy_apply callable")
        workload = compile_workload(fleet, params, device)
        super().__init__(fleet, params, device, signals=workload.signals)
        self.policy_apply = policy_apply
        self.workload = workload
        #: the last run_chunk call: steps, events (all lanes; on the card a
        #: 0-d device tensor, read only by whoever asks) and, on the CPU,
        #: the plain loop's host reads inside the chunk (None on the card:
        #: the engine cannot count them there; chip_smoke.py measures them
        #: with the profiler)
        self.stats = {"steps": 0, "events": 0, "host_reads": 0}

    def run_chunk(self, state: SimState, n_steps: int, pre=None,
                  policy_params=None):
        """Advance ``n_steps`` events in place; returns (state, emissions).

        ``state`` is single or lane-stacked ([R, ...] leaves); the chunk runs
        through ``kernels/event_scan.event_scan`` (the B1 kernel on the card,
        the plain loop on the CPU).  ``pre`` injects the chunk's arrival
        tables ({"sizes", "tnext", "cum", "c0"}, e.g. the JAX reference's,
        converted; a lane axis first for a lane-stacked state); None builds
        them with ``workload.tables`` (the B2 kernel on the card).  Emissions
        are per-step records: "t" [n] f32, "cluster_valid"/"job_valid" [n]
        bool, "cluster" [n, n_dc, 14] (16 with signal timelines: the
        price and carbon columns) and "job" [n, 15] f32 (zero where
        invalid), each with a leading [R] for a lane-stacked state; under
        chsac_af also "rl", the per-step transition records (the JAX
        package's keys), acting with ``policy_params``."""
        single = n_lanes(state) is None
        lanes = with_lane_axis(state) if single else state
        if pre is None:
            pre = self.workload.tables(lanes, n_steps)
        elif single:
            pre = {k: v.unsqueeze(0) for k, v in pre.items()}
        pre = {k: v.to(self.device).contiguous() for k, v in pre.items()}
        before = lanes.n_events.clone()
        em, stats = event_scan(self, lanes, pre, n_steps, policy_params)
        self.workload.advance_carries(lanes, pre)
        if stats["events"] is None:
            # the kernel's chunk: the events it ran, left on the card (no
            # host read: the pipelined loop dispatches the next chunk first)
            stats["events"] = (lanes.n_events - before).sum()
        self.stats = {"steps": n_steps, **stats}
        branch = em.pop("branch")
        em["cluster_valid"] = branch == EV_LOG
        em["job_valid"] = branch == EV_FINISH
        if single:
            em = _lane0(em)
        return state, em
