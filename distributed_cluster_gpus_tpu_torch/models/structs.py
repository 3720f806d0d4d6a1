"""Core state (dataclasses of tensors) and static world/run configuration.

PyTorch counterpart of ``distributed_cluster_gpus_tpu/models/structs.py``.
Field names, shapes, dtypes and defaults are the JAX package's, so a state
converts leaf by leaf in either direction (``bridge.py``).  Differences:

* state classes are plain mutable dataclasses whose leaves are tensors on
  one explicit device; the engine updates them in place where that saves
  a copy (JAX's arrays are immutable, so its engine rebuilds the tree);
* the fault, telemetry and signal sub-states belong to later slices of
  the port and are absent;
* PRNG keys are ``int64`` tensors of shape ``[2]`` holding the two 32-bit
  threefry words (see ``ops/prng.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.bandit import BanditState
from ..ops.physics import LatencyCoeffs, PowerCoeffs

ALGO_DEFAULT = "default_policy"
ALGO_CAP_UNIFORM = "cap_uniform"
ALGO_CAP_GREEDY = "cap_greedy"
ALGO_JOINT_NF = "joint_nf"
ALGO_BANDIT = "bandit"
ALGO_CARBON_COST = "carbon_cost"
ALGO_ECO_ROUTE = "eco_route"
ALGO_CHSAC_AF = "chsac_af"
ALGO_DEBUG = "debug"

ALGO_CODES = (
    ALGO_DEFAULT,
    ALGO_CAP_UNIFORM,
    ALGO_CAP_GREEDY,
    ALGO_JOINT_NF,
    ALGO_BANDIT,
    ALGO_CARBON_COST,
    ALGO_ECO_ROUTE,
    ALGO_CHSAC_AF,
    ALGO_DEBUG,
)

#: the algorithms this port runs (every SimParams algorithm)
PORTED_ALGOS = ALGO_CODES

N_JTYPE = 2  # 0 = inference, 1 = training


class JobStatus:
    """Job lifecycle codes stored in JobSlab.status."""

    EMPTY = 0
    XFER = 1
    QUEUED = 2
    RUNNING = 3
    PREEMPTED = 4


@dataclasses.dataclass
class JobSlab:
    """Fixed-capacity struct-of-arrays job table ([J] leading axis)."""

    status: torch.Tensor  # [J] int32
    jtype: torch.Tensor  # [J] int32
    ingress: torch.Tensor  # [J] int32
    dc: torch.Tensor  # [J] int32
    seq: torch.Tensor  # [J] int32
    size: torch.Tensor  # [J] f32
    units_done: torch.Tensor  # [J] f32
    n: torch.Tensor  # [J] int32
    f_idx: torch.Tensor  # [J] int32
    t_ingress: torch.Tensor  # [J] time dtype
    t_avail: torch.Tensor  # [J] time dtype
    t_start: torch.Tensor  # [J] time dtype
    net_lat_s: torch.Tensor  # [J] f32
    preempt_count: torch.Tensor  # [J] int32
    preempt_t: torch.Tensor  # [J] time dtype
    total_preempt_time: torch.Tensor  # [J] f32
    spu: torch.Tensor  # [J] f32 cached seconds-per-unit
    watts: torch.Tensor  # [J] f32 cached task power
    # RL traces (only written under chsac_af)
    rl_obs0: torch.Tensor  # [J, obs_dim] f32 obs at action-selection time
    rl_a_dc: torch.Tensor  # [J] int32
    rl_a_g: torch.Tensor  # [J] int32
    rl_mask_dc0: torch.Tensor  # [J, n_dc] bool: masks in force at s0
    rl_mask_g0: torch.Tensor  # [J, n_g] bool
    rl_valid: torch.Tensor  # [J] bool: the row holds a stored (s0, a) trace


#: the JobSlab fields every algorithm reads and writes (the RL traces,
#: written only under chsac_af, follow them)
CORE_JOB_FIELDS = ("status", "jtype", "ingress", "dc", "seq", "size",
                   "units_done", "n", "f_idx", "t_ingress", "t_avail",
                   "t_start", "net_lat_s", "preempt_count", "preempt_t",
                   "total_preempt_time", "spu", "watts")


class QRec:
    """Field indices of a packed queue-ring record."""

    SIZE = 0
    SEQ = 1
    INGRESS = 2
    T_INGRESS = 3
    T_AVAIL = 4
    NET_LAT_S = 5
    UNITS_DONE = 6
    T_START = 7
    PREEMPT_COUNT = 8
    PREEMPT_T = 9
    TOTAL_PREEMPT_TIME = 10
    N_FIELDS = 11


@dataclasses.dataclass
class QueueRings:
    """Per-(DC, jtype) FIFO rings of jobs waiting for GPUs."""

    recs: torch.Tensor  # [n_dc, 2, Q, QRec.N_FIELDS] time dtype
    head: torch.Tensor  # [n_dc, 2] int32 total pops
    tail: torch.Tensor  # [n_dc, 2] int32 total pushes


@dataclasses.dataclass
class DCArrays:
    """Per-DC dynamic counters ([n_dc] leading axis)."""

    busy: torch.Tensor  # [n_dc] int32
    cur_f_idx: torch.Tensor  # [n_dc] int32
    energy_j: torch.Tensor  # [n_dc] time dtype
    util_gpu_time: torch.Tensor  # [n_dc] time dtype
    acc_job_unit: torch.Tensor  # [n_dc] f32


@dataclasses.dataclass
class LatWindow:
    """Sliding window of the last W sojourn times per job type."""

    buf: torch.Tensor  # [2, W] f32
    count: torch.Tensor  # [2] int32
    ptr: torch.Tensor  # [2] int32


@dataclasses.dataclass
class SignalState:
    """Energy-signal accounting of a run whose workload declares price or
    carbon timelines (``SimState.signals``; None otherwise): accrued over
    the exact inter-event gaps beside the energy integral,
    ``cost_usd += (P dt / 3.6e6) price(t)`` and ``carbon_g += (P dt / 3.6e6)
    ci(dc, t)``, the samples at the interval's start."""

    cost_usd: torch.Tensor  # [n_dc] f32
    carbon_g: torch.Tensor  # [n_dc] f32


@dataclasses.dataclass
class SimState:
    """Everything that changes during a run; every leaf on one device
    (``signals`` is None when the run has no signal timelines)."""

    t: torch.Tensor
    key: torch.Tensor  # [2] int64 threefry words
    jid_counter: torch.Tensor  # int32
    started_accrual: torch.Tensor  # bool
    t_first: torch.Tensor
    dc: DCArrays
    jobs: JobSlab
    next_arrival: torch.Tensor  # [n_ing, 2]
    arr_key: torch.Tensor  # [2] int64 threefry words
    arr_count: torch.Tensor  # [n_ing, 2] int32
    arr_cum: torch.Tensor  # [n_ing, 2]
    arr_epoch: torch.Tensor  # [n_ing, 2]
    next_log_t: torch.Tensor
    lat: LatWindow
    bandit: BanditState  # the UCB1 arms (read and written under bandit only)
    queues: QueueRings
    n_events: torch.Tensor  # int32
    n_finished: torch.Tensor  # [2] int32
    units_finished: torch.Tensor  # [2] f32
    n_dropped: torch.Tensor  # int32
    done: torch.Tensor  # bool
    signals: Optional[SignalState] = None


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Static world shape, held on the host as numpy (JAX package layout).

    The engine uploads what it reads to its device once, at construction."""

    dc_names: Tuple[str, ...]
    ingress_names: Tuple[str, ...]
    gpu_names: Tuple[str, ...]
    total_gpus: np.ndarray  # [n_dc] int32
    p_idle: np.ndarray  # [n_dc] f32
    p_peak: np.ndarray  # [n_dc] f32
    p_sleep: np.ndarray  # [n_dc] f32
    gpu_alpha: np.ndarray  # [n_dc] f32
    power_gating: np.ndarray  # [n_dc] bool
    freq_levels: np.ndarray  # [n_f] f32
    default_f_idx: int
    power: PowerCoeffs  # arrays [n_dc, N_JTYPE]
    latency: LatencyCoeffs  # arrays [n_dc, N_JTYPE]
    carbon: np.ndarray  # [n_dc] f32
    price_hourly: np.ndarray  # [24] f32
    net_lat_s: np.ndarray  # [n_ing, n_dc] f32
    transfer_s: np.ndarray  # [n_ing, n_dc, N_JTYPE] f32
    T_grid: np.ndarray  # [n_dc, N_JTYPE, n_max, n_f] f32
    P_grid: np.ndarray
    E_grid: np.ndarray

    @property
    def n_dc(self) -> int:
        return len(self.dc_names)

    @property
    def n_ing(self) -> int:
        return len(self.ingress_names)

    @property
    def n_f(self) -> int:
        return int(self.freq_levels.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.T_grid.shape[-2])

    def __hash__(self):  # identity hash, as in the JAX package
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static run shape; same fields, defaults and checks as the JAX package.

    Fields of later slices (faults, obs, superstep, slab queues) are kept so configurations carry over unchanged; the engine
    refuses values it does not port yet (`sim.engine.check_ported`)."""

    algo: str = ALGO_DEFAULT
    duration: float = 180.0
    log_interval: float = 5.0
    policy_name: str = "energy_aware"
    max_gpus_per_job: int = 8
    inf_priority: bool = True
    reserve_inf_gpus: int = 0
    dvfs_low: float = 0.6
    dvfs_high: float = 1.0
    train_scale_out_low_freq: bool = True
    inf_mode: str = "sinusoid"
    inf_rate: float = 6.0
    inf_amp: float = 0.6
    inf_period: float = 300.0
    trn_mode: str = "poisson"
    trn_rate: float = 0.3
    workload: Optional[object] = None
    power_cap: float = 0.0
    control_interval: float = 5.0
    cap_margin_w: float = 5.0
    eco_objective: str = "energy"
    router_weights: Optional[Tuple[float, float, float, float, float]] = None
    num_fixed_gpus: int = 1
    fixed_freq: Optional[float] = None
    elastic_scaling: bool = False
    sla_p99_ms: float = 500.0
    energy_budget_j: Optional[float] = None
    power_cap_constraint: Optional[float] = None
    rl_buffer: int = 200_000
    rl_batch: int = 256
    rl_warmup: int = 1_000
    rl_energy_weight: float = 1.0
    critic_arch: str = "onehot"
    job_cap: int = 512
    queue_cap: int = 512
    queue_mode: str = "ring"
    superstep_k: int = 1
    lat_window: int = 2048
    seed: int = 123
    time_dtype: str = "float32"  # or "float64" (SimParams.x64)
    faults: Optional[object] = None
    obs_enabled: bool = False
    obs_ema_alpha: float = 0.05
    obs_qdepth_bins: int = 8

    def __post_init__(self):
        if self.algo not in ALGO_CODES:
            raise ValueError(f"unknown algo {self.algo!r}; choices: {ALGO_CODES}")
        if self.queue_mode not in ("ring", "slab"):
            raise ValueError(f"unknown queue_mode {self.queue_mode!r}")
        if self.policy_name not in ("energy_aware", "perf_first"):
            raise ValueError(f"unknown policy {self.policy_name!r}")
        if self.eco_objective not in ("energy", "carbon", "cost"):
            raise ValueError(f"unknown eco objective {self.eco_objective!r}")
        if not 1 <= self.superstep_k <= 16:
            raise ValueError(
                f"superstep_k={self.superstep_k} out of range [1, 16]: the "
                "fused handler unrolls K sub-steps, so very wide supersteps "
                "only bloat the program (diminishing window hit rate)")
        if not 0.0 < self.obs_ema_alpha <= 1.0:
            raise ValueError(
                f"obs_ema_alpha={self.obs_ema_alpha} outside (0, 1]")
        if self.obs_qdepth_bins < 2:
            raise ValueError(
                f"obs_qdepth_bins={self.obs_qdepth_bins} < 2: the queue "
                "histogram needs at least an empty bin and an overflow bin")
        if self.time_dtype not in ("float32", "float64"):
            raise ValueError(f"unknown time_dtype {self.time_dtype!r}")
        if self.router_weights is not None and len(self.router_weights) != 5:
            raise ValueError(
                "router_weights needs exactly 5 values "
                "(w_latency, w_energy, w_carbon, w_cost, w_queue); got "
                f"{self.router_weights!r}")

    @property
    def x64(self) -> bool:
        """The float64 clock and the reference's x64 numerics that come
        with it (jax under ``jax_enable_x64``: its unpinned draws, the
        replay sample's uniform and optax's bias correction in float64).
        A property of the run, passed to the step, the workload, the
        kernels and the agent; the port keeps no process-wide switch."""
        return self.time_dtype == "float64"

    @property
    def tdtype(self) -> torch.dtype:
        """The clock's dtype: every time-valued leaf (``SimState.t``,
        ``t_first``, ``next_log_t``, the arrival clocks, the slab's four
        time fields, the DCs' energy and GPU-time accumulators and every
        field of a ring record)."""
        return torch.float64 if self.x64 else torch.float32

    @property
    def signals_observed(self) -> bool:
        """True when the workload's price/carbon signals extend the RL
        observation."""
        return (self.workload is not None
                and self.workload.signals is not None
                and self.workload.signals.observe)

    def obs_dim(self, n_dc: int) -> int:
        """RL observation: [now] + per-DC [total, busy, free, cur_f, q_inf,
        q_trn]; workloads with observed signals append [price] + per-DC
        [carbon] (1 + n_dc more)."""
        base = 1 + 6 * n_dc
        if self.signals_observed:
            base += 1 + n_dc
        return base


# ---------------------------------------------------------------------------
# Rollout lanes: R states stacked along a leading axis of every leaf (the
# JAX package's vmap axis).  A single state has no lane axis.
# ---------------------------------------------------------------------------

def _map_tree(fn, *trees):
    """Apply ``fn`` leaf-wise over dataclass trees of tensors (an absent
    sub-state, None, stays None)."""
    first = trees[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return type(first)(**{
            f.name: _map_tree(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    return fn(*trees)


def leaves(tree):
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name))
    else:
        yield tree


def n_lanes(state: SimState) -> Optional[int]:
    """R for a lane-stacked state, None for a single state."""
    return int(state.t.shape[0]) if state.t.dim() == 1 else None


def stack_states(states) -> SimState:
    """R single states -> one state whose leaves are [R, ...] (copies)."""
    return _map_tree(lambda *xs: torch.stack(xs), *states)


def with_lane_axis(state: SimState) -> SimState:
    """A single state as an R=1 lane-stacked state whose leaves are views of
    the original's (writes through them land in ``state``)."""
    return _map_tree(lambda x: x.unsqueeze(0), state)


def clone_state(state: SimState) -> SimState:
    """An independent copy of a state (single or lane-stacked)."""
    return _map_tree(lambda x: x.clone(), state)


def lane_view(state: SimState, r: int) -> SimState:
    """Lane ``r`` of a lane-stacked state; its leaves are views."""
    return _map_tree(lambda x: x[r], state)


def lane_state(state: SimState, r: int) -> SimState:
    """Lane ``r`` of a lane-stacked state as an independent copy."""
    return _map_tree(lambda x: x[r].clone(), state)


def unstack_states(state: SimState):
    """A lane-stacked state -> a list of R independent single states."""
    return [lane_state(state, r) for r in range(n_lanes(state))]


def write_lane(state: SimState, r: int, lane: SimState) -> None:
    """Copy a single state's leaves into lane ``r`` of ``state`` in place."""
    for dst, src in zip(leaves(state), leaves(lane)):
        if dst[r].data_ptr() != src.data_ptr():  # not already a view of it
            dst[r].copy_(src)
