"""Core state (dataclasses of tensors) and static world/run configuration.

PyTorch counterpart of ``distributed_cluster_gpus_tpu/models/structs.py``.
Field names, shapes, dtypes and defaults are the JAX package's, so a state
converts leaf by leaf in either direction (``bridge.py``).  Differences:

* state classes are plain mutable dataclasses whose leaves are tensors on
  one explicit device; the engine updates them in place where that saves
  a copy (JAX's arrays are immutable, so its engine rebuilds the tree);
* the RL trace fields of :class:`JobSlab`, the bandit, fault, telemetry and
  signal sub-states belong to later slices of the port and are absent;
* PRNG keys are ``int64`` tensors of shape ``[2]`` holding the two 32-bit
  threefry words (see ``ops/prng.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

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

#: the algorithms this port runs; the rest raise with their ROADMAP item
PORTED_ALGOS = (ALGO_DEFAULT, ALGO_JOINT_NF)

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
class SimState:
    """Everything that changes during a run; every leaf on one device."""

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
    queues: QueueRings
    n_events: torch.Tensor  # int32
    n_finished: torch.Tensor  # [2] int32
    units_finished: torch.Tensor  # [2] f32
    n_dropped: torch.Tensor  # int32
    done: torch.Tensor  # bool


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

    Fields of later slices (faults, obs, bandit, RL, superstep, weighted
    routing) are kept so configurations carry over unchanged; the engine
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
    time_dtype: str = "float32"
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
        if self.router_weights is not None and len(self.router_weights) != 5:
            raise ValueError(
                "router_weights needs exactly 5 values "
                "(w_latency, w_energy, w_carbon, w_cost, w_queue); got "
                f"{self.router_weights!r}")

    @property
    def tdtype(self) -> torch.dtype:
        return torch.float64 if self.time_dtype == "float64" else torch.float32
