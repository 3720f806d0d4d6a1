"""B1: the event scan — a hand-written CUDA kernel and its plain torch version.

Replaces the XLA-fused scan ``Engine._run_chunk`` -> ``lax.scan(Engine._step)``
(``distributed_cluster_gpus_tpu/sim/engine.py:4581`` and ``:2966``) for the
configurations ``sim.engine.check_ported`` admits: ``n_steps`` events of every
rollout lane in ONE launch, one block of ``THREADS`` per lane (several
warps share the slab passes and the DCs' power trees), the job slab in
shared memory, no host read inside the chunk; in RL mode a cluster of
blocks per lane (:func:`block_plan`), whose blocks hold slices of the
policy's weights in their shared memory and compute their rows of each
layer of the lane's forward.  Under ``chsac_af`` (RL mode)
the same launch runs the policy tail of every event as device functions:
the windowed p99 (B3, ``sim/algos.py:210``) and the observation, masks,
encoder/actor forward and categorical sample (B4, ``sim/engine.py:3454``
``_tail_head`` + ``:3584`` ``_policy_tail_planned`` + ``:1840``
``_commit_tail``).  The heuristic algorithms past default_policy and
joint_nf (carbon_cost, debug, bandit, eco_route, the cap controllers) and
weighted routing run in a second heuristic instance of the kernel
(:func:`ext_plan`; admission sites ``sim/engine.py:772-829`` and
``:1046-1078``, the bandit's ``:1573-1578`` and ``:1651-1656``, routing
``:1732-1753``, the log tick's control ``:1988-2205`` and ``:2776``), so
the first instance compiles to what it ran before.  ``csrc/event_scan.cu``'s
head note gives its design and what bounds it on the card.

:func:`event_scan` is the wrapper ``Engine.run_chunk`` calls.  Its first
argument is a ``sim.step.StepProgram`` (an ``Engine`` is one): the fleet
constants the kernel reads and the plain step loop.  It takes a state
whose leaves carry a leading lane axis ``[R, ...]`` and the chunk's arrival
tables (``sizes``/``tnext`` [R, S, n_tab], ``c0`` [R, S]), advances the state
in place and returns the emissions (``t`` [R, n], ``branch`` [R, n] int32,
``cluster`` [R, n, n_dc, 14], ``job`` [R, n, 15] and, in RL mode, ``rl``:
the per-step transition records, [R, n, ...] each).  A CPU state takes
:func:`event_scan_reference`, the plain step loop lane by lane; a
CUDA state launches the kernel (built on first use) or raises — there is no
fallback, and a configuration the kernel does not cover raises too.  In RL
mode the kernel runs only the port's own policy (``rl.sac.make_policy_apply``)
and reads its bf16 weights (``rl.sac.policy_weights``, built from
``policy_params`` once per chunk) through the pointer table; a CUDA state
without them raises.

:func:`rl_tail_batch` is a thin standalone launch of the RL-mode device
code (B3 over a batch of latency rings, B4 over a batch of observations and
masks) that ``chip_smoke.py`` holds against the plain versions; the main
path never calls it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..models.structs import (ALGO_BANDIT, ALGO_CAP_GREEDY, ALGO_CAP_UNIFORM,
                              ALGO_CARBON_COST, ALGO_CHSAC_AF, ALGO_DEBUG,
                              ALGO_ECO_ROUTE, ALGO_JOINT_NF, CORE_JOB_FIELDS,
                              lane_view, n_lanes, write_lane)
from ..sim import algos

EV_NOOP = 4
CLUSTER_COLS = 14
JOB_COLS = 15
QREC_FIELDS = 11
#: the kernel's compile-time limits (csrc/event_scan.cu kMaxDC/kMaxS/kMaxF)
MAX_DC, MAX_STREAMS, MAX_FREQS = 32, 64, 32
#: the policy's two heads together in RL mode (csrc/event_scan.cu
#: kMaxHeads: n_dc + n_g, as the learning update takes them)
MAX_HEADS = 256
#: dynamic shared memory a block may opt into on Hopper, less a reserve for
#: the kernel's static shared state (the C entry point checks exactly)
SMEM_BUDGET = 232448 - 8192
#: the block widths (threads per lane) the kernel is built for
#: (csrc/event_scan.cu ``kernel_of``): the one both modes launch (the slab
#: passes and the RL step's forward spread over its warps; PERF.md §5) and
#: one warp, for the tests
BLOCK_WIDTHS = (32, 256)
THREADS = 256
#: csrc/event_scan.cu's kRed (block-reduction words), kRegSlots (a DC's
#: power tree in registers up to P = 32 kRegSlots) and kMaxCluster (blocks
#: per lane in RL mode)
RED_WORDS, REG_SLOTS, MAX_CLUSTER = 8 * 8, 16, 8
#: the cluster sizes the wrapper tries in RL mode, smallest first
CLUSTERS = (1, 2, 4, 8)

JOB_FIELDS = CORE_JOB_FIELDS
#: the per-step RL record, in csrc/event_scan.cu's pointer order
RL_EM_FIELDS = ("valid", "s0", "s1", "a_dc", "a_g", "mask_dc0", "mask_g0",
                "r", "costs", "mask_dc", "mask_g")
#: the policy's six Dense layers (encoder 0-2, actor hidden, DC head,
#: GPU-count head): the transposed bf16 kernel [out, in] and the bias of each
N_LAYERS = 6
#: widest layer the kernel takes and its largest observation
MAX_WIDTH, MAX_OBS = 512, 256
#: an activation row of the forward: MAX_WIDTH values, a pad word per 16
ACT_LEN = MAX_WIDTH + MAX_WIDTH // 16

#: the pointer table, in csrc/event_scan.cu's `enum Ptr` order
PTR_NAMES = (
    "t", "key", "jid_counter", "started_accrual", "t_first", "next_log_t",
    "n_events", "n_finished", "units_finished", "n_dropped", "done",
    "dc.busy", "dc.cur_f_idx", "dc.energy_j", "dc.util_gpu_time",
    "dc.acc_job_unit", "next_arrival", "arr_count",
    "lat.buf", "lat.count", "lat.ptr",
    "queues.recs", "queues.head", "queues.tail",
    *("jobs." + f for f in JOB_FIELDS),
    "pre.sizes", "pre.tnext", "pre.c0",
    "em.t", "em.branch", "em.cluster", "em.job",
    "freq_levels", "total_gpus", "E_grid_cap", "transfer_s", "net_lat_s",
    "power.alpha_p", "power.beta_p", "power.gamma_p",
    "latency.alpha_t", "latency.beta_t", "latency.gamma_t", "idle_w",
    # RL mode only (0 otherwise): the slab's RL traces, the RL records and
    # the policy weights
    "jobs.rl_obs0", "jobs.rl_a_dc", "jobs.rl_a_g", "jobs.rl_mask_dc0",
    "jobs.rl_mask_g0", "jobs.rl_valid",
    *("em.rl." + f for f in RL_EM_FIELDS),
    *(f"w.{k}" for k in range(2 * N_LAYERS)),
    # the extended heuristic instance only (0 otherwise): the uncapped E
    # grid, the hourly price, the per-DC carbon, the bandit's arms and its
    # select count, and the controller's counters (an output)
    "E_grid", "price_hourly", "carbon", "bandit.N", "bandit.S", "bandit.t",
    "out.ctl",
)
#: the integer parameters, in csrc/event_scan.cu's `enum Int` order
INT_NAMES = (
    "R", "n_steps", "n_dc", "n_ing", "n_f", "n_cap", "J", "P", "Q", "W",
    "n_tab", "k_drain", "default_f_idx", "algo_joint_nf", "perf_first",
    "inf_priority", "reserve_inf_gpus", "max_gpus_per_job", "f_hi", "f_lo",
    "train_scale_out_low_freq",
    # RL mode: on/off, greedy actions, obs width, percentile K, layer widths
    "rl", "greedy", "obs_dim", "perc_k", "w_h0", "w_h1", "w_lat", "w_ah",
    # the block: threads per lane, warps that sum the DCs' power trees, and
    # in RL mode the blocks of the lane's cluster and whether block 0 holds
    # a slice of the weights
    "threads", "sum_warps", "cluster", "lead",
    # the extended instance (:func:`ext_plan`): on/off, admission, routing,
    # eco objective, the log tick's control; debug's GPU count, fixed ladder
    # index (-1: the energy argmin) and E-grid row; the uncapped grid's rows
    "ext", "adm", "route", "eco_obj", "cap", "num_fixed", "fixed_f",
    "debug_row", "n_max",
)
#: the float parameters, in csrc/event_scan.cu's `enum Flt` order
FLT_NAMES = ("end", "log_interval", "sla_thr", "neg_w", "sla_ms",
             "power_cap", "cap_thr", "w_lat", "w_e", "w_c", "w_cost", "w_q")
#: the double clock's parameters (csrc/event_scan.cu `enum Dbl`), which its
#: build (csrc/event_scan64.cu) reads in place of the first two floats
DBL_NAMES = ("end", "log_interval")
#: what the double clock's slab adds to a lane's (csrc/event_scan.cu
#: ``event_scan_smem_bytes``): an 8-byte alignment pad, the [4, J] double
#: time columns and the warps' argmins (kWarpMinBytes)
X64_PAD, X64_WARP_MIN = 8, 3 * 8 * (8 + 8 + 4)

#: csrc/event_scan.cu's codes for the extended instance's choices
ADM_HEUR, ADM_TABLE, ADM_CC, ADM_BANDIT = 0, 1, 2, 3
ROUTE_RANDOM, ROUTE_ECO, ROUTE_WEIGHTED = 0, 1, 2
ECO_CODES = {"energy": 0, "carbon": 1, "cost": 2}
CAP_NONE, CAP_IDLE, CAP_UNIFORM, CAP_GREEDY = 0, 1, 2, 3
#: the counters the extended instance writes per lane (``stats["ctl"]``):
#: log ticks the cap controller ran in, its iterations, its clock cycles and
#: the lane's cycles over the whole launch
CTL_FIELDS = ("ticks", "iters", "cycles", "launch_cycles")


def ext_plan(params):
    """{adm, route, eco_obj, cap} of a configuration, and whether it takes
    the extended instance (any choice off the default_policy / joint_nf
    program: carbon_cost, debug or bandit admission, eco or weighted
    routing, a log tick that controls)."""
    algo = params.algo
    adm = {ALGO_JOINT_NF: ADM_TABLE, ALGO_DEBUG: ADM_TABLE,
           ALGO_CARBON_COST: ADM_CC, ALGO_BANDIT: ADM_BANDIT}.get(algo, ADM_HEUR)
    route = (ROUTE_ECO if algo == ALGO_ECO_ROUTE
             else ROUTE_WEIGHTED if params.router_weights is not None
             else ROUTE_RANDOM)
    cap = CAP_NONE
    if params.power_cap > 0:
        cap = {ALGO_ECO_ROUTE: CAP_IDLE, ALGO_CARBON_COST: CAP_IDLE,
               ALGO_CAP_UNIFORM: CAP_UNIFORM,
               ALGO_CAP_GREEDY: CAP_GREEDY}.get(algo, CAP_NONE)
    plan = {"adm": adm, "route": route,
            "eco_obj": ECO_CODES[params.eco_objective], "cap": cap}
    ext = algo != ALGO_CHSAC_AF and (
        algo in (ALGO_CARBON_COST, ALGO_DEBUG, ALGO_BANDIT)
        or route != ROUTE_RANDOM or cap != CAP_NONE)
    return ext, plan

_I32, _F32, _I64, _BOOL = torch.int32, torch.float32, torch.int64, torch.bool
#: the pointers only the extended instance reads (0 for the others)
EXT_PTRS = ("E_grid", "price_hourly", "carbon", "bandit.N", "bandit.S",
            "bandit.t", "out.ctl")
_JOB_DTYPES = {
    "status": _I32, "jtype": _I32, "ingress": _I32, "dc": _I32, "seq": _I32,
    "size": _F32, "units_done": _F32, "n": _I32, "f_idx": _I32,
    "t_ingress": _F32, "t_avail": _F32, "t_start": _F32, "net_lat_s": _F32,
    "preempt_count": _I32, "preempt_t": _F32, "total_preempt_time": _F32,
    "spu": _F32, "watts": _F32,
    "rl_a_dc": _I32, "rl_a_g": _I32, "rl_valid": _BOOL,
}

#: the slab's fields in the clock's dtype (float32 above is the float32
#: clock's; under the float64 clock these four are float64)
TIME_JOB_FIELDS = ("t_ingress", "t_avail", "t_start", "preempt_t")

_argtypes = set()


def _get(obj, dotted: str):
    for part in dotted.split("."):
        obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
    return obj


def pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def slice_bytes(widths, nb: int) -> int:
    """The longest slice of the policy when ``nb`` blocks split every
    layer's rows, ceil(out / nb) each (csrc/event_scan.cu ``slice_bytes``):
    the bf16 weights, rows padded to a power of two, then the biases as
    float32.  ``widths``: obs_dim, h0, h1, latent, actor hidden, n_dc, n_g."""
    ins = [widths[0], widths[1], widths[2], widths[3], widths[4], widths[4]]
    rows = [-(-widths[k + 1] // nb) for k in range(N_LAYERS)]
    elems = sum(rows[k] * pow2_at_least(ins[k]) for k in range(N_LAYERS))
    return -(-2 * elems // 16) * 16 + -(-sum(rows) // 4) * 16


def logit_len(n_g: int) -> int:
    """A cluster's logit row (csrc/event_scan.cu ``logit_len``): the DC
    head at 0, the ``n_g`` GPU-count actions at 32, padded to 4 floats."""
    return 32 + -(-n_g // 4) * 4


def act_bytes(n_g: int) -> int:
    """What every block of an RL cluster holds at one offset: two
    activation rows, the logits and the command word."""
    return 4 * (2 * ACT_LEN + logit_len(n_g) + 4)


def slab_bytes(J: int, W: int = 0, rl: bool = False, sum_warps: int = 1,
               x64: bool = False) -> int:
    """A lane's slab in shared memory: the job fields, the [P] row of the
    slots' values, a [P] row per DC-summing warp when P exceeds the trees
    kept in registers, the block-reduction words, and in RL mode the two
    latency windows and the observation (B3's scratch shares the cluster's
    activation rows, :func:`act_bytes`); under the float64 clock (``x64``)
    the four double time columns (32 bytes a slot) and the warps' argmins."""
    P = pow2_at_least(J)
    rows = sum_warps * P if P > 32 * REG_SLOTS else 0
    rl_part = (2 * W + MAX_OBS) if rl else 0
    extra = X64_PAD + 32 * J + X64_WARP_MIN if x64 else 0
    return 4 * (18 * J + P + rows + RED_WORDS + rl_part) + extra


def smem_bytes(J: int, W: int = 0, rl: bool = False, sum_warps: int = 1,
               widths=None, cs: int = 1, lead: bool = True,
               x64: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/event_scan.cu
    ``event_scan_smem_bytes``): the lane's slab (:func:`slab_bytes`); in RL
    mode the blocks of a cluster of ``cs`` hold :func:`act_bytes`, then
    their weight slices (:func:`slice_bytes` of ``widths``), and block 0
    holds the slab after its own slice, or (``lead`` false) in place of
    one."""
    slab = slab_bytes(J, W, rl, sum_warps, x64)
    if not rl:
        return slab
    act = act_bytes(widths[-1])
    if lead:
        return act + slice_bytes(widths, cs) + slab
    return act + max(slice_bytes(widths, cs - 1), slab)


def block_plan(prog, threads: int, widths=None):
    """(sum_warps, cluster, lead) of a launch: the warps that sum the DCs'
    power trees, a DC each at a time, one per DC up to the block's warps;
    in RL mode the blocks of a lane's cluster and whether block 0 holds a
    slice of the weights beside its slab.  Takes the fewest blocks that fit
    in shared memory, block 0 holding a slice where it can, then as many
    summing warps as fit (their scratch rows take room past 512 slots);
    raises when nothing fits.  ``widths``: the policy's hidden widths (h0,
    h1, latent, actor hidden)."""
    p = prog.params
    J, W, n_dc = p.job_cap, p.lat_window, prog.fleet.n_dc
    n_max = max(1, min(threads // 32, n_dc))
    if p.algo != ALGO_CHSAC_AF:
        n = n_max
        while n > 1 and slab_bytes(J, W, False, n, p.x64) > SMEM_BUDGET:
            n -= 1
        return n, 1, True
    w = (p.obs_dim(n_dc), *widths, n_dc, p.max_gpus_per_job)
    for cs in CLUSTERS:
        for lead in (True, False) if cs > 1 else (True,):
            for n in range(n_max, 0, -1):
                if smem_bytes(J, W, True, n, w, cs, lead, p.x64) <= SMEM_BUDGET:
                    return n, cs, lead
    raise ValueError(
        f"event_scan: the policy's weights (widths {w}) do not fit in "
        f"{CLUSTERS[-1]} blocks' shared memory beside job_cap {J}")


_bitrev_cache = {}


def bitrev_perm(kp: int, device="cpu") -> torch.Tensor:
    """[kp] int64 on ``device``: position n of a power-of-two row holds
    element rev(n) (the kernel's order for the halving-tree sums).  Built
    with integer ops on the device once per (kp, device), so a chunk's
    operands need no host-to-device copy."""
    key = (kp, str(device))
    if key not in _bitrev_cache:
        bits = kp.bit_length() - 1
        n = torch.arange(kp, dtype=torch.int64, device=device)
        r = torch.zeros_like(n)
        for b in range(bits):
            r = r | (((n >> b) & 1) << (bits - 1 - b))
        _bitrev_cache[key] = r
    return _bitrev_cache[key]


def _lane_specs(prog, R: int, n_tab: int):
    """{name: (dtype, shape)} of every per-lane leaf the kernel reads."""
    fleet, p = prog.fleet, prog.params
    n_dc, n_ing, J = fleet.n_dc, fleet.n_ing, p.job_cap
    S = 2 * n_ing
    lane = lambda *s: (R,) + s  # noqa: E731
    T = prog.td  # the clock's dtype (SimParams.time_dtype)
    specs = {
        "t": (T, lane()), "key": (_I64, lane(2)), "jid_counter": (_I32, lane()),
        "started_accrual": (_BOOL, lane()), "t_first": (T, lane()),
        "next_log_t": (T, lane()), "n_events": (_I32, lane()),
        "n_finished": (_I32, lane(2)), "units_finished": (_F32, lane(2)),
        "n_dropped": (_I32, lane()), "done": (_BOOL, lane()),
        "dc.busy": (_I32, lane(n_dc)), "dc.cur_f_idx": (_I32, lane(n_dc)),
        "dc.energy_j": (T, lane(n_dc)), "dc.util_gpu_time": (T, lane(n_dc)),
        "dc.acc_job_unit": (_F32, lane(n_dc)),
        "next_arrival": (T, lane(n_ing, 2)), "arr_count": (_I32, lane(n_ing, 2)),
        "lat.buf": (_F32, lane(2, p.lat_window)), "lat.count": (_I32, lane(2)),
        "lat.ptr": (_I32, lane(2)),
        "queues.recs": (T, lane(n_dc, 2, p.queue_cap, QREC_FIELDS)),
        "queues.head": (_I32, lane(n_dc, 2)), "queues.tail": (_I32, lane(n_dc, 2)),
        "pre.sizes": (_F32, lane(S, n_tab)), "pre.tnext": (T, lane(S, n_tab)),
        "pre.c0": (_I32, lane(S)),
    }
    for f, dt in _JOB_DTYPES.items():
        specs["jobs." + f] = (T if f in TIME_JOB_FIELDS else dt, lane(J))
    specs["bandit.N"] = (_I32, lane(n_dc, 2, fleet.n_f))
    specs["bandit.S"] = (_F32, lane(n_dc, 2, fleet.n_f))
    specs["bandit.t"] = (_I32, lane())
    specs["jobs.rl_obs0"] = (_F32, lane(J, p.obs_dim(n_dc)))
    specs["jobs.rl_mask_dc0"] = (_BOOL, lane(J, n_dc))
    specs["jobs.rl_mask_g0"] = (_BOOL, lane(J, p.max_gpus_per_job))
    return specs


def _check(name, t, dtype, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"event_scan: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"event_scan: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"event_scan: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"event_scan: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"event_scan: {name} must be contiguous")


def _validate(prog, state, pre, n_steps: int):
    """(R, n_tab): every leaf's dtype, [R, ...] shape, device, contiguity."""
    if n_steps <= 0:
        raise ValueError("event_scan: n_steps must be positive")
    R = n_lanes(state)
    if R is None:
        raise ValueError("event_scan: the state needs a leading lane axis [R, ...]")
    n_tab = int(pre["sizes"].shape[-1])
    if n_tab < 1:
        raise ValueError("event_scan: the arrival tables are empty")
    src = {"pre": pre}
    for name, (dtype, shape) in _lane_specs(prog, R, n_tab).items():
        obj = src if name.startswith("pre.") else state
        _check(name, _get(obj, name), dtype, shape, prog.device)
    return R, n_tab


def _stack(ems):
    return {k: (_stack([e[k] for e in ems]) if isinstance(ems[0][k], dict)
                else torch.stack([e[k] for e in ems])) for k in ems[0]}


def event_scan_reference(prog, state, pre, n_steps: int, policy_params=None):
    """Plain version: the plain step loop (``sim.step.StepProgram.scan_plain``),
    lane by lane, each lane advanced in place.  Returns (emissions, stats)."""
    R, _ = _validate(prog, state, pre, n_steps)
    ems = []
    stats = {"events": 0, "host_reads": 0}
    ctl = torch.zeros((R, len(CTL_FIELDS)), dtype=_I64)
    for r in range(R):
        st = lane_view(state, r)
        before = (prog.ctl_ticks, prog.ctl_iters)
        em, s = prog.scan_plain(st, {k: v[r] for k, v in pre.items()}, n_steps,
                                policy_params)
        write_lane(state, r, st)
        ems.append(em)
        for k in stats:
            stats[k] += s[k]
        ctl[r, 0] = prog.ctl_ticks - before[0]
        ctl[r, 1] = prog.ctl_iters - before[1]
    stats["ctl"] = ctl
    return _stack(ems), stats


def _lib(x64: bool = False):
    """The float clock's build (csrc/event_scan.cu), or with ``x64`` the
    double clock's (csrc/event_scan64.cu)."""
    from . import build

    if x64:
        lib = build.load("event_scan64")
        if "event_scan64" not in _argtypes:
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.event_scan64_launch.argtypes = [P, I, P, I, P, I, P, I, P]
            lib.event_scan64_launch.restype = ctypes.c_int
            _argtypes.add("event_scan64")
        return lib
    lib = build.load("event_scan")
    if "event_scan" not in _argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.event_scan_launch, lib.rl_tail_batch_launch):
            fn.argtypes = [P, I, P, I, P, I, P]
            fn.restype = ctypes.c_int
        _argtypes.add("event_scan")
    return lib


def kernel_ints(prog, R: int, n_steps: int, n_tab: int, greedy: bool = False,
                widths=(0, 0, 0, 0), threads: int = 32):
    """The kernel's integer parameters for this engine, in INT_NAMES order
    (``widths``: the policy's hidden widths h0, h1, latent and actor
    hidden, from :func:`policy_operands`; ``threads``: the block's)."""
    fleet, p = prog.fleet, prog.params
    J = p.job_cap
    rl = p.algo == ALGO_CHSAC_AF
    n_sum, cs, lead = block_plan(prog, threads, widths)
    vals = {
        "R": R, "n_steps": n_steps, "n_dc": fleet.n_dc, "n_ing": fleet.n_ing,
        "n_f": fleet.n_f, "n_cap": int(prog.E_grid_cap.shape[2]), "J": J,
        "P": pow2_at_least(J), "Q": p.queue_cap, "W": p.lat_window,
        "n_tab": n_tab, "k_drain": prog.k_drain,
        "default_f_idx": fleet.default_f_idx,
        "algo_joint_nf": int(p.algo == ALGO_JOINT_NF),
        "perf_first": int(p.policy_name == "perf_first"),
        "inf_priority": int(bool(p.inf_priority)),
        "reserve_inf_gpus": p.reserve_inf_gpus,
        "max_gpus_per_job": p.max_gpus_per_job,
        "f_hi": algos.f_idx_of(fleet, p.dvfs_high),
        "f_lo": algos.f_idx_of(fleet, p.dvfs_low),
        "train_scale_out_low_freq": int(bool(p.train_scale_out_low_freq)),
        "rl": int(rl), "greedy": int(bool(greedy)),
        "obs_dim": p.obs_dim(fleet.n_dc),
        "perc_k": algos.percentile_k(p.lat_window, 99.0),
        "w_h0": widths[0], "w_h1": widths[1], "w_lat": widths[2],
        "w_ah": widths[3],
        "threads": threads, "sum_warps": n_sum, "cluster": cs, "lead": lead,
    }
    ext, plan = ext_plan(p)
    vals.update(plan, ext=int(ext), num_fixed=p.num_fixed_gpus,
                fixed_f=(algos.f_idx_of(fleet, p.fixed_freq)
                         if p.fixed_freq is not None else -1),
                debug_row=prog.debug_row, n_max=fleet.n_max)
    return [int(vals[k]) for k in INT_NAMES]


def kernel_floats(prog):
    """The kernel's float parameters, in FLT_NAMES order (float32)."""
    p = prog.params
    w = p.router_weights if p.router_weights is not None else (0.0,) * 5
    return [float(p.duration), float(p.log_interval), 0.9 * p.sla_p99_ms,
            -float(p.rl_energy_weight), float(p.sla_p99_ms),
            float(p.power_cap), float(p.power_cap - p.cap_margin_w),
            *(float(x) for x in w)]


#: what B1's RL mode takes: the policy's observations and heads
RL_ENVELOPE = (f"B1 (the event scan) acts in RL mode with 5 to {MAX_OBS} "
               f"observations, at most {MAX_DC} DCs and heads of up to "
               f"{MAX_HEADS} actions together: n_dc + n_g <= {MAX_HEADS} "
               "(n_g: --max-gpus-per-job)")


def rl_covers(obs_dim: int, n_dc: int, n_g: int) -> bool:
    """Whether B1's RL mode takes a policy of ``obs_dim`` observations, an
    ``n_dc``-way DC head and ``n_g`` GPU-count actions (``RL_ENVELOPE``)."""
    return (5 <= obs_dim <= MAX_OBS and 1 <= n_dc <= MAX_DC and n_g >= 1
            and n_dc + n_g <= MAX_HEADS)


def check_kernel_covers(prog) -> None:
    """Raise for a configuration beyond the kernel's limits (the port never
    falls back to the plain step on the card)."""
    fleet, p = prog.fleet, prog.params
    J = p.job_cap
    if fleet.n_dc > MAX_DC or 2 * fleet.n_ing > MAX_STREAMS or fleet.n_f > MAX_FREQS:
        raise ValueError(
            f"event_scan: at most {MAX_DC} DCs, {MAX_STREAMS // 2} ingresses and "
            f"{MAX_FREQS} frequency levels (got {fleet.n_dc}, {fleet.n_ing}, "
            f"{fleet.n_f})")
    rl = p.algo == ALGO_CHSAC_AF
    if not slab_fits(J, p.lat_window, rl, p.max_gpus_per_job, p.x64):
        need = lane_bytes(J, p.lat_window, rl, p.max_gpus_per_job, p.x64)
        raise ValueError(
            f"event_scan: job_cap {J} (lat_window {p.lat_window}) needs {need} B "
            f"of shared memory per lane; the card offers {SMEM_BUDGET} B "
            f"({slab_limit_text(p.lat_window, rl, p.max_gpus_per_job, p.x64)})")
    if rl:
        if getattr(prog.policy_apply, "kernel_mode", None) is None:
            raise ValueError(
                "event_scan: the B1 kernel runs only the port's own policy "
                "(rl.sac.make_policy_apply); other policy_apply callables run "
                "on the CPU")
        if not rl_covers(p.obs_dim(fleet.n_dc), fleet.n_dc, p.max_gpus_per_job):
            raise ValueError(f"event_scan: {RL_ENVELOPE}")


def lane_bytes(J: int, W: int, rl: bool, n_g: int, x64: bool) -> int:
    """The least shared memory a lane's block needs: its slab with one
    DC-summing warp and, in RL mode, the cluster's activation rows."""
    return slab_bytes(J, W, rl, 1, x64) + (act_bytes(n_g) if rl else 0)


def slab_fits(J: int, W: int, rl: bool, n_g: int, x64: bool) -> bool:
    return lane_bytes(J, W, rl, n_g, x64) <= SMEM_BUDGET


def max_job_cap(W: int, rl: bool, n_g: int, x64: bool) -> int:
    """The largest job_cap whose lane fits in a block's shared memory."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if slab_fits(mid, W, rl, n_g, x64) else (lo, mid - 1)
    return lo


def slab_limit_text(W: int, rl: bool, n_g: int, x64: bool) -> str:
    """The job_cap limit of this clock and mode, for a refusal's message."""
    mode = f"RL mode at lat_window {W}" if rl else "the heuristic instances"
    clock = "float64" if x64 else "float32"
    return (f"the {clock} clock's limit in {mode}: job_cap <= "
            f"{max_job_cap(W, rl, n_g, x64)}")


def policy_operands(prog, policy_params, device):
    """The policy's operands for the kernel: per layer (encoder 0-2, actor
    hidden, DC head, GPU-count head) the bf16 weight [out, pow2(in)] with
    each row in bit-reversed order and zero-padded, then the bf16 bias;
    and the hidden widths (h0, h1, latent, actor hidden).  Built once per
    chunk; raises unless ``policy_params`` is an ``rl.sac.SACState`` whose
    layers chain from the observation to the two heads."""
    from ..rl.sac import policy_weights

    if policy_params is None or not hasattr(policy_params, "layers"):
        raise ValueError(
            "event_scan: a chsac_af state on the card needs the policy's "
            "weights (policy_params: an rl.sac.SACState)")
    p, n_dc = prog.params, prog.fleet.n_dc
    ws = policy_weights(policy_params, device)
    outs = [int(ws[2 * k].shape[0]) for k in range(N_LAYERS)]
    ins = [p.obs_dim(n_dc), outs[0], outs[1], outs[2], outs[3], outs[3]]
    if outs[4] != n_dc or outs[5] != p.max_gpus_per_job:
        raise ValueError(f"event_scan: policy heads {outs[4:]} do not match "
                         f"(n_dc, max_gpus_per_job) = ({n_dc}, "
                         f"{p.max_gpus_per_job})")
    ops = []
    for k in range(N_LAYERS):
        w, b = ws[2 * k], ws[2 * k + 1]
        if tuple(w.shape) != (outs[k], ins[k]) or tuple(b.shape) != (outs[k],):
            raise ValueError(f"event_scan: policy layer {k} is {tuple(w.shape)}, "
                             f"the kernel expects ({outs[k]}, {ins[k]})")
        if not 5 <= ins[k] <= MAX_WIDTH or outs[k] > MAX_WIDTH:
            raise ValueError(f"event_scan: layer widths 5..{MAX_WIDTH}")
        kp = pow2_at_least(ins[k])
        # zero columns past `in`, then the bit-reversed gather (positions
        # whose element lies in the padding read a zero)
        padded = torch.cat([w, torch.zeros((outs[k], kp - ins[k]), dtype=w.dtype,
                                           device=device)], dim=1)
        wp = padded.index_select(1, bitrev_perm(kp, device))
        ops += [wp.contiguous(), b.contiguous()]
    return ops, tuple(outs[:4])


def _launch_error(rc):
    return {-1: "pointer/parameter tables do not match the build",
            -2: "a shape beyond the kernel's limits",
            -3: "the slab does not fit in shared memory"}.get(
                rc, f"cudaError {rc}")


def _width(threads):
    threads = THREADS if threads is None else int(threads)
    if threads not in BLOCK_WIDTHS:
        raise ValueError(f"event_scan: {threads} threads per lane; the kernel "
                         f"is built for {BLOCK_WIDTHS}")
    return threads


def event_scan(prog, state, pre, n_steps: int, policy_params=None,
               threads=None):
    """The B1 wrapper: kernel on a CUDA state, plain version on a CPU one.

    Advances ``state`` (leaves [R, ...]) by ``n_steps`` events in place;
    returns (emissions, stats).  ``policy_params``: the chsac_af policy's
    (an ``rl.sac.SACState``).  ``threads`` overrides the block width
    (``THREADS``; one of ``BLOCK_WIDTHS``), for tests and studies.  Counts each kernel launch in ``event_scan.launches``."""
    R, n_tab = _validate(prog, state, pre, n_steps)
    dev = prog.device
    if dev.type == "cpu":
        return event_scan_reference(prog, state, pre, n_steps, policy_params)
    if dev.type != "cuda":
        raise ValueError(f"event_scan: unsupported device {dev}")
    check_kernel_covers(prog)
    threads = _width(threads)
    fleet = prog.fleet
    rl = prog.params.algo == ALGO_CHSAC_AF
    em = {
        "t": torch.empty((R, n_steps), dtype=_F32, device=dev),
        "branch": torch.full((R, n_steps), EV_NOOP, dtype=_I32, device=dev),
        "cluster": torch.zeros((R, n_steps, fleet.n_dc, CLUSTER_COLS),
                               dtype=_F32, device=dev),
        "job": torch.zeros((R, n_steps, JOB_COLS), dtype=_F32, device=dev),
    }
    weights, widths = [], (0, 0, 0, 0)
    if rl:
        weights, widths = policy_operands(prog, policy_params, dev)
        em["rl"] = {k: v.unsqueeze(0).expand((R,) + tuple(v.shape)).contiguous()
                    for k, v in prog.rl_emissions(n_steps).items()}
    consts = prog.kernel_consts()
    ext, _ = ext_plan(prog.params)
    ctl = (torch.zeros((R, len(CTL_FIELDS)), dtype=_I64, device=dev)
           if ext else None)
    src = {"pre": pre, "em": em, "out": {"ctl": ctl}}
    ptrs = []
    for name in PTR_NAMES:
        head = name.split(".")[0]
        if head == "w":
            k = int(name.split(".")[1])
            ptrs.append(weights[k].data_ptr() if rl else 0)
            continue
        if (name.startswith("em.rl.") or name.startswith("jobs.rl_")) and not rl:
            ptrs.append(0)
            continue
        if name in EXT_PTRS and not ext:
            ptrs.append(0)
            continue
        if head in ("pre", "em", "out"):
            t = _get(src, name)
        elif name in consts:
            t = consts[name]
        else:
            t = _get(state, name)
        ptrs.append(t.data_ptr())
    greedy = rl and prog.policy_apply.kernel_mode == "greedy"
    ints = kernel_ints(prog, R, n_steps, n_tab, greedy, widths, threads)
    floats = kernel_floats(prog)
    x64 = prog.params.x64
    lib = _lib(x64)
    c_ptrs = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if x64:
            dbls = [float(prog.params.duration), float(prog.params.log_interval)]
            c_dbls = (ctypes.c_double * len(dbls))(*dbls)
            rc = lib.event_scan64_launch(c_ptrs, len(ptrs), c_ints, len(ints),
                                         c_floats, len(floats), c_dbls,
                                         len(dbls), stream)
        else:
            rc = lib.event_scan_launch(c_ptrs, len(ptrs), c_ints, len(ints),
                                       c_floats, len(floats), stream)
    if rc != 0:
        raise RuntimeError(f"event_scan kernel launch failed: {_launch_error(rc)}")
    event_scan.launches += 1
    event_scan.rl_launches += rl
    event_scan.ext_launches += ext
    event_scan.x64_launches += x64
    return em, {"events": None, "host_reads": None, "ctl": ctl}


#: kernel launches; ``rl_launches`` counts those in RL mode, which run the
#: B3 and B4 device code inside the event loop
event_scan.launches = 0
event_scan.rl_launches = 0
#: launches of the extended heuristic instance (carbon_cost, debug, bandit,
#: eco / weighted routing, the cap controllers)
event_scan.ext_launches = 0
#: launches of the double clock's instances (csrc/event_scan64.cu)
event_scan.x64_launches = 0


# ---------------------------------------------------------------------------
# The RL-mode device code, launched standalone over a batch (chip_smoke.py)
# ---------------------------------------------------------------------------

def rl_tail_batch(prog, policy_params, lat_buf, lat_count, obs, mask_dc,
                  mask_g, keys, operands=None, threads=None):
    """B3 and B4 of the RL mode on a batch, through the kernel's own device
    functions: ``lat_buf`` [B, W] f32 and ``lat_count`` [B] i32 give the
    p99 of each ring ([B] f32); ``obs`` [M, obs_dim] f32 with ``mask_dc``
    [M, n_dc] and ``mask_g`` [M, n_g] bool and ``keys`` [M, 2] int64 give
    each row's log-probabilities ([M, n_dc], [M, n_g] f32) and sampled
    actions ([M] int32 each, ``split(key)[0]`` for the DC head and
    ``split(key)[1]`` for the GPU count).  One launch, one cluster per row
    (the RL mode's: its block width unless ``threads`` says otherwise).  ``operands``
    (from :func:`policy_operands`) skips rebuilding the weights.  Not on the
    main path and not counted in ``event_scan.launches``."""
    dev = prog.device
    if dev.type != "cuda":
        raise ValueError("rl_tail_batch: the standalone launch runs on the card")
    p, fleet = prog.params, prog.fleet
    B, W = lat_buf.shape
    M = obs.shape[0]
    n_dc, n_g = fleet.n_dc, p.max_gpus_per_job
    weights, widths = (operands if operands is not None else
                       policy_operands(prog, policy_params, dev))
    out = {"p99": torch.empty((B,), dtype=_F32, device=dev),
           "logp_dc": torch.empty((M, n_dc), dtype=_F32, device=dev),
           "logp_g": torch.empty((M, n_g), dtype=_F32, device=dev),
           "a_dc": torch.empty((M,), dtype=_I32, device=dev),
           "a_g": torch.empty((M,), dtype=_I32, device=dev)}
    args = [lat_buf, lat_count, obs, mask_dc, mask_g, keys]
    for t in args:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("rl_tail_batch: inputs must be contiguous on the card")
    ptrs = [t.data_ptr() for t in args + [out["p99"], out["logp_dc"],
                                          out["logp_g"], out["a_dc"],
                                          out["a_g"]]]
    ptrs += [w.data_ptr() for w in weights]
    ints = kernel_ints(prog, 1, 1, 1,
                       prog.policy_apply.kernel_mode == "greedy", widths,
                       _width(threads))
    ints += [B, W, M]
    lib = _lib()
    floats = kernel_floats(prog)
    c_ptrs = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rl_tail_batch_launch(c_ptrs, len(ptrs), c_ints, len(ints),
                                      c_floats, len(floats), stream)
    if rc != 0:
        raise RuntimeError(f"rl_tail_batch launch failed: {_launch_error(rc)}")
    return out
