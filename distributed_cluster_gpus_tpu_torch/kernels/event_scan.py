"""B1: the event scan — a hand-written CUDA kernel and its plain torch version.

Replaces the XLA-fused scan ``Engine._run_chunk`` -> ``lax.scan(Engine._step)``
(``distributed_cluster_gpus_tpu/sim/engine.py:4581`` and ``:2966``) for the
configurations ``sim.engine.check_ported`` admits: ``n_steps`` events of every
rollout lane in ONE launch, one block (one warp) per lane, the job slab in
shared memory, no host read inside the chunk.  ``csrc/event_scan.cu``'s head
note gives its design and what bounds it on the card.

:func:`event_scan` is the wrapper ``Engine.run_chunk`` calls.  Its first
argument is a ``sim.step.StepProgram`` (an ``Engine`` is one): the fleet
constants the kernel reads and the plain step loop.  It takes a state
whose leaves carry a leading lane axis ``[R, ...]`` and the chunk's arrival
tables (``sizes``/``tnext`` [R, S, n_tab], ``c0`` [R, S]), advances the state
in place and returns the emissions (``t`` [R, n], ``branch`` [R, n] int32,
``cluster`` [R, n, n_dc, 14], ``job`` [R, n, 15]).  A CPU state takes
:func:`event_scan_reference`, the plain step loop lane by lane; a
CUDA state launches the kernel (built on first use) or raises — there is no
fallback, and a configuration the kernel does not cover raises too.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..models.structs import (ALGO_JOINT_NF, JobSlab, lane_view, n_lanes,
                              write_lane)
from ..sim import algos

EV_NOOP = 4
CLUSTER_COLS = 14
JOB_COLS = 15
QREC_FIELDS = 11
#: the kernel's compile-time limits (csrc/event_scan.cu kMaxDC/kMaxS/kMaxF)
MAX_DC, MAX_STREAMS, MAX_FREQS = 32, 64, 32
#: dynamic shared memory a block may opt into on Hopper, less a reserve for
#: the kernel's static shared state (the C entry point checks exactly)
SMEM_BUDGET = 232448 - 8192

JOB_FIELDS = tuple(f.name for f in dataclasses.fields(JobSlab))

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
)
#: the integer parameters, in csrc/event_scan.cu's `enum Int` order
INT_NAMES = (
    "R", "n_steps", "n_dc", "n_ing", "n_f", "n_cap", "J", "P", "Q", "W",
    "n_tab", "k_drain", "default_f_idx", "algo_joint_nf", "perf_first",
    "inf_priority", "reserve_inf_gpus", "max_gpus_per_job", "f_hi", "f_lo",
    "train_scale_out_low_freq",
)

_I32, _F32, _I64, _BOOL = torch.int32, torch.float32, torch.int64, torch.bool
_JOB_DTYPES = {
    "status": _I32, "jtype": _I32, "ingress": _I32, "dc": _I32, "seq": _I32,
    "size": _F32, "units_done": _F32, "n": _I32, "f_idx": _I32,
    "t_ingress": _F32, "t_avail": _F32, "t_start": _F32, "net_lat_s": _F32,
    "preempt_count": _I32, "preempt_t": _F32, "total_preempt_time": _F32,
    "spu": _F32, "watts": _F32,
}

_argtypes = None


def _get(obj, dotted: str):
    for part in dotted.split("."):
        obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
    return obj


def pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def smem_bytes(J: int) -> int:
    """Dynamic shared memory of one block: the slab and two [P] rows."""
    return 4 * (18 * J + 2 * pow2_at_least(J))


def _lane_specs(prog, R: int, n_tab: int):
    """{name: (dtype, shape)} of every per-lane leaf the kernel reads."""
    fleet, p = prog.fleet, prog.params
    n_dc, n_ing, J = fleet.n_dc, fleet.n_ing, p.job_cap
    S = 2 * n_ing
    lane = lambda *s: (R,) + s  # noqa: E731
    specs = {
        "t": (_F32, lane()), "key": (_I64, lane(2)), "jid_counter": (_I32, lane()),
        "started_accrual": (_BOOL, lane()), "t_first": (_F32, lane()),
        "next_log_t": (_F32, lane()), "n_events": (_I32, lane()),
        "n_finished": (_I32, lane(2)), "units_finished": (_F32, lane(2)),
        "n_dropped": (_I32, lane()), "done": (_BOOL, lane()),
        "dc.busy": (_I32, lane(n_dc)), "dc.cur_f_idx": (_I32, lane(n_dc)),
        "dc.energy_j": (_F32, lane(n_dc)), "dc.util_gpu_time": (_F32, lane(n_dc)),
        "dc.acc_job_unit": (_F32, lane(n_dc)),
        "next_arrival": (_F32, lane(n_ing, 2)), "arr_count": (_I32, lane(n_ing, 2)),
        "lat.buf": (_F32, lane(2, p.lat_window)), "lat.count": (_I32, lane(2)),
        "lat.ptr": (_I32, lane(2)),
        "queues.recs": (_F32, lane(n_dc, 2, p.queue_cap, QREC_FIELDS)),
        "queues.head": (_I32, lane(n_dc, 2)), "queues.tail": (_I32, lane(n_dc, 2)),
        "pre.sizes": (_F32, lane(S, n_tab)), "pre.tnext": (_F32, lane(S, n_tab)),
        "pre.c0": (_I32, lane(S)),
    }
    for f, dt in _JOB_DTYPES.items():
        specs["jobs." + f] = (dt, lane(J))
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


def event_scan_reference(prog, state, pre, n_steps: int):
    """Plain version: the plain step loop (``sim.step.StepProgram.scan_plain``),
    lane by lane, each lane advanced in place.  Returns (emissions, stats)."""
    R, _ = _validate(prog, state, pre, n_steps)
    ems = []
    stats = {"events": 0, "host_reads": 0}
    for r in range(R):
        st = lane_view(state, r)
        em, s = prog.scan_plain(st, {k: v[r] for k, v in pre.items()}, n_steps)
        write_lane(state, r, st)
        ems.append(em)
        for k in stats:
            stats[k] += s[k]
    return {k: torch.stack([e[k] for e in ems]) for k in ems[0]}, stats


def _lib():
    global _argtypes
    from . import build

    lib = build.load("event_scan")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.event_scan_launch.argtypes = [P, I, P, I, P, I, P]
        lib.event_scan_launch.restype = ctypes.c_int
        _argtypes = True
    return lib


def kernel_ints(prog, R: int, n_steps: int, n_tab: int):
    """The kernel's integer parameters for this engine, in INT_NAMES order."""
    fleet, p = prog.fleet, prog.params
    J = p.job_cap
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
    }
    return [int(vals[k]) for k in INT_NAMES]


def check_kernel_covers(prog) -> None:
    """Raise for a configuration beyond the kernel's limits (the port never
    falls back to the plain step on the card)."""
    fleet, J = prog.fleet, prog.params.job_cap
    if fleet.n_dc > MAX_DC or 2 * fleet.n_ing > MAX_STREAMS or fleet.n_f > MAX_FREQS:
        raise ValueError(
            f"event_scan: at most {MAX_DC} DCs, {MAX_STREAMS // 2} ingresses and "
            f"{MAX_FREQS} frequency levels (got {fleet.n_dc}, {fleet.n_ing}, "
            f"{fleet.n_f})")
    if smem_bytes(J) > SMEM_BUDGET:
        raise ValueError(
            f"event_scan: job_cap {J} needs {smem_bytes(J)} B of shared memory "
            f"per lane; the card offers {SMEM_BUDGET} B to the slab")


def event_scan(prog, state, pre, n_steps: int):
    """The B1 wrapper: kernel on a CUDA state, plain version on a CPU one.

    Advances ``state`` (leaves [R, ...]) by ``n_steps`` events in place;
    returns (emissions, stats).  Counts each kernel launch in
    ``event_scan.launches``."""
    R, n_tab = _validate(prog, state, pre, n_steps)
    dev = prog.device
    if dev.type == "cpu":
        return event_scan_reference(prog, state, pre, n_steps)
    if dev.type != "cuda":
        raise ValueError(f"event_scan: unsupported device {dev}")
    check_kernel_covers(prog)
    fleet = prog.fleet
    em = {
        "t": torch.empty((R, n_steps), dtype=_F32, device=dev),
        "branch": torch.full((R, n_steps), EV_NOOP, dtype=_I32, device=dev),
        "cluster": torch.zeros((R, n_steps, fleet.n_dc, CLUSTER_COLS),
                               dtype=_F32, device=dev),
        "job": torch.zeros((R, n_steps, JOB_COLS), dtype=_F32, device=dev),
    }
    consts = prog.kernel_consts()
    src = {"pre": pre, "em": em}
    ptrs = []
    for name in PTR_NAMES:
        head = name.split(".")[0]
        if head in ("pre", "em"):
            t = _get(src, name)
        elif name in consts:
            t = consts[name]
        else:
            t = _get(state, name)
        ptrs.append(t.data_ptr())
    ints = kernel_ints(prog, R, n_steps, n_tab)
    # csrc/event_scan.cu's `enum Flt` order
    floats = [float(prog.params.duration), float(prog.params.log_interval)]
    lib = _lib()
    c_ptrs = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.event_scan_launch(c_ptrs, len(ptrs), c_ints, len(ints),
                                   c_floats, len(floats), stream)
    if rc != 0:
        why = {-1: "pointer/parameter tables do not match the build",
               -2: "a shape beyond the kernel's limits",
               -3: "the slab does not fit in shared memory"}.get(
                   rc, f"cudaError {rc}")
        raise RuntimeError(f"event_scan kernel launch failed: {why}")
    event_scan.launches += 1
    return em, {"events": None, "host_reads": None}


event_scan.launches = 0
