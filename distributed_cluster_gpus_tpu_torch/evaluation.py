"""The policy-comparison harness over the five BASELINE.json configs.

Counterpart of ``distributed_cluster_gpus_tpu/evaluation.py``: every
algorithm runs the same workload realization (the arrival chains are a pure
function of the seed), and each run reduces to one summary row (energy,
completions, drops, sojourn-time mean and p99 per job type, energy per
unit of work).  ``run_algo`` runs one algorithm (``run_simulation``, or
``train_chsac`` online for chsac_af), ``compare`` several on one workload,
``compare_seeds`` over seeds with mean and sample sd; ``baseline_config``
and ``variant_config`` build the configs.  Every entry point runs on the
card unless the caller asks for the CPU.

The reduction reads the final state once on the host; the p99 is the exact
linear-interpolation percentile over the latency window's valid prefix,
evaluated in float32 as the reference's ``windowed_percentile`` evaluates
it.  Not ported yet: chsac_af through the distributed trainer (``rollouts >
1``, a warm start, ``sac_steps_per_chunk``), ``run_ppo``, ``eval_warmstart``
and ``eval_config5`` (ROADMAP queue A item 10), ``chaos_score`` (item 15),
and the bodies of ``fault_metrics`` and ``obs_metrics`` (items 11 and 12):
the port's state has no faults or telemetry, so a row carries the keys of
the reference's rows for such a run.  A run whose workload declares
price or carbon timelines adds ``energy_cost_usd`` and ``carbon_kg``
(``signal_metrics``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .configs.paper import build_fleet, build_single_dc_fleet
from .models.structs import SimParams


@dataclasses.dataclass
class Summary:
    algo: str
    energy_kwh: float
    completed_inf: int
    completed_trn: int
    dropped: int
    mean_lat_inf_s: float
    p99_lat_inf_s: float
    mean_lat_trn_s: float
    p99_lat_trn_s: float
    energy_per_unit_wh: float
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def windowed_percentile(buf_row: np.ndarray, count: int, q: float) -> float:
    """Linear-interpolation percentile over the first ``min(count, W)``
    entries of a latency ring row, in float32."""
    W = buf_row.shape[0]
    m = int(min(count, W))
    vals = np.sort(np.asarray(buf_row[:m], np.float32))
    mf = max(m, 1)
    pos = np.float32(q / 100.0) * np.float32(mf - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, mf - 1)
    frac = pos - np.float32(lo)
    s_lo, s_hi = vals[lo], vals[hi]
    return float(s_lo * (np.float32(1.0) - frac) + s_hi * frac)


def _lat_stats(lat_buf: np.ndarray, lat_count: np.ndarray, jt: int):
    """(mean, p99) sojourn seconds of job type ``jt`` over the window."""
    m = int(min(lat_count[jt], lat_buf.shape[1]))
    if m == 0:
        return float("nan"), float("nan")
    mean = float(np.mean(lat_buf[jt, :m]))
    p99 = (windowed_percentile(lat_buf[jt], int(lat_count[jt]), 99.0)
           if m >= 5 else float("nan"))
    return mean, p99


def fault_metrics(fleet, state) -> Dict[str, float]:
    """Degraded-mode metrics of a fault-enabled run: none, since the port's
    state has no fault sub-state yet (ROADMAP queue A item 11)."""
    return {}


def signal_metrics(state) -> Dict[str, float]:
    """Energy cost and carbon totals of a run with signal timelines (else
    {}): the accumulators integrate ``P dt price(t)`` and ``P dt ci(dc, t)``
    over the exact inter-event gaps, the time-varying counterparts of
    ``energy_kwh``, summed over the DCs by numpy as the reference sums them."""
    if getattr(state, "signals", None) is None:
        return {}
    return {
        "energy_cost_usd": float(_np(state.signals.cost_usd).sum()),
        "carbon_kg": float(_np(state.signals.carbon_g).sum()) / 1e3,
    }


def obs_metrics(state) -> Dict[str, int]:
    """Watchdog totals of a telemetry-enabled run: none, since the port's
    state has no telemetry yet (ROADMAP queue A item 12)."""
    return {}


def _summarize(algo: str, fleet, state, extra: Optional[Dict] = None) -> Summary:
    lat_buf = _np(state.lat.buf)
    lat_count = _np(state.lat.count)
    mean_inf, p99_inf = _lat_stats(lat_buf, lat_count, 0)
    mean_trn, p99_trn = _lat_stats(lat_buf, lat_count, 1)
    units = float(_np(state.units_finished).sum())
    kwh = float(_np(state.dc.energy_j).sum()) / 3.6e6
    n_fin = _np(state.n_finished)
    extra = dict(extra or {})
    extra.update(fault_metrics(fleet, state))
    extra.update(obs_metrics(state))
    extra.update(signal_metrics(state))
    return Summary(
        algo=algo,
        energy_kwh=kwh,
        completed_inf=int(n_fin[0]),
        completed_trn=int(n_fin[1]),
        dropped=int(_np(state.n_dropped)),
        mean_lat_inf_s=mean_inf,
        p99_lat_inf_s=p99_inf,
        mean_lat_trn_s=mean_trn,
        p99_lat_trn_s=p99_trn,
        energy_per_unit_wh=kwh * 1000.0 / max(units, 1e-9),
        extra=extra,
    )


def run_algo(fleet, params: SimParams, chunk_steps: int = 4096,
             rollouts: int = 1, init_sac=None,
             sac_steps_per_chunk: Optional[int] = None,
             device="cuda") -> Summary:
    """One algorithm on one workload -> Summary; chsac_af trains online
    (``train_chsac``) and its row carries ``train_steps``.  chsac_af through
    the distributed trainer (``rollouts > 1``, ``init_sac``,
    ``sac_steps_per_chunk``) raises: ROADMAP queue A item 10."""
    if params.algo == "chsac_af" and (rollouts > 1 or init_sac is not None
                                      or sac_steps_per_chunk is not None):
        raise NotImplementedError(
            "chsac_af with rollouts > 1, init_sac or sac_steps_per_chunk runs "
            "the distributed trainer, not ported yet (ROADMAP queue A item "
            "10); rollouts=1 runs train_chsac")
    if init_sac is not None or sac_steps_per_chunk is not None:
        # a silently dropped warm start or update schedule would corrupt
        # the experiment
        raise ValueError("init_sac / sac_steps_per_chunk are only supported "
                         "for chsac_af with rollouts > 1 (the "
                         "distributed-trainer path)")
    if params.algo == "chsac_af":
        from .rl.train import train_chsac

        state, agent, _ = train_chsac(fleet, params, out_dir=None,
                                      chunk_steps=chunk_steps, device=device)
        return _summarize(params.algo, fleet, state,
                          {"train_steps": int(agent.sac.step)})
    from .sim.io import run_simulation

    state = run_simulation(fleet, params, out_dir=None,
                           chunk_steps=chunk_steps, device=device)
    return _summarize(params.algo, fleet, state)


def compare(fleet, base: SimParams, algos: Sequence[str],
            chunk_steps: int = 4096, verbose: bool = True,
            rollouts: int = 1, device="cuda") -> List[Summary]:
    """Run every algorithm on the identical workload, in order.  ``ppo``
    raises before anything runs: ROADMAP queue A item 10."""
    if "ppo" in algos:
        raise NotImplementedError("ppo (run_ppo, PPOTrainer) is not ported "
                                  "yet (ROADMAP queue A item 10)")
    out = []
    for algo in algos:
        params = dataclasses.replace(base, algo=algo)
        s = run_algo(fleet, params, chunk_steps, rollouts=rollouts,
                     device=device)
        out.append(s)
        if verbose:
            print(f"  {algo:>15s}: {s.energy_kwh:9.2f} kWh, "
                  f"p99_inf {s.p99_lat_inf_s:8.4f}s, "
                  f"done {s.completed_inf}+{s.completed_trn}, "
                  f"Wh/unit {s.energy_per_unit_wh:.4f}")
    return out


def compare_seeds(fleet, base: SimParams, algos: Sequence[str],
                  seeds: Sequence[int], chunk_steps: int = 4096,
                  verbose: bool = True, rollouts: int = 1,
                  device="cuda") -> Dict:
    """:func:`compare` over several seeds -> {"per_seed", "aggregate",
    "run_shape"}: the mean and sample sd of every numeric field per
    algorithm (the sd NaN below 2 finite samples, with ``<key>_n_finite``
    where a sample was NaN), and the run's shape, which merged tables must
    share (``scripts/merge_eval.py``)."""
    per_seed: Dict[int, List[Dict]] = {}
    for sd in seeds:
        if verbose:
            print(f"  -- seed {sd}")
        rows = compare(fleet, dataclasses.replace(base, seed=sd), algos,
                       chunk_steps=chunk_steps, verbose=verbose,
                       rollouts=rollouts, device=device)
        per_seed[sd] = [s.row() for s in rows]

    aggregate = []
    for i, algo in enumerate(algos):
        rows = [per_seed[sd][i] for sd in seeds]
        agg: Dict[str, object] = {"algo": algo, "n_seeds": len(seeds)}
        for k in rows[0]:
            vals = [r[k] for r in rows]
            if all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in vals):
                arr = np.asarray(vals, dtype=np.float64)
                finite = arr[~np.isnan(arr)]
                # NaN, not 0.0, below 2 finite samples: "no variance
                # measured" must not read as "zero variance over N seeds"
                agg[f"{k}_mean"] = (float(finite.mean()) if finite.size
                                    else float("nan"))
                agg[f"{k}_sd"] = (float(finite.std(ddof=1))
                                  if finite.size > 1 else float("nan"))
                if finite.size != arr.size:
                    agg[f"{k}_n_finite"] = int(finite.size)
        aggregate.append(agg)
    return {"per_seed": {str(k): v for k, v in per_seed.items()},
            "aggregate": aggregate,
            "run_shape": {
                "duration": base.duration, "rollouts": rollouts,
                "job_cap": base.job_cap, "queue_mode": base.queue_mode,
                "queue_cap": base.queue_cap,
                "inf": [base.inf_mode, base.inf_rate],
                "trn": [base.trn_mode, base.trn_rate],
            }}


# ---------------------------------------------------------------------------
# The five BASELINE configs
# ---------------------------------------------------------------------------

def _with_auto_queue(spec: Dict) -> Dict:
    """Pin the spec's queue-ring depth to the drop-free auto size, sized for
    8 rollouts (the harness's distributed-trainer width on configs 4 and 5)
    so the memory guard holds for the widest run the spec is used in."""
    from .sim.engine import auto_queue_cap

    base = spec["base"]
    if base is not None and base.queue_mode == "ring":
        spec["base"] = dataclasses.replace(
            base, queue_cap=auto_queue_cap(base, spec["fleet"], rollouts=8))
    return spec


def baseline_config(n: int, duration: float) -> Dict:
    """{"fleet", "base" SimParams, "algos"} of BASELINE.json config n."""
    if n == 1:
        return _with_auto_queue(dict(
            fleet=build_single_dc_fleet(),
            base=SimParams(algo="debug", duration=duration, log_interval=20.0,
                           inf_mode="poisson", inf_rate=4.0, trn_mode="off",
                           num_fixed_gpus=1, fixed_freq=1.0, job_cap=512),
            algos=["debug", "default_policy"],
        ))
    if n == 2:
        return _with_auto_queue(dict(
            fleet=build_single_dc_fleet(),
            base=SimParams(algo="joint_nf", duration=duration,
                           log_interval=20.0, inf_mode="poisson",
                           inf_rate=4.0, trn_mode="poisson", trn_rate=0.05,
                           job_cap=512),
            algos=["default_policy", "joint_nf", "bandit"],
        ))
    if n == 3:
        return _with_auto_queue(dict(
            fleet=build_fleet(),
            base=SimParams(algo="eco_route", duration=duration,
                           log_interval=20.0, inf_mode="sinusoid",
                           inf_rate=6.0, trn_mode="poisson", trn_rate=0.05,
                           job_cap=512),
            algos=["default_policy", "joint_nf", "carbon_cost", "eco_route"],
        ))
    if n == 4:
        return _with_auto_queue(dict(
            fleet=build_fleet(),
            # job_cap 2048: chsac_af may place every job at n=1, up to
            # 1,488 running jobs on this fleet
            base=SimParams(algo="chsac_af", duration=duration,
                           log_interval=20.0, inf_mode="sinusoid",
                           inf_rate=6.0, trn_mode="poisson", trn_rate=0.05,
                           rl_warmup=256, rl_batch=256, job_cap=2048),
            algos=["default_policy", "joint_nf", "eco_route", "chsac_af"],
        ))
    if n == 5:
        # config 4's workload with PPO beside the others; its scaling point
        # (eval_config5) waits for ROADMAP queue A item 10
        spec = baseline_config(4, duration)
        spec["algos"] = ["default_policy", "joint_nf", "eco_route",
                         "chsac_af", "ppo"]
        return spec
    raise ValueError(f"unknown BASELINE config {n}")


def variant_config(name: str, duration: float) -> Dict:
    """The diagnostic variants: ``3c`` (config 3 with a zero hourly price
    and the carbon objective, where carbon_cost diverges from joint_nf),
    ``3s`` and ``4s`` (configs 3 and 4 at a training rate under capacity,
    job_cap 1024: the steady state, no drops)."""
    if name == "3c":
        spec = baseline_config(3, duration)
        fleet = spec["fleet"]
        zero_price = np.zeros_like(np.asarray(fleet.price_hourly))
        spec["fleet"] = dataclasses.replace(fleet, price_hourly=zero_price)
        spec["base"] = dataclasses.replace(spec["base"],
                                           eco_objective="carbon")
        spec["algos"] = ["joint_nf", "carbon_cost", "eco_route"]
        return _with_auto_queue(spec)
    if name in ("3s", "4s"):
        spec = baseline_config(3 if name == "3s" else 4, duration)
        spec["base"] = dataclasses.replace(spec["base"], trn_rate=0.004,
                                           job_cap=1024)
        return _with_auto_queue(spec)
    raise ValueError(f"unknown variant config {name!r}")
