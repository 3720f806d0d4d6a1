"""CLI: run one heuristic simulation on the card and write the CSV logs.

    python -m distributed_cluster_gpus_tpu_torch.run_sim --algo joint_nf \\
        --duration 600 --out runs/joint_nf [--device cpu]

The port's counterpart of the repo's ``run_sim.py`` for the flags this
slice honours.  ``--device`` defaults to ``cuda`` and never falls back to
the CPU.  The reference's other algorithms and flags exit with a message
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

ALL_ALGOS = ("default_policy", "cap_uniform", "cap_greedy", "joint_nf",
             "bandit", "carbon_cost", "eco_route", "chsac_af", "debug", "ppo")

# reference flags this slice does not honour -> the ROADMAP item porting them
UNPORTED_FLAGS = {
    "--workload": "queue A item 4 (workload presets and spec files)",
    "--workload-observe": "queue A item 4 (signal timelines)",
    "--power-cap": "queue A item 6 (cap controllers)",
    "--control-interval": "queue A item 6 (cap controllers)",
    "--eco-objective": "queue A item 5 (eco routing)",
    "--router-weights": "queue A item 5 (weighted routing)",
    "--num_fixed_gpus": "queue A item 5 (debug algo)",
    "--fixed_freq": "queue A item 5 (debug algo)",
    "--elastic-scaling": "queue A item 13 (elastic scaling)",
    "--sla_p99_ms": "queue A item 9 (chsac_af)",
    "--energy_budget_j": "queue A item 9 (chsac_af)",
    "--power-cap-constraint": "queue A item 9 (chsac_af)",
    "--rl-buffer": "queue A item 9 (chsac_af)",
    "--rl-batch": "queue A item 9 (chsac_af)",
    "--rl-warmup": "queue A item 9 (chsac_af)",
    "--rl-energy-weight": "queue A item 9 (chsac_af)",
    "--critic-arch": "queue A item 9 (chsac_af)",
    "--offline-dataset": "queue A item 10 (offline RL)",
    "--offline-steps": "queue A item 10 (offline RL)",
    "--fault-outage": "queue A item 11 (faults)",
    "--fault-derate": "queue A item 11 (faults)",
    "--fault-wan": "queue A item 11 (faults)",
    "--fault-mtbf": "queue A item 11 (faults)",
    "--fault-mttr": "queue A item 11 (faults)",
    "--fault-max-outages": "queue A item 11 (faults)",
    "--chaos": "queue A item 11 (chaos curricula)",
    "--chaos-stage": "queue A item 11 (chaos curricula)",
    "--campaign": "queue A item 15 (campaigns)",
    "--campaign-retries": "queue A item 15 (campaigns)",
    "--campaign-backoff": "queue A item 15 (campaigns)",
    "--population": "queue A item 15 (populations)",
    "--pbt-quantile": "queue A item 15 (populations)",
    "--pbt-perturb": "queue A item 15 (populations)",
    "--obs": "queue A item 12 (telemetry)",
    "--obs-watchdog": "queue A item 12 (telemetry)",
    "--obs-trace": "queue A item 12 (telemetry)",
    "--ckpt-dir": "queue A item 14 (checkpoints)",
    "--ckpt-every": "queue A item 14 (checkpoints)",
    "--ckpt-keep": "queue A item 14 (checkpoints)",
    "--no-resume": "queue A item 14 (checkpoints)",
    "--time-dtype": "queue A item 6 (float64 clock)",
    "--queue-mode": "queue A item 13 (slab queues)",
    "--superstep-k": "queue A item 13 (superstep K>1)",
    "--rollouts": "queue A item 8 (batched rollouts)",
    "--profile": "queue A item 17 (profiling)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="geo-distributed GPU-cluster simulator (PyTorch/CUDA port)")
    p.add_argument("--algo", default="default_policy", choices=ALL_ALGOS)
    p.add_argument("--duration", type=float, default=3600.0, help="simulated seconds")
    p.add_argument("--log-interval", type=float, default=20.0)
    p.add_argument("--out", default="runs/out", help="output dir for CSV logs")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--inf-mode", default="sinusoid", choices=["off", "poisson", "sinusoid"])
    p.add_argument("--inf-rate", type=float, default=6.0)
    p.add_argument("--inf-amp", type=float, default=0.6)
    p.add_argument("--inf-period", type=float, default=300.0)
    p.add_argument("--trn-mode", default="poisson", choices=["off", "poisson", "sinusoid"])
    p.add_argument("--trn-rate", type=float, default=0.3)
    p.add_argument("--policy", default="energy_aware", choices=["energy_aware", "perf_first"])
    p.add_argument("--max-gpus-per-job", type=int, default=8)
    p.add_argument("--no-inf-priority", action="store_true")
    p.add_argument("--reserve-inf-gpus", type=int, default=0)
    p.add_argument("--dvfs-low", type=float, default=0.6)
    p.add_argument("--dvfs-high", type=float, default=1.0)
    p.add_argument("--single-dc", action="store_true", help="1-DC/1-ingress debug fleet")
    p.add_argument("--job-cap", type=int, default=512)
    p.add_argument("--queue-cap", type=int, default=0,
                   help="per-(DC, jtype) queue-ring depth; 0 = auto-size")
    p.add_argument("--chunk-steps", type=int, default=4096)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a, unknown = p.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            p.exit(2, f"{p.prog}: {flag} is not ported yet (ROADMAP "
                      f"{UNPORTED_FLAGS[flag]})\n")
    if unknown:
        p.error(f"unrecognized arguments: {' '.join(unknown)}")
    if a.algo not in ("default_policy", "joint_nf"):
        item = {"chsac_af": "queue A item 9", "ppo": "queue A item 10"}.get(
            a.algo, "queue A items 5 and 6")
        p.exit(2, f"{p.prog}: --algo {a.algo} is not ported yet (ROADMAP {item})\n")
    if a.duration > 1e5:
        p.exit(2, f"{p.prog}: duration > 1e5 s needs the float64 clock, not "
                  "ported yet (ROADMAP queue A item 6)\n")
    return a


def build_params(a):
    from .models.structs import SimParams

    return SimParams(
        algo=a.algo, duration=a.duration, log_interval=a.log_interval,
        policy_name=a.policy, max_gpus_per_job=a.max_gpus_per_job,
        inf_priority=not a.no_inf_priority,
        reserve_inf_gpus=a.reserve_inf_gpus,
        dvfs_low=a.dvfs_low, dvfs_high=a.dvfs_high,
        inf_mode=a.inf_mode, inf_rate=a.inf_rate, inf_amp=a.inf_amp,
        inf_period=a.inf_period, trn_mode=a.trn_mode, trn_rate=a.trn_rate,
        job_cap=a.job_cap, seed=a.seed, queue_cap=max(0, a.queue_cap))


def finalize_queue_cap(params, fleet):
    """Resolve --queue-cap 0 into the drop-free auto size."""
    if params.queue_cap > 0:
        return params
    from .sim.engine import auto_queue_cap

    return dataclasses.replace(params, queue_cap=auto_queue_cap(params, fleet))


def main(argv=None, pre_tables=None):
    """Run the CLI; returns the final SimState.  ``pre_tables`` (tests only)
    injects each chunk's arrival tables."""
    a = parse_args(argv)
    from .configs.paper import build_fleet, build_single_dc_fleet
    from .sim.io import run_simulation

    fleet = build_single_dc_fleet() if a.single_dc else build_fleet()
    params = finalize_queue_cap(build_params(a), fleet)
    t0 = time.time()
    state = run_simulation(fleet, params, out_dir=a.out,
                           chunk_steps=a.chunk_steps, device=a.device,
                           pre_tables=pre_tables)
    wall = time.time() - t0
    if not a.quiet:
        n_fin = state.n_finished.tolist()
        print(f"done: t={float(state.t):.0f}s sim, {int(state.n_events)} events, "
              f"{n_fin[0]} inference + {n_fin[1]} training jobs finished, "
              f"{int(state.n_dropped)} dropped; {wall:.1f}s wall on {a.device} "
              f"-> logs in {a.out}")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
