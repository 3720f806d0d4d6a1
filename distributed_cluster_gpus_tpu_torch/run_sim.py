"""CLI: run one simulation on the card and write the CSV logs.

    python -m distributed_cluster_gpus_tpu_torch.run_sim --algo joint_nf \\
        --duration 600 --out runs/joint_nf [--device cpu]
    python -m distributed_cluster_gpus_tpu_torch.run_sim --algo cap_greedy \\
        --power-cap 150000 --duration 600 --out runs/cap_greedy
    python -m distributed_cluster_gpus_tpu_torch.run_sim --algo chsac_af \\
        --duration 600 --out runs/chsac [--critic-arch heads]
    python -m distributed_cluster_gpus_tpu_torch.run_sim --algo joint_nf \\
        --duration 604800 --time-dtype float64 --out runs/week
    python -m distributed_cluster_gpus_tpu_torch.run_sim --algo chsac_af \\
        --duration 604800 --out runs/week_rl --ckpt-dir runs/week_rl/ckpt

The port's counterpart of the repo's ``run_sim.py`` for the flags the port
honours: every heuristic algorithm (``default_policy``, ``cap_uniform``,
``cap_greedy``, ``joint_nf``, ``bandit``, ``carbon_cost``, ``eco_route``,
``debug``) with the power cap and its control interval, the eco objective,
``--router-weights`` and debug's fixed GPU count and frequency, the
clock's dtype (``--time-dtype``, float64 above 1e5 s by default), and
``chsac_af`` online (the policy runs inside the event loop and feeds the
replay ring; once ``--rl-warmup`` transitions are in it, each chunk's SAC
and Lagrange updates run on the card and the next chunk acts with the
updated weights), with checkpoints (``--ckpt-dir``, ``--ckpt-every``,
``--ckpt-keep``; a run resumes from its store unless ``--no-resume``).
SIGTERM or SIGINT stops a run at the next chunk boundary with its
artifacts flushed, and the process exits with 128 + the signal's number.
``--device`` defaults to ``cuda`` and never falls back to the CPU; on the
card a setting outside a kernel's envelope is refused before anything is
written.  The reference's other flags (and ``--algo ppo``) exit with a
message naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ALL_ALGOS = ("default_policy", "cap_uniform", "cap_greedy", "joint_nf",
             "bandit", "carbon_cost", "eco_route", "chsac_af", "debug", "ppo")

# reference flags this slice does not honour -> the ROADMAP item porting them
UNPORTED_FLAGS = {
    "--workload": "queue A item 4 (workload presets and spec files)",
    "--workload-observe": "queue A item 4 (signal timelines)",
    "--elastic-scaling": "queue A item 13 (elastic scaling)",
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
    "--queue-mode": "queue A item 13 (slab queues)",
    "--superstep-k": "queue A item 13 (superstep K>1)",
    "--rollouts": "queue A item 8 (batched rollouts)",
    "--profile": "queue A item 17 (profiling)",
}


def parse_args(argv=None):
    # no abbreviations: an unported flag must not read as a prefix of a
    # ported one
    p = argparse.ArgumentParser(
        description="geo-distributed GPU-cluster simulator (PyTorch/CUDA port)",
        allow_abbrev=False)
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
    # controllers
    p.add_argument("--power-cap", type=float, default=0.0, help="W; 0 disables")
    p.add_argument("--control-interval", type=float, default=0.0,
                   help="s; 0 -> use --log-interval (reference behavior)")
    p.add_argument("--eco-objective", default="energy",
                   choices=["energy", "carbon", "cost"])
    p.add_argument("--router-weights", default=None, metavar="LAT,EN,CO2,USD,Q",
                   help="5 comma-separated weights (latency_s, energy_j, "
                        "carbon_g, cost_usd, queue_len): route arrivals by "
                        "the weighted DC score instead of uniform-random "
                        "(non-RL, non-eco_route algorithms)")
    # debug algo
    p.add_argument("--num_fixed_gpus", type=int, default=1)
    p.add_argument("--fixed_freq", type=float, default=None)
    p.add_argument("--job-cap", type=int, default=512)
    p.add_argument("--queue-cap", type=int, default=0,
                   help="per-(DC, jtype) queue-ring depth; 0 = auto-size")
    # RL / constraints (chsac_af)
    p.add_argument("--sla_p99_ms", type=float, default=500.0)
    p.add_argument("--energy_budget_j", type=float, default=None)
    p.add_argument("--power-cap-constraint", type=float, default=None,
                   help="power constraint target for the CMDP (defaults to "
                        "--power-cap)")
    p.add_argument("--rl-buffer", type=int, default=200_000)
    p.add_argument("--rl-batch", type=int, default=256)
    p.add_argument("--rl-warmup", type=int, default=1_000)
    p.add_argument("--rl-energy-weight", type=float, default=1.0,
                   help="weight on the reward's energy term")
    p.add_argument("--critic-arch", default="onehot",
                   choices=["onehot", "heads"],
                   help="onehot = reference-shaped critic (one-hot action "
                        "input); heads = per-joint-action output heads")
    p.add_argument("--time-dtype", default="auto",
                   choices=["auto", "float32", "float64"],
                   help="the clock's dtype; auto = float64 above 1e5 s "
                        "(with the reference's x64 numerics), else float32")
    # checkpoints (chsac_af)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir (chsac_af): saves and resumes. Saves "
                        "commit atomically with a digest manifest and resume "
                        "walks a verified fallback chain (offline check: "
                        "python -m distributed_cluster_gpus_tpu_torch.fsck_ckpt)")
    p.add_argument("--ckpt-every", type=int, default=50,
                   help="chunks between saves")
    p.add_argument("--ckpt-keep", type=int, default=0,
                   help="keep only the newest N verified checkpoints (0 = keep "
                        "all); stale crash-staging debris is swept after every "
                        "save either way")
    p.add_argument("--no-resume", action="store_true")
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
    if a.algo == "ppo":
        p.exit(2, f"{p.prog}: --algo ppo is not ported yet (ROADMAP queue A "
                  "item 10)\n")
    if a.ckpt_every < 1:
        p.error("--ckpt-every must be at least 1 chunk")
    if a.device == "cuda":
        # the card's kernels each take a stated envelope: refuse a setting
        # outside one now, before any file is written, not at the first
        # chunk or the first update after the warm-up
        why = card_refusal(a)
        if why:
            p.exit(2, f"{p.prog}: {why}\n")
    return a


def card_refusal(a):
    """Why the card cannot run this CLI setting, or None: B1 (the event
    scan) takes at most 32 DCs, 32 ingresses and 32 frequency levels and
    keeps a lane's slab in one block's shared memory (priced in the run's
    clock and mode: the float64 clock's time columns and RL mode's latency
    windows take more a slot), for every algorithm; under chsac_af B1's RL
    mode acts with heads of at most 256 columns and the update's kernels
    take their envelope (``kernels/envelope.py``).  The message states the
    limit."""
    from .configs.paper import build_fleet, build_single_dc_fleet
    from .kernels.envelope import ENVELOPE, check_update
    from .kernels.event_scan import (MAX_DC, MAX_FREQS, MAX_STREAMS,
                                     RL_ENVELOPE, rl_covers, slab_fits,
                                     slab_limit_text)

    fleet = build_single_dc_fleet() if a.single_dc else build_fleet()
    params = build_params(a)
    rl = a.algo == "chsac_af"
    if (fleet.n_dc > MAX_DC or 2 * fleet.n_ing > MAX_STREAMS
            or fleet.n_f > MAX_FREQS):
        return (f"a fleet of {fleet.n_dc} DCs, {fleet.n_ing} ingresses and "
                f"{fleet.n_f} frequency levels is outside B1's limits: at most "
                f"{MAX_DC} DCs, {MAX_STREAMS // 2} ingresses and {MAX_FREQS} "
                "frequency levels")
    obs_dim = params.obs_dim(fleet.n_dc)
    if rl and not rl_covers(obs_dim, fleet.n_dc, a.max_gpus_per_job):
        return (f"chsac_af with {a.max_gpus_per_job} GPU-count actions is "
                f"outside the card's envelope: {RL_ENVELOPE}; {ENVELOPE}")
    if not slab_fits(a.job_cap, params.lat_window, rl, a.max_gpus_per_job,
                     params.x64):
        return (f"{a.algo} with --job-cap {a.job_cap} does not fit B1's "
                "shared memory: " + slab_limit_text(
                    params.lat_window, rl, a.max_gpus_per_job, params.x64))
    if rl:
        try:
            check_update(a.rl_batch, fleet.n_dc, a.max_gpus_per_job, obs_dim,
                         critic_arch=a.critic_arch)
        except ValueError as e:
            return f"{e}; {RL_ENVELOPE}"
    return None


def resolve_time_dtype(a) -> str:
    """``--time-dtype auto``: float64 above 1e5 simulated seconds (the
    reference's rule, repo ``run_sim.py``), float32 otherwise."""
    if a.time_dtype == "auto":
        return "float64" if a.duration > 1e5 else "float32"
    return a.time_dtype


def build_params(a):
    from .models.structs import SimParams

    return SimParams(
        time_dtype=resolve_time_dtype(a),
        algo=a.algo, duration=a.duration,
        log_interval=(a.control_interval if a.control_interval > 0
                      else a.log_interval),
        policy_name=a.policy, max_gpus_per_job=a.max_gpus_per_job,
        inf_priority=not a.no_inf_priority,
        reserve_inf_gpus=a.reserve_inf_gpus,
        dvfs_low=a.dvfs_low, dvfs_high=a.dvfs_high,
        inf_mode=a.inf_mode, inf_rate=a.inf_rate, inf_amp=a.inf_amp,
        inf_period=a.inf_period, trn_mode=a.trn_mode, trn_rate=a.trn_rate,
        job_cap=a.job_cap, seed=a.seed, queue_cap=max(0, a.queue_cap),
        sla_p99_ms=a.sla_p99_ms, energy_budget_j=a.energy_budget_j,
        power_cap_constraint=a.power_cap_constraint,
        rl_buffer=a.rl_buffer, rl_batch=a.rl_batch, rl_warmup=a.rl_warmup,
        rl_energy_weight=a.rl_energy_weight, critic_arch=a.critic_arch,
        power_cap=a.power_cap, eco_objective=a.eco_objective,
        router_weights=(tuple(float(w) for w in a.router_weights.split(","))
                        if a.router_weights else None),
        num_fixed_gpus=a.num_fixed_gpus, fixed_freq=a.fixed_freq)


def finalize_queue_cap(params, fleet):
    """Resolve --queue-cap 0 into the drop-free auto size."""
    if params.queue_cap > 0:
        return params
    from .sim.engine import auto_queue_cap

    return dataclasses.replace(params, queue_cap=auto_queue_cap(params, fleet))


def main(argv=None, pre_tables=None):
    """Run the CLI; returns the final SimState.  ``pre_tables`` (tests only)
    injects each chunk's arrival tables.  SIGTERM or SIGINT stops the run
    at the next chunk boundary (``utils/shutdown.py``): the CSVs are
    flushed, ``run_summary.json`` says "interrupted", a chsac_af run with
    ``--ckpt-dir`` saves that chunk, and the process exits with 128 + the
    signal's number."""
    a = parse_args(argv)
    from .configs.paper import build_fleet, build_single_dc_fleet
    from .device import resolve_device
    from .sim.io import run_simulation
    from .utils.logging import get_logger
    from .utils.shutdown import graceful_shutdown
    from .utils.validators import validate_gpus

    resolve_device(a.device)  # no card: raise before anything is written
    fleet = build_single_dc_fleet() if a.single_dc else build_fleet()
    params = finalize_queue_cap(build_params(a), fleet)
    os.makedirs(a.out, exist_ok=True)
    log = get_logger(a.out)
    for w in validate_gpus(fleet, strict=False):
        print(f"[gpu-validate] {w}")
        log.warning("gpu-validate: %s", w)
    t0 = time.time()
    extra = ""
    with graceful_shutdown() as shutdown:
        if a.algo == "chsac_af":
            from .rl.train import train_chsac

            state, agent, _ = train_chsac(
                fleet, params, out_dir=a.out, chunk_steps=a.chunk_steps,
                verbose=not a.quiet, ckpt_dir=a.ckpt_dir,
                ckpt_every_chunks=a.ckpt_every, ckpt_keep=a.ckpt_keep,
                resume=not a.no_resume, shutdown=shutdown, device=a.device,
                pre_tables=pre_tables)
            extra = (f"; {int(agent.replay.n_seen)} transitions in the replay "
                     f"ring, {agent.sac.step} train steps")
        else:
            state = run_simulation(fleet, params, out_dir=a.out,
                                   chunk_steps=a.chunk_steps, device=a.device,
                                   pre_tables=pre_tables, progress=not a.quiet,
                                   shutdown=shutdown)
    wall = time.time() - t0
    n_fin = state.n_finished.tolist()
    msg = (f"done: t={float(state.t):.0f}s sim, {int(state.n_events)} events, "
           f"{n_fin[0]} inference + {n_fin[1]} training jobs finished, "
           f"{int(state.n_dropped)} dropped; {wall:.1f}s wall on {a.device} "
           f"-> logs in {a.out}{extra}")
    if not a.quiet:
        print(msg)
    log.info(msg)
    if shutdown.requested:
        # the artifacts are flushed and run_summary.json says "interrupted";
        # exit nonzero (128 + signum, the shell convention) so wrappers and
        # schedulers see the interruption
        msg = (f"interrupted by signal {shutdown.signum}: artifacts "
               f"flushed, exiting {shutdown.exit_code}")
        print(msg)
        log.warning(msg)
        sys.exit(shutdown.exit_code)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
