"""CLI: the algorithm comparison over the BASELINE configs, on the card.

    python -m distributed_cluster_gpus_tpu_torch.eval --config 3 --duration 600
    python -m distributed_cluster_gpus_tpu_torch.eval --config 4 --rollouts 1 \\
        --json out.json
    python -m distributed_cluster_gpus_tpu_torch.eval --config 2 --seeds 3
    python -m distributed_cluster_gpus_tpu_torch.eval --config 1 --device cpu

The port's counterpart of the repo's ``eval.py``: the same flags, the same
lines on stdout and the same JSON (per-seed rows, mean and sd aggregates,
the run shape; strict JSON through ``utils/jsonio.py``), so
``scripts/merge_eval.py`` and ``plot_eval.py`` read it unchanged.
``--device`` defaults to ``cuda`` and raises without a card.  Before any
run and before any file is written it refuses, naming the ROADMAP item
that ports them: ``--warmstart``, ``--ppo-scale`` and ``--critic-arch``;
``ppo`` in a config's algorithm set; chsac_af with ``--rollouts`` above 1
on configs 4, 4s and 5 (the distributed trainer; ``--rollouts 1`` runs
``train_chsac``); and, on the card, any (config, algorithm) outside the
kernels' limits (``kernels/envelope.py::card_limits``).
"""

from __future__ import annotations

import argparse
import sys

CONFIG_CHOICES = ["1", "2", "3", "4", "5", "3c", "3s", "4s"]
#: configs whose chsac_af runs through the distributed trainer at --rollouts
ROLLOUT_CONFIGS = ("4", "4s", "5")
A10 = "ROADMAP queue A item 10 (the distributed trainer, offline RL and PPO)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="algorithm comparison over the BASELINE configs "
                    "(PyTorch/CUDA port)", allow_abbrev=False)
    ap.add_argument("--config", choices=CONFIG_CHOICES, default=None)
    ap.add_argument("--all", action="store_true",
                    help="configs 1-5 (not the diagnostic variants)")
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--chunk-steps", type=int, default=4096)
    ap.add_argument("--seeds", type=int, default=1,
                    help="workload realizations per algorithm (>=3 for "
                         "mean±sd aggregates)")
    ap.add_argument("--seed0", type=int, default=123,
                    help="first seed; runs use seed0..seed0+seeds-1")
    ap.add_argument("--rollouts", type=int, default=8,
                    help="distributed-trainer rollouts for chsac_af on "
                         "configs 4/4s/5 (1 = single-world train_chsac, the "
                         "one the port runs)")
    ap.add_argument("--algos", default=None,
                    help="comma list restricting a config's algorithm set")
    ap.add_argument("--ppo-scale", type=int, default=None, metavar="R")
    ap.add_argument("--json", default=None)
    ap.add_argument("--warmstart", action="store_true")
    ap.add_argument("--pretrain-steps", type=int, default=2000)
    ap.add_argument("--critic-arch", choices=["onehot", "heads"],
                    default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    for flag, given in (("--warmstart", a.warmstart),
                        ("--ppo-scale", a.ppo_scale is not None),
                        ("--critic-arch", a.critic_arch is not None)):
        if given:
            ap.exit(2, f"{ap.prog}: {flag} is not ported yet ({A10})\n")
    a.plan = plan(a, ap)
    return a


def plan(a, ap):
    """[(config name, spec)] the run will make, each spec's algorithm set
    restricted by ``--algos``; refuses (exit 2) what the port cannot run."""
    from .evaluation import baseline_config, variant_config
    from .kernels.envelope import card_limits

    configs = [str(c) for c in range(1, 6)] if a.all else [a.config or "4"]
    out = []
    for n in configs:
        spec = (variant_config(n, a.duration) if n in ("3c", "3s", "4s")
                else baseline_config(int(n), a.duration))
        if a.algos:
            keep = [s.strip() for s in a.algos.split(",") if s.strip()]
            unknown = set(keep) - set(spec["algos"])
            if unknown:
                ap.error(f"--algos {sorted(unknown)} not in config {n}'s "
                         f"set {spec['algos']}")
            spec["algos"] = keep
        if "ppo" in spec["algos"]:
            ap.exit(2, f"{ap.prog}: config {n}'s ppo is not ported yet ({A10}); "
                       "restrict the set with --algos\n")
        if ("chsac_af" in spec["algos"] and n in ROLLOUT_CONFIGS
                and a.rollouts > 1):
            ap.exit(2, f"{ap.prog}: chsac_af on config {n} at --rollouts "
                       f"{a.rollouts} runs the distributed trainer, not ported "
                       f"yet ({A10}); --rollouts 1 runs on the port today\n")
        if a.device == "cuda":
            import dataclasses

            for algo in spec["algos"]:
                why = card_limits(spec["fleet"],
                                  dataclasses.replace(spec["base"], algo=algo))
                if why:
                    ap.exit(2, f"{ap.prog}: config {n}: {why}\n")
        out.append((n, spec))
    return out


def main(argv=None):
    """Run the comparison; returns {"config<n>": compare_seeds(...)}."""
    a = parse_args(argv)
    from .device import resolve_device
    from .evaluation import compare_seeds

    resolve_device(a.device)  # no card: raise before anything runs
    seeds = list(range(a.seed0, a.seed0 + a.seeds))
    results = {}
    for n, spec in a.plan:
        print(f"=== BASELINE config {n}")
        rollouts = a.rollouts if n in ROLLOUT_CONFIGS else 1
        out = compare_seeds(spec["fleet"], spec["base"], spec["algos"], seeds,
                            chunk_steps=a.chunk_steps, rollouts=rollouts,
                            device=a.device)
        results[f"config{n}"] = out
        if a.seeds > 1:
            print(f"  -- aggregate over {a.seeds} seeds (mean±sd)")
            for agg in out["aggregate"]:
                print(f"  {agg['algo']:>15s}: "
                      f"{agg['energy_kwh_mean']:9.2f}±{agg['energy_kwh_sd']:.2f} kWh, "
                      f"p99_inf {agg['p99_lat_inf_s_mean']:.4f}"
                      f"±{agg['p99_lat_inf_s_sd']:.4f}s, "
                      f"done {agg['completed_inf_mean']:.0f}"
                      f"+{agg['completed_trn_mean']:.0f}, "
                      f"Wh/unit {agg['energy_per_unit_wh_mean']:.4f}"
                      f"±{agg['energy_per_unit_wh_sd']:.4f}")
    if a.json:
        from .utils.jsonio import dump_json_atomic

        dump_json_atomic(a.json, results)
        print(f"wrote {a.json}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
