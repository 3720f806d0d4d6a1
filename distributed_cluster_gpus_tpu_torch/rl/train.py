"""The chsac_af run loop: chunk -> CSV drain -> ingest -> updates.

Counterpart of ``distributed_cluster_gpus_tpu/rl/train.py``'s ``make_agent``
(``:234``) and ``train_chsac`` (``:333``).  Each chunk runs the engine with
the agent's policy (on the card: the B1 kernel in RL mode, the policy inside
the event loop), drains the chunk's CSV rows, ingests its transition stream
into the replay ring (the B6a kernel on the card) and then runs the chunk's
SAC/CMDP updates (``CHSAC_AF.train_steps``: B6b, B5a, B5b and B5c on the
card), one per new transition up to ``max_train_steps_per_chunk``, once the
ring holds ``--rl-warmup`` transitions.  The next chunk acts with the
updated weights.  ``history`` keeps the last update's metrics of each
chunk that updated, as numpy; ``verbose`` prints the reference's
per-chunk line (the progress bar, the ring's size, the last critic loss
and lambda).

Checkpoints, the telemetry sink and graceful shutdown raise as unported
(ROADMAP queue A items 14, 12 and 14).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.structs import FleetSpec, SimParams
from ..sim.engine import Engine, init_state
from ..sim.io import CSVWriters, drain_emissions, sim_progress
from .agent import CHSAC_AF
from .cmdp import constraints_from_params


def make_agent(fleet: FleetSpec, params: SimParams, device="cuda") -> CHSAC_AF:
    """The CLI-default CHSAC-AF agent for this (fleet, params) on
    ``device`` (the card unless the caller asks for the CPU)."""
    return CHSAC_AF(
        obs_dim=params.obs_dim(fleet.n_dc),
        n_dc=fleet.n_dc,
        n_g_choices=params.max_gpus_per_job,
        constraints=constraints_from_params(params),
        buffer_capacity=params.rl_buffer,
        batch=params.rl_batch,
        warmup=params.rl_warmup,
        seed=params.seed,
        critic_arch=params.critic_arch,
        x64=params.x64,
        device=device)


def train_chsac(fleet: FleetSpec, params: SimParams,
                out_dir: Optional[str] = None, chunk_steps: int = 2048,
                max_chunks: int = 10_000, train_every_n: int = 1,
                max_train_steps_per_chunk: int = 256,
                agent: Optional[CHSAC_AF] = None, verbose: bool = False,
                ckpt_dir: Optional[str] = None, on_chunk=None, obs=None,
                shutdown=None, device="cuda",
                pre_tables: Optional[Sequence[Dict]] = None):
    """Run a chsac_af simulation with online training: act with ``agent``'s
    policy, feed its replay ring, and after each chunk run
    ``min(n_new // train_every_n, max_train_steps_per_chunk)`` updates once
    warmed up.  Returns (final SimState, agent, history of the last update
    metrics of each chunk that updated).  ``on_chunk(chunk, state,
    history)`` runs after every chunk; ``pre_tables`` (tests) injects each
    chunk's arrival tables.  The agent's device is the run's: ``device``
    builds a default agent there."""
    if params.algo != "chsac_af":
        raise ValueError(f"train_chsac runs chsac_af, not {params.algo!r}")
    for name, val, item in (("ckpt_dir", ckpt_dir, "queue A item 14 (checkpoints)"),
                            ("obs", obs, "queue A item 12 (telemetry)"),
                            ("shutdown", shutdown,
                             "queue A item 14 (graceful shutdown)")):
        if val is not None:
            raise NotImplementedError(f"train_chsac: {name} is not ported yet "
                                      f"(ROADMAP {item})")
    if agent is None:
        agent = make_agent(fleet, params, device)
    engine = Engine(fleet, params, device=agent.device,
                    policy_apply=agent.policy_apply)
    state = init_state(params.seed, fleet, params, workload=engine.workload,
                       device=engine.device)
    writers = CSVWriters(out_dir, fleet) if out_dir else None
    history: List[Dict] = []
    for chunk in range(max_chunks):
        pre = None
        if pre_tables is not None:
            pre = {k: torch.tensor(np.asarray(v), device=engine.device)
                   for k, v in pre_tables[chunk].items()}
        state, emissions = engine.run_chunk(state, chunk_steps, pre=pre,
                                            policy_params=agent.sac)
        drain_emissions(emissions, writers)
        n_new = int(emissions["rl"]["valid"].sum())
        agent.ingest_chunk(emissions["rl"])
        n_want = min(n_new // max(train_every_n, 1), max_train_steps_per_chunk)
        metrics, n_done = (agent.train_steps(n_want, max_train_steps_per_chunk)
                           if n_want else (None, 0))
        if metrics is not None:
            history.append({k: v.detach().cpu().numpy()
                            for k, v in metrics.items()})
        if verbose:
            m = history[-1] if metrics is not None else None
            extra = (f"replay={int(agent.replay.size)} "
                     + (f"critic_loss={float(m['critic_loss']):.4f} "
                        f"lambda={np.asarray(m['lambda'])}"
                        if m is not None else "warming up"))
            print(sim_progress(float(state.t), params.duration, extra=extra))
        if on_chunk is not None:
            on_chunk(chunk, state, history)
        if bool(state.done):
            break
    return state, agent, history
