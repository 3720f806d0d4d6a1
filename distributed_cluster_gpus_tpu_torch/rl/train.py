"""The chsac_af run loop: chunk -> CSV drain -> ingest -> updates.

Counterpart of ``distributed_cluster_gpus_tpu/rl/train.py``'s ``make_agent``
(``:234``), ``warm_sac_from_checkpoint`` (``:251``) and ``train_chsac``
(``:333``).  Each chunk runs the engine with the agent's policy (on the
card: the B1 kernel in RL mode, the policy inside the event loop), drains
the chunk's CSV rows (the native writer), ingests its transition stream
into the replay ring
(the B6a kernel on the card) and then runs the chunk's SAC/CMDP updates
(``CHSAC_AF.train_steps``: B6b, B5a, B5b and B5c on the card), one per new
transition up to ``max_train_steps_per_chunk``, once the ring holds
``--rl-warmup`` transitions.  The next chunk acts with the updated
weights.  ``history`` keeps the last update's metrics of each chunk that
updated, as numpy; ``verbose`` prints the reference's per-chunk line (the
progress bar, the ring's size, the last critic loss and lambda) and, at the
end, the phase timer's summary.  The loop is serial, as the reference's is
(each chunk acts with the weights the previous chunk's updates wrote); it
times the reference's phases: ``rollout`` (fenced on the state), ``io``
(the drain), ``ingest``, ``train`` (fenced on the update's metrics) and the
checkpoint's ``ckpt_save`` and ``ckpt_restore``.

With ``ckpt_dir`` the whole run (the learner, the replay ring, the agent's
key, the simulation state and the CSVs' byte watermark) is saved to the
verified store of ``utils/checkpoint.py`` every ``ckpt_every_chunks``
chunks, when the run ends and when it stops on a shutdown flag, and a run
resumes from the newest verified step: a resumed run's CSVs and final
state are byte for byte those of the run left uninterrupted.  The
telemetry sink raises as unported (ROADMAP queue A item 12).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import bridge
from ..models.structs import FleetSpec, SimParams
from ..sim.engine import Engine, init_state
from ..obs.trace import PhaseTimer, sim_progress
from ..sim.io import CSVWriters, drain_emissions
from .agent import CHSAC_AF
from .cmdp import constraints_from_params

#: the checkpoint's CSV byte-watermark subtree
_WM_LIKE = {"cluster": 0, "job": 0}


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


def _ckpt_metadata(fleet, params, fingerprint: str, chunk: int) -> Dict:
    """Run-identity metadata stamped into the checkpoint manifest: enough to
    tell from the store alone which run wrote it and at which chunk (the
    reference's keys; the port has no chaos curricula or workload presets
    yet, so those are null)."""
    workload = getattr(params, "workload", None)
    return {
        "seed": int(params.seed),
        "algo": params.algo,
        "chunk": int(chunk),
        "params_fingerprint": fingerprint,
        "time_dtype": params.time_dtype,
        "chaos": None,
        "workload": getattr(workload, "name", None),
    }


def _save_watermark(writers) -> Dict[str, int]:
    """The checkpoint's byte-watermark subtree: the CSVs' sizes (the port's
    runs write the two CSVs only)."""
    return writers.offsets() if writers else dict(_WM_LIKE)


def _open_writers(out_dir: Optional[str], fleet: FleetSpec, start_chunk: int,
                  csv_watermark: Optional[Dict[str, int]],
                  signal_cols: bool = False) -> Optional[CSVWriters]:
    """CSV writers for a (possibly resumed) run: append on resume,
    truncating back to the checkpoint's byte watermark so rows a stopped or
    crashed run wrote past its last checkpoint are not duplicated."""
    if not out_dir:
        return None
    writers = CSVWriters(out_dir, fleet, append=start_chunk > 0,
                         signal_cols=signal_cols)
    if csv_watermark is not None:
        writers.truncate_to(csv_watermark)
    return writers


def _run_log(out_dir: Optional[str]):
    """project.log logger for in-run RL notices (None without an out_dir)."""
    if not out_dir:
        return None
    from ..utils.logging import get_logger

    return get_logger(out_dir)


def _log_rl_chunk(log, chunk: int, t: float, metrics, n_new: int) -> None:
    """One line per updating chunk in project.log (the reference's
    ``_log_rl_chunk``), from the host copy of the chunk's last metrics."""
    if log is None or metrics is None:
        return
    log.info(
        "rl-update chunk=%d t=%.0f n_new=%d critic_loss=%.6g "
        "actor_loss=%.6g alpha=%.4g entropy=%.4g lambda=%s violation=%s",
        chunk, t, n_new,
        float(np.asarray(metrics.get("critic_loss", np.nan))),
        float(np.asarray(metrics.get("actor_loss", np.nan))),
        float(np.asarray(metrics.get("alpha", np.nan))),
        float(np.asarray(metrics.get("entropy", np.nan))),
        np.asarray(metrics.get("lambda", np.nan)).tolist(),
        np.asarray(metrics.get("violation", np.nan)).tolist(),
    )


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _spec(x):
    """A tensor's shape and dtype as an unfilled host array (no copy): the
    template a restore's layout check reads."""
    return np.empty(tuple(x.shape), _np_dtype(x.dtype))


def ckpt_trees(agent: CHSAC_AF, state, wm: Dict[str, int]) -> Dict:
    """The trees a checkpoint holds, in the JAX package's names and
    layouts: ``sac`` (``bridge.sac_to_numpy``), ``replay``
    (``bridge.replay_to_numpy``), ``key`` (the agent's two uint32 words),
    ``sim`` (``bridge.state_to_numpy``) and ``csv`` (the byte watermark)."""
    return {"sac": bridge.sac_to_numpy(agent.cfg, agent.sac),
            "replay": bridge.replay_to_numpy(agent.replay),
            "key": agent.key.numpy().astype(np.uint32),
            "sim": bridge.state_to_numpy(state),
            "csv": {k: np.int64(v) for k, v in wm.items()}}


def _ckpt_like(agent: CHSAC_AF, state) -> Dict:
    """The live run's layout of :func:`ckpt_trees`, without copying the
    learner, the ring or the state off the device."""
    sim = bridge.tree_to_numpy(state, _spec)
    for k in bridge._KEY_FIELDS:
        sim[k] = np.empty(sim[k].shape, np.uint32)
    return {"sac": bridge.sac_to_numpy(agent.cfg, agent.sac, _spec),
            "replay": bridge.tree_to_numpy(agent.replay, _spec),
            "key": np.empty((2,), np.uint32), "sim": sim,
            "csv": {k: np.int64(v) for k, v in _WM_LIKE.items()}}


def restore_run(ckpt_dir: str, agent: CHSAC_AF, state, params,
                fingerprint: str, verbose: bool = False):
    """Restore the newest verified step of ``ckpt_dir`` into ``agent`` and
    return (SimState on the agent's device, step, CSV watermark), or None
    for a store with no committed step.

    The verified fallback chain skips an uncommitted or corrupt step with a
    logged reason.  Nothing else is passed over: a store whose committed
    steps all fail verification, one written by another configuration
    (its params fingerprint: the fleet and every ``SimParams`` field, the
    clock's dtype included) or one whose trees do not match the live layout
    raises; the run never carries on from a fresh state.  The learner and
    the ring are replaced (``agent.sac``/``agent.replay``: the captured
    update is dropped, the bf16 shadows filled from the restored masters,
    the warm-up gate read again)."""
    from ..utils.checkpoint import (restore_checkpoint, steps,
                                    verified_manifests)

    committed = steps(ckpt_dir)
    step, man = next(iter(verified_manifests(ckpt_dir)), (None, None))
    if step is None:
        if committed:
            raise RuntimeError(
                f"checkpoint store {ckpt_dir}: none of its {len(committed)} "
                "committed steps verifies (see the log for each reason); "
                "pass --no-resume or another --ckpt-dir to start fresh")
        return None
    meta = man.get("metadata", {})
    if meta.get("params_fingerprint") != fingerprint:
        raise RuntimeError(
            f"checkpoint {ckpt_dir} step {step} was written by another "
            f"configuration (params fingerprint "
            f"{meta.get('params_fingerprint')}, this run's {fingerprint}; "
            f"time_dtype {meta.get('time_dtype')!r} vs {params.time_dtype!r}); "
            "pass --no-resume or another --ckpt-dir to start fresh")
    try:
        out = restore_checkpoint(ckpt_dir, step,
                                 like=_ckpt_like(agent, state),
                                 verify=False)
    except (ValueError, KeyError) as e:
        raise RuntimeError(
            f"checkpoint {ckpt_dir} step {step} is structurally incompatible "
            f"with this version ({e}); delete the checkpoint dir or pass "
            "--no-resume to start fresh") from e
    dev = agent.device
    agent.sac = bridge.sac_from_numpy(agent.cfg, out["sac"], dev)
    agent.replay = bridge.replay_from_numpy(out["replay"], dev)
    agent.key = torch.from_numpy(out["key"].astype(np.int64))
    state = bridge.state_from_numpy(out["sim"], dev)
    wm = {k: int(v) for k, v in out["csv"].items()}
    if verbose:
        print(f"resumed from {ckpt_dir} at chunk {step}")
    return state, step, wm


def warm_sac_from_checkpoint(cfg, ckpt_dir: str, key, step=None,
                             device="cuda"):
    """A fresh learner for ``cfg`` (``sac_init`` from ``key``) on ``device``
    with the encoder and actor parameters grafted from a saved run's
    checkpoint: a policy-only warm start.  The critic, target critic,
    temperature, CMDP multipliers and every optimizer state stay fresh, so
    the donor's critic architecture and constraints need not match; only
    the observation and action widths must.  ``step=None`` walks the
    verified fallback chain (a corrupt newest step degrades to the previous
    one with a logged reason)."""
    from ..utils.checkpoint import restore_checkpoint
    from .sac import refresh_shadows, sac_init

    sac = sac_init(cfg, key, device)
    donor = restore_checkpoint(ckpt_dir, step, names=["sac"])["sac"]
    with torch.no_grad():
        for group, tree in (("enc", donor["enc_params"]),
                            ("actor", donor["actor_params"])):
            vals = bridge._flat_np(tree, bridge._layer_names(sac, group))
            flat = sac.flat[group]
            if vals.shape != tuple(flat.shape):
                raise ValueError(f"{group}: the donor has {vals.size} "
                                 f"parameters, this config {flat.numel()}")
            flat.copy_(torch.from_numpy(vals))
    refresh_shadows(sac)
    return sac


def train_chsac(fleet: FleetSpec, params: SimParams,
                out_dir: Optional[str] = None, chunk_steps: int = 2048,
                max_chunks: int = 10_000, train_every_n: int = 1,
                max_train_steps_per_chunk: int = 256,
                agent: Optional[CHSAC_AF] = None, verbose: bool = False,
                ckpt_dir: Optional[str] = None, ckpt_every_chunks: int = 50,
                ckpt_keep: int = 0, resume: bool = True, on_chunk=None,
                obs=None, shutdown=None, device="cuda",
                pre_tables: Optional[Sequence[Dict]] = None):
    """Run a chsac_af simulation with online training: act with ``agent``'s
    policy, feed its replay ring, and after each chunk run
    ``min(n_new // train_every_n, max_train_steps_per_chunk)`` updates once
    warmed up.  Returns (final SimState, agent, history of the last update
    metrics of each chunk that updated).  ``on_chunk(chunk, state,
    history)`` runs after every chunk, before its checkpoint;
    ``pre_tables`` (tests) injects the arrival tables of chunk ``c`` as
    ``pre_tables[c]``, a resumed run's too.  The agent's device is the
    run's: ``device`` builds a default agent there.  ``run_summary.json``
    carries the loop's phase split as its ``host_phases``.

    ``ckpt_dir``: save the run to that verified store every
    ``ckpt_every_chunks`` chunks, when it ends and when it stops, as step
    ``chunk``; ``ckpt_keep`` > 0 prunes the store to the newest N verified
    steps after each save (0 keeps all; staging debris is swept either
    way).  With ``resume`` the run continues from the newest verified step
    (:func:`restore_run`).  ``shutdown`` (a ``utils.shutdown.ShutdownFlag``):
    once it trips, the loop stops at the next chunk boundary, saves a
    checkpoint of that chunk and writes ``run_summary.json`` with
    ``status="interrupted"`` (which the resumed run, once it completes,
    rewrites as "completed").  A failed save or restore raises."""
    if params.algo != "chsac_af":
        raise ValueError(f"train_chsac runs chsac_af, not {params.algo!r}")
    if obs is not None:
        raise NotImplementedError("train_chsac: obs is not ported yet "
                                  "(ROADMAP queue A item 12 (telemetry))")
    if agent is None:
        agent = make_agent(fleet, params, device)
    engine = Engine(fleet, params, device=agent.device,
                    policy_apply=agent.policy_apply)
    state = init_state(params.seed, fleet, params, workload=engine.workload,
                       device=engine.device)
    start_chunk, csv_watermark, fingerprint = 0, None, ""
    timer = PhaseTimer()
    if ckpt_dir:
        from ..utils.checkpoint import config_fingerprint

        fingerprint = config_fingerprint(fleet, params)
        if resume:
            t0 = time.perf_counter()
            got = restore_run(ckpt_dir, agent, state, params, fingerprint,
                              verbose)
            if got is not None:
                state, step, csv_watermark = got
                start_chunk = step + 1
                timer.add_span("ckpt_restore", time.perf_counter() - t0)
    writers = _open_writers(out_dir, fleet, start_chunk, csv_watermark,
                            signal_cols=engine.signals is not None)
    run_log = _run_log(out_dir)

    def save_ckpt(chunk):
        from ..utils.checkpoint import gc_checkpoints, save_checkpoint

        with timer.phase("ckpt_save"):
            save_checkpoint(ckpt_dir, step=chunk,
                            metadata=_ckpt_metadata(fleet, params,
                                                    fingerprint, chunk),
                            **ckpt_trees(agent, state,
                                         _save_watermark(writers)))
            gc_checkpoints(ckpt_dir, keep=ckpt_keep or None)

    history: List[Dict] = []
    status = "completed"
    for chunk in range(start_chunk, max_chunks):
        pre = None
        if pre_tables is not None:
            pre = {k: torch.tensor(np.asarray(v), device=engine.device)
                   for k, v in pre_tables[chunk].items()}
        with timer.phase("rollout", fence=lambda: state.t):
            state, emissions = engine.run_chunk(state, chunk_steps, pre=pre,
                                                policy_params=agent.sac)
        with timer.phase("io"):
            drain_emissions(emissions, writers)
        n_new = int(emissions["rl"]["valid"].sum())
        with timer.phase("ingest"):
            agent.ingest_chunk(emissions["rl"])
        n_want = min(n_new // max(train_every_n, 1), max_train_steps_per_chunk)
        with timer.phase("train", fence=lambda: agent.sac.metrics):
            metrics, n_done = (
                agent.train_steps(n_want, max_train_steps_per_chunk)
                if n_want else (None, 0))
        if metrics is not None:
            history.append({k: v.detach().cpu().numpy()
                            for k, v in metrics.items()})
            _log_rl_chunk(run_log, chunk, float(state.t), history[-1], n_done)
        if verbose:
            m = history[-1] if metrics is not None else None
            extra = (f"replay={int(agent.replay.size)} "
                     + (f"critic_loss={float(m['critic_loss']):.4f} "
                        f"lambda={np.asarray(m['lambda'])}"
                        if m is not None else "warming up"))
            print(sim_progress(float(state.t), params.duration, extra=extra))
        done = bool(state.done)
        # on_chunk before the checkpoint: a kill between the two re-runs
        # (and re-reports) the chunk on resume instead of losing it
        if on_chunk is not None:
            on_chunk(chunk, state, history)
        stop = shutdown is not None and shutdown.requested and not done
        if ckpt_dir and (done or stop or (chunk + 1) % ckpt_every_chunks == 0):
            save_ckpt(chunk)
        if done:
            break
        if stop:
            status = "interrupted"
            break
    if out_dir:
        from ..obs.export import (SUMMARY_FILE, host_phase_seconds,
                                  write_status_summary)

        # a run that stops leaves its status; a resumed run that completes
        # replaces the "interrupted" one its stop left
        if status != "completed" or os.path.exists(
                os.path.join(out_dir, SUMMARY_FILE)):
            write_status_summary(out_dir, algo=params.algo, fleet=fleet,
                                 state=state, status=status,
                                 host_phases=host_phase_seconds(timer))
    if verbose:
        print(timer.summary())
    return state, agent, history
