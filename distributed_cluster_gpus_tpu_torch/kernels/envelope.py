"""The envelope of the learning update on the card: which configurations
its kernels take, checked before anything runs.

The JAX package's update trains at any batch and any head width; the
port's kernels each take a stated range of shapes (their plan functions
and limits).  :func:`update_refusals` runs every kernel's plan and limit
over the calls one update makes (``rl/sac.py::sac_train_step``: the
encoder twice, the actor twice, both critics' forward and backward, B5a,
B5b, the fused heads' backward) and says which refuse;
:func:`check_update` raises with the envelope in the message.  The CLI
(``run_sim.parse_args``) and ``CHSAC_AF`` call it for the card, so a
setting outside the envelope is refused at once, never after the warm-up,
and never falls back to the plain path.  The plain path (the CPU) has no
envelope.  :func:`card_limits` adds B1's limits for every algorithm; both
CLIs (``run_sim`` and ``eval``) call it at parse time.
"""

from __future__ import annotations

from typing import List, Optional

from . import dense, log_softmax, sac_update

#: what the card's update takes (the kernels' limits below give it)
ENVELOPE = ("the card's learning update takes --rl-batch 1 to 4,096, heads of "
            "up to 256 entries with n_dc + n_g <= 256, n_dc x n_g <= 1,024 "
            "joint actions and up to 64 quantiles (SACConfig: 32), with "
            "either critic")
#: the networks' hidden width (``rl/nets.py``: 256 as published)
HIDDEN = 256


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def update_refusals(batch: int, n_dc: int, n_g: int, obs_dim: int,
                    n_quantiles: int = 32, latent: int = 256,
                    critic_arch: str = "onehot") -> List[str]:
    """Why the card's update kernels refuse this configuration: one line
    a refusing kernel (empty: every call of an update fits its kernel)."""
    B, A, N, L, H = batch, n_dc * n_g, n_quantiles, latent, HIDDEN
    why = []

    def limit(ok, what):
        if not ok:
            why.append(what)

    limit(1 <= B <= sac_update.HUBER_MAX_B,
          f"B5a (quantile_huber) takes 1 to {sac_update.HUBER_MAX_B} batch "
          f"rows, not {B}")
    limit(1 <= N <= sac_update.HUBER_MAX_Q,
          f"B5a takes 1 to {sac_update.HUBER_MAX_Q} quantiles, not {N}")
    limit(_pow2(A) <= sac_update.MARGINAL_MAX_A,
          f"B5b (marginal_target, marginal_actor) takes up to "
          f"{sac_update.MARGINAL_MAX_A} joint actions, not {n_dc} x {n_g} = {A}")
    limit(max(_pow2(n_dc), _pow2(n_g)) <= sac_update.MARGINAL_MAX_HEAD,
          f"B5b takes heads of up to {sac_update.MARGINAL_MAX_HEAD} entries, "
          f"not {n_dc} and {n_g}")
    limit(B <= sac_update.ACTOR_MAX_B,
          f"B5b's actor term takes up to {sac_update.ACTOR_MAX_B} batch rows")
    limit(max(n_dc, n_g) <= log_softmax.MAX_HEAD and B <= log_softmax.MAX_ROWS,
          f"the heads' backward takes heads of up to {log_softmax.MAX_HEAD} "
          f"entries and {log_softmax.MAX_ROWS} rows")
    limit(B <= dense.MAX_ROWS,
          f"B5d's backward kernels take up to {dense.MAX_ROWS} rows, not {B}")
    if why or min(B, n_dc, n_g, N, obs_dim, L) < 1:
        return why or [f"empty shapes: batch {B}, heads {n_dc} x {n_g}, "
                       f"{N} quantiles, {obs_dim} observations"]
    heads_tma = n_dc % 8 == 0 and n_g % 8 == 0
    plans = [
        ("dense_fwd", dense.fwd_plan, (B, obs_dim, H),
         {"x_tma": obs_dim % 8 == 0}),
        ("dense_fwd", dense.fwd_plan, (B, H, H), {}),
        ("dense_fwd", dense.fwd_plan, (B, H, L), {}),
        ("dense_fwd", dense.fwd_plan, (B, L, H), {}),
        ("actor_heads_fwd", dense.heads_plan, (B, H, n_dc + n_g), {}),
        ("dense_dx", dense.dx_plan, (B, (H,)), {}),
        ("dense_dx", dense.dx_plan, (B, (L,)), {}),
        ("dense_dx", dense.dx_plan, (B, (n_dc, n_g)),
         {"tma": (heads_tma, heads_tma)}),
    ]
    if critic_arch == "heads":
        plans += [("dense_fwd", dense.fwd_plan, (B, H, A * N), {}),
                  ("dense_dx", dense.dx_plan, (B, (A * N,)), {})]
    else:
        plans += [
            ("critic_first_fwd", dense.critic_plan,
             (B * A, L, n_dc, n_g, H, False), {}),
            ("critic_first_fwd", dense.critic_plan,
             (B, L, n_dc, n_g, H, True), {"keep_rows": True}),
            ("dense_fwd", dense.fwd_plan, (B * A, H, H), {}),
            ("dense_fwd", dense.fwd_plan, (B * A, H, N), {}),
            ("dense_fwd", dense.fwd_plan, (B, H, N), {}),
            ("dense_dx", dense.dx_plan, (B, (N,)), {})]
    for name, plan, args, kw in plans:
        try:
            plan(*args, **kw)
        except ValueError as e:
            why.append(f"{name}: {e}")
    return why


def check_update(batch: int, n_dc: int, n_g: int, obs_dim: int,
                 n_quantiles: int = 32, latent: int = 256,
                 critic_arch: str = "onehot") -> None:
    """Raise ValueError, the envelope in the message, unless the card's
    update kernels take this configuration (:func:`update_refusals`)."""
    why = update_refusals(batch, n_dc, n_g, obs_dim, n_quantiles, latent,
                          critic_arch)
    if why:
        raise ValueError(
            f"chsac_af at batch {batch} with {n_dc} x {n_g} joint actions "
            f"({critic_arch} critic) is outside the card's envelope: "
            f"{ENVELOPE}; refused by " + "; ".join(why))


def check_config(cfg) -> None:
    """:func:`check_update` of a ``SACConfig``."""
    check_update(cfg.batch, cfg.n_dc, cfg.n_g, cfg.obs_dim, cfg.n_quantiles,
                 cfg.latent, cfg.critic_arch)


def card_limits(fleet, params) -> Optional[str]:
    """Why the card cannot run ``params`` on ``fleet``, or None: B1 (the
    event scan) takes at most 32 DCs, 32 ingresses and 32 frequency levels
    and keeps a lane's slab in one block's shared memory (priced in the
    run's clock and mode: the float64 clock's time columns and RL mode's
    latency windows take more a slot), for every algorithm; under chsac_af
    B1's RL mode acts with heads of at most 256 columns and the update's
    kernels take their envelope (:func:`check_update`).  The message
    states the limit and names the job cap ``job_cap``, as ``SimParams``
    does."""
    from .event_scan import (MAX_DC, MAX_FREQS, MAX_STREAMS, RL_ENVELOPE,
                             rl_covers, slab_fits, slab_limit_text)

    rl = params.algo == "chsac_af"
    n_g = params.max_gpus_per_job
    if (fleet.n_dc > MAX_DC or 2 * fleet.n_ing > MAX_STREAMS
            or fleet.n_f > MAX_FREQS):
        return (f"a fleet of {fleet.n_dc} DCs, {fleet.n_ing} ingresses and "
                f"{fleet.n_f} frequency levels is outside B1's limits: at most "
                f"{MAX_DC} DCs, {MAX_STREAMS // 2} ingresses and {MAX_FREQS} "
                "frequency levels")
    obs_dim = params.obs_dim(fleet.n_dc)
    if rl and not rl_covers(obs_dim, fleet.n_dc, n_g):
        return (f"chsac_af with {n_g} GPU-count actions is "
                f"outside the card's envelope: {RL_ENVELOPE}; {ENVELOPE}")
    if not slab_fits(params.job_cap, params.lat_window, rl, n_g, params.x64):
        return (f"{params.algo} with job_cap {params.job_cap} does not fit "
                "B1's shared memory: " + slab_limit_text(
                    params.lat_window, rl, n_g, params.x64))
    if rl:
        try:
            check_update(params.rl_batch, fleet.n_dc, n_g, obs_dim,
                         critic_arch=params.critic_arch)
        except ValueError as e:
            return f"{e}; {RL_ENVELOPE}"
    return None
