"""Scheduling / routing / DVFS decisions, and the RL observation and masks.

Counterpart of the parts of ``distributed_cluster_gpus_tpu/sim/algos.py``
the port runs: the in-DC heuristic allocation, the first-minimum (n, f)
grid admission (energy, and carbon or cost by the hour), uniform-random,
eco and weighted ingress routing, the windowed latency percentile (B3's
plain version) and the policy's observation vector and action masks.
Inputs are device tensors; results are on the same device.

The eco scores divide an energy in joules by 3.6e6.  XLA rewrites
``x / 3.6e6`` into ``x * fl(1/3.6e6)`` and, where a price multiplies the
result, scales the price first: ``E / 3.6e6 * price`` is computed as
``E * (price * fl(1/3.6e6))`` and ``E / 3.6e6 * ci`` (a per-DC vector) as
``(E * fl(1/3.6e6)) * ci`` (read from the JAX engine's optimized HLO).  The
functions below write each site in that association (``KWH``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.structs import FleetSpec, SimParams
from ..ops import prng
from ..ops.physics import fma_f32


def f_idx_of(fleet: FleetSpec, value: float) -> int:
    """Nearest ladder index for a frequency value (host-side, config time)."""
    return int(np.argmin(np.abs(fleet.freq_levels - value)))


def heuristic_select(params: SimParams, fleet: FleetSpec, jtype, free,
                     cur_f_idx, q_inf_len):
    """`select_gpus_and_set_freq` parity: (g, new DC ladder index)."""
    hi = f_idx_of(fleet, params.dvfs_high)
    lo = f_idx_of(fleet, params.dvfs_low)
    default = fleet.default_f_idx
    g = torch.clamp(torch.clamp(free, max=params.max_gpus_per_job), min=1)
    is_inf = jtype == 0
    hi_t = torch.full_like(cur_f_idx, hi)
    if params.policy_name == "perf_first":
        want = torch.where(q_inf_len > 0, hi_t, torch.full_like(cur_f_idx, default))
        trn_f = torch.maximum(cur_f_idx, want)
    else:  # energy_aware
        lo_t = torch.full_like(cur_f_idx, lo)
        if params.train_scale_out_low_freq:
            trn_f = torch.where(free >= 2, lo_t, torch.maximum(cur_f_idx, lo_t))
        else:
            trn_f = torch.maximum(cur_f_idx, lo_t)
    new_f = torch.where(is_inf, hi_t, trn_f)
    return g.to(torch.int32), new_f.to(torch.int32)


def _first_min_flat(score):
    """argmin over an [n_max, n_f] grid, first minimum wins (n-major)."""
    n_f = score.shape[-1]
    flat = torch.argmin(score.reshape(-1))
    return (flat // n_f + 1).to(torch.int32), (flat % n_f).to(torch.int32)


def admit_joint_nf(E_grid, dc, jtype):
    """(n*, f_idx*) minimising energy per unit over the (capped) grid."""
    return _first_min_flat(E_grid[dc, jtype])


def best_energy_f_idx_at_n(E_grid, dc, jtype, n):
    """argmin_f E at fixed n."""
    return torch.argmin(E_grid[dc, jtype, n - 1]).to(torch.int32)


#: float32(1 / 3.6e6): XLA's multiplier for ``/ 3.6e6``
KWH = float(np.float32(1.0 / 3.6e6))


def hour_of(t):
    """The hour of the day of a float32 clock (``Engine._hour``): exactly
    ``floor((t mod 86400) / 3600)`` clipped to [0, 23], as XLA's
    ``floor_divide`` gives it (``t - t mod 3600`` is an exact multiple of
    3600)."""
    from ..ops.arrivals import tmod

    day = tmod(t, 86400.0)
    whole = day - tmod(day, 3600.0)
    h = torch.round(whole / torch.tensor(3600.0, dtype=whole.dtype,
                                         device=whole.device))
    return torch.clamp(h.to(torch.int32), 0, 23)


def admit_carbon_cost(E_grid, dc, jtype, price, ci):
    """(n*, f_idx*): the first minimum of the cost score ``E * (price *
    KWH)`` over the (capped) grid when the hour's price is positive, else
    of the carbon score ``E * ci``.  A DC with ``ci == 0`` scores every
    cell 0, so its first cell wins (the reference's quirk, kept)."""
    E = E_grid[dc, jtype]
    pc = price * torch.tensor(KWH, dtype=torch.float32, device=E.device)
    score = torch.where(price > 0.0, E * pc, E * ci)
    return _first_min_flat(score)


def eco_unit_energy(E_grid, jtype, objective: str, price, ci):
    """[n_dc] energy per unit at each DC's own best grid cell (first
    minimum, n-major) under ``objective`` (``route_eco``'s first half)."""
    E = E_grid[:, jtype]  # [n_dc, n_max, n_f]
    if objective == "carbon":
        grid = E * ci[:, None, None]
    elif objective == "cost":
        grid = E * (price * torch.tensor(KWH, dtype=torch.float32,
                                         device=E.device))
    else:
        grid = E
    flat = E.reshape(E.shape[0], -1)
    best = torch.argmin(grid.reshape(grid.shape[0], -1), dim=-1)
    return torch.gather(flat, 1, best[:, None])[:, 0]


def route_eco(E_grid, jtype, size, objective: str, price, ci):
    """The DC of least job score (first minimum over the DC order): energy
    ``E_unit * size`` J, carbon ``(E_unit * size) * KWH * ci`` g or cost
    ``(E_unit * size) * (price * KWH)`` USD, ``E_unit`` at each DC's best
    cell (``sim/algos.py:138`` of the JAX package)."""
    e_unit = eco_unit_energy(E_grid, jtype, objective, price, ci)
    kwh = torch.tensor(KWH, dtype=torch.float32, device=e_unit.device)
    e_job = e_unit * size
    if objective == "carbon":
        score = (e_job * kwh) * ci
    elif objective == "cost":
        score = e_job * (price * kwh)
    else:
        score = e_job
    return torch.argmin(score).to(torch.int32)


def route_weighted(policy, net_lat_row, E_unit_min, size, price, ci, q_len):
    """The DC of least :class:`~..network.RouterPolicy` score: latency, the
    job's energy at each DC's least-energy cell (``E_unit_min`` [n_dc]),
    its carbon ``(E_job * KWH) * ci`` and cost ``E_job * (price * KWH)``,
    and the DC's queue length, weighted and summed left to right."""
    kwh = torch.tensor(KWH, dtype=torch.float32, device=E_unit_min.device)
    e_job = E_unit_min * size
    score = policy.score(latency_s=net_lat_row, energy_j=e_job,
                         carbon_g=(e_job * kwh) * ci,
                         cost_usd=e_job * (price * kwh),
                         queue_len=q_len.to(torch.float32))
    return torch.argmin(score).to(torch.int32)


def route_random(key, n_dc: int):
    """Uniform-random DC: ``jax.random.randint(key, (), 0, n_dc)`` bit for bit."""
    return prng.randint(key, n_dc)


# ---------------------------------------------------------------------------
# RL observation / masks (chsac_af)
# ---------------------------------------------------------------------------

def percentile_k(W: int, q: float = 99.0) -> int:
    """How many order statistics ``windowed_percentile`` keeps: the top
    ``ceil((1 - q/100) W) + 2`` (23 at W = 2048, q = 99)."""
    return min(W, int(np.ceil((1.0 - float(q) / 100.0) * W)) + 2)


def windowed_percentile(buf, count, q: float = 99.0):
    """B3's plain version: ``np.percentile`` (linear interpolation) over the
    valid prefix ``buf[..., :min(count, W)]`` of a latency ring, from its top
    ``percentile_k(W, q)`` order statistics, exactly as the JAX package's
    ``windowed_percentile`` computes it (``distributed_cluster_gpus_tpu/sim/
    algos.py:210``).  ``buf`` is [..., W] float32 and ``count`` [...] int32;
    returns [...] float32.  The interpolation ``s_lo * (1 - frac) + s_hi *
    frac`` rounds as XLA's CPU code rounds it, with the second product fused
    into the add (:func:`~..ops.physics.fma_f32`; measured against the JAX
    package, ``tests/test_torch_rl_obs.py``); an empty window gives NaN
    there too (``-inf * 0``)."""
    W = buf.shape[-1]
    q = float(q)
    K = percentile_k(W, q)
    f32 = torch.float32
    m = torch.clamp(count, max=W)
    valid = torch.arange(W, device=buf.device) < m[..., None]
    top = torch.topk(torch.where(valid, buf, torch.full_like(buf, -math.inf)),
                     K, dim=-1).values  # descending
    mf = torch.clamp(m, min=1)
    pos = torch.tensor(q / 100.0, dtype=f32, device=buf.device) * (mf - 1).to(f32)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.minimum(lo + 1, mf - 1)
    frac = pos - lo.to(f32)
    # ascending index i is descending rank m - 1 - i; both ranks < K
    r_lo = torch.clamp(mf - 1 - lo, 0, K - 1).to(torch.int64)
    r_hi = torch.clamp(mf - 1 - hi, 0, K - 1).to(torch.int64)
    s_lo = torch.gather(top, -1, r_lo[..., None])[..., 0]
    s_hi = torch.gather(top, -1, r_hi[..., None])[..., 0]
    return fma_f32(s_hi, frac, s_lo * (1.0 - frac))


def rl_obs(fleet: FleetSpec, t, busy, cur_f_idx, q_inf_len, q_trn_len,
           consts):
    """[now] + per-DC [total, busy, free, current f, q_inf, q_trn] (dim
    1 + 6 n_dc, DC-major), normalised to O(1) ranges as the JAX package's
    ``rl_obs`` does: time as the fraction of the day, busy/free as fractions
    of the DC, totals and queue lengths log-compressed.  ``consts`` holds
    the device constants (``total_f``, ``freq_levels``, ``inv7``,
    ``inv_day``).  XLA turns ``x / 7`` and ``x / 86400`` into multiplies by
    the float32 reciprocals, so the port multiplies too; ``torch.log1p`` may
    differ from XLA's by an ulp."""
    total = consts["total_f"]
    busy_f = busy.to(torch.float32)
    free = torch.clamp(total - busy_f, min=0.0)
    cf = consts["freq_levels"][cur_f_idx]
    feats = torch.stack(
        [torch.log1p(total) * consts["inv7"],
         busy_f / total,
         free / total,
         cf,
         torch.log1p(q_inf_len.to(torch.float32)) * 0.25,
         torch.log1p(q_trn_len.to(torch.float32)) * 0.25],
        dim=-1).reshape(-1)
    from ..ops.arrivals import tmod

    t_frac = (tmod(t, 86400.0) * consts["inv_day"]).to(torch.float32)
    return torch.cat([t_frac.reshape(1), feats])


def rl_masks(params: SimParams, fleet: FleetSpec, busy, lat_count, p99_pair,
             total, reserve=0):
    """(mask_dc [n_dc], mask_g [n_g]) bool: a DC is feasible when it has a
    free GPU (less ``reserve`` for a training decision); GPU count g + 1 is
    feasible up to the most free GPUs of any DC, capped at 1 when the recent
    p99 (the training window when it has samples, else inference) sits
    below 90% of the SLO (the SLO-slack heuristic).  ``p99_pair`` holds both
    windows' ``windowed_percentile`` ([2] seconds)."""
    free = torch.clamp(total - busy - reserve, min=0)
    mask_dc = free > 0
    max_free = free.max()
    n_g = params.max_gpus_per_job
    g_range = torch.arange(1, n_g + 1, dtype=torch.int32, device=busy.device)
    mask_g = g_range <= max_free
    use_trn = lat_count[1] > 0
    cnt = torch.where(use_trn, lat_count[1], lat_count[0])
    p99 = torch.where(use_trn, p99_pair[1], p99_pair[0])
    thr = torch.tensor(0.9 * params.sla_p99_ms, dtype=torch.float32,
                       device=busy.device)
    slack = (cnt >= 5) & (p99 * 1000.0 < thr)
    capped = g_range <= torch.clamp(max_free, max=1)
    return mask_dc, torch.where(slack, capped, mask_g)
