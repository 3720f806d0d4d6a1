"""Scheduling / routing / DVFS decisions for the heuristic algorithms.

Counterpart of the parts of ``distributed_cluster_gpus_tpu/sim/algos.py``
that ``default_policy`` and ``joint_nf`` run: the in-DC heuristic
allocation, the first-minimum (n, f) grid admission and uniform-random
ingress routing.  Inputs are 0-d device tensors; results are int32
tensors on the same device.  Carbon/cost admission, eco and weighted
routing and the RL observation/masks are ROADMAP queue A items 5 and 9.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.structs import FleetSpec, SimParams
from ..ops import prng


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


def route_random(key, n_dc: int):
    """Uniform-random DC: ``jax.random.randint(key, (), 0, n_dc)`` bit for bit."""
    return prng.randint(key, n_dc)
