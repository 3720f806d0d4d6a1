"""(n, f) energy tables for the grid optimizers, and the SLA sizing rule.

Counterpart of ``distributed_cluster_gpus_tpu/ops/optimizers.py``:
``nf_energy_table`` (``joint_nf`` reads it through
``sim.algos.admit_joint_nf``) and ``min_n_for_sla`` (the ``gpu_over`` cost
of the chsac_af reward record).  The reference's ``best_nf_grid`` is not
on the engine's path: carbon/cost admission scores the grid itself
(``sim.algos.admit_carbon_cost``).
"""

from __future__ import annotations

import torch

from .physics import LatencyCoeffs, PowerCoeffs, step_time_s, task_power_w


def nf_energy_table(n_max: int, freq_levels, pc: PowerCoeffs,
                    tc: LatencyCoeffs):
    """(T, P, E) tables over the full (n, f) grid, each [..., n_max, n_f].

    Row i is n = i+1, column j is ``freq_levels[j]``; ``...`` broadcasts the
    coefficient shape (e.g. [n_dc, n_jtype]).  Computed in float32 exactly
    as the JAX package computes it (``n`` enters as a float row)."""
    n = torch.arange(1, n_max + 1, dtype=torch.float32)[:, None]
    f = torch.as_tensor(freq_levels, dtype=torch.float32)[None, :]
    pc_b = PowerCoeffs(*(torch.as_tensor(c, dtype=torch.float32)[..., None, None]
                         for c in pc))
    tc_b = LatencyCoeffs(*(torch.as_tensor(c, dtype=torch.float32)[..., None, None]
                           for c in tc))
    T = step_time_s(n, f, tc_b)
    P = task_power_w(n, f, pc_b)
    return T, P, T * P


def min_n_for_sla(size, f, tc: LatencyCoeffs, sla_ms: float, n_max: int):
    """Smallest n in 1..n_max with ``size * T(n, f) * 1000 <= sla_ms``
    (int32), n_max when no n meets the SLA.  ``size`` and ``f`` are 0-d
    float32 tensors; ``tc`` holds one (dc, jtype)'s coefficients."""
    n = torch.arange(1, n_max + 1, dtype=torch.float32, device=size.device)
    T = step_time_s(n, f, tc)
    ok = size * T * 1000.0 <= torch.tensor(sla_ms, dtype=torch.float32,
                                           device=size.device)
    first_ok = torch.argmax(ok.to(torch.int32)) + 1
    return torch.where(ok.any(), first_ok,
                       torch.full_like(first_ok, n_max)).to(torch.int32)
