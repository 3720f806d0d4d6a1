"""(n, f) energy tables for the grid optimizers.

Counterpart of ``distributed_cluster_gpus_tpu/ops/optimizers.py``.  Only
the table builder is ported in this slice: ``joint_nf`` reads the table
through ``sim.algos.admit_joint_nf`` (a first-minimum argmin over it);
``best_nf_grid`` and ``min_n_for_sla`` serve carbon/cost admission and the
RL reward, which are later slices (ROADMAP queue A items 5 and 9).
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
