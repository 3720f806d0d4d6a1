"""PID-Lagrangian CMDP: the cost layout, the effective reward and the
multiplier update.

Counterpart of ``distributed_cluster_gpus_tpu/rl/cmdp.py``: ``ConstraintSpec``
with its PID gains (``:21``), ``CMDPState``, ``cmdp_init``, ``_gains``,
``effective_reward`` (``:59``), ``update_lagrange`` (``:65``) for the
unweighted batch mean (the weighted form is PPO's, ROADMAP queue A item
10), ``N_COSTS`` and ``default_constraints``.  The update is plain torch on
four-element tensors; it runs on the card inside the SAC update with no
host read.  The batch mean sums by :func:`tree_sum_last` (XLA's reduction
order is its own, so lambda agrees with the JAX package's to the ulps
``tests/test_torch_rl_learn_ops.py`` states).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops.physics import tree_sum_last

#: fixed cost layout: [latency_p99_ms, power_W, gpu_over, energy_total_J]
N_COSTS = 4


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Static constraint description: name, target and PID gains."""

    name: str
    target: float
    kp: float = 0.05
    ki: float = 0.01
    kd: float = 0.0
    lambda_max: float = 10.0


@dataclasses.dataclass
class CMDPState:
    """Per-constraint multipliers and PID memories ([n_costs] float32)."""

    lam: torch.Tensor
    integral: torch.Tensor
    prev_err: torch.Tensor


def cmdp_init(constraints: Sequence[ConstraintSpec], device="cuda") -> CMDPState:
    """Zero multipliers and PID memories on ``device`` (the card unless the
    caller asks for the CPU; raises without a GPU)."""
    device = resolve_device(device)

    def z():
        return torch.zeros(len(constraints), dtype=torch.float32, device=device)

    return CMDPState(lam=z(), integral=z(), prev_err=z())


def _gains(constraints: Sequence[ConstraintSpec], device="cuda"):
    """(target, kp, ki, kd, lambda_max) as float32 [n_costs] tensors on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def col(name):
        return torch.tensor([getattr(c, name) for c in constraints],
                            dtype=torch.float32, device=device)

    return (col("target"), col("kp"), col("ki"), col("kd"),
            col("lambda_max"))


def effective_reward(r, costs, lam, targets):
    """r_eff[b] = r[b] - sum_i lam[i] * max(0, costs[b, i] - target[i]),
    the sum over i by the fixed tree (B5b's target kernel computes it the
    same way)."""
    viol = torch.clamp_min(costs - targets[None, :], 0.0)
    return r - tree_sum_last(lam[None, :] * viol)


def update_lagrange(cmdp: CMDPState, gains, costs) -> Tuple[CMDPState, torch.Tensor]:
    """PID step on the batch-mean violation; returns (new state, mean
    violation [n_costs]).  ``gains`` is :func:`_gains` of the constraints
    (built once).  The new state's tensors are fresh (the old are kept)."""
    tgt, kp, ki, kd, lmax = gains
    viol = torch.clamp_min(costs - tgt[None, :], 0.0)
    n = torch.full((), float(costs.shape[0]), dtype=torch.float32,
                   device=costs.device)
    err = tree_sum_last(viol.t()) / n
    integral = cmdp.integral + err
    deriv = err - cmdp.prev_err
    lam = torch.minimum(torch.clamp_min(kp * err + ki * integral + kd * deriv,
                                        0.0), lmax)
    return CMDPState(lam=lam, integral=integral, prev_err=err), err


def default_constraints(sla_p99_ms: float = 500.0,
                        power_cap: Optional[float] = None,
                        energy_budget_j: Optional[float] = None,
                        ) -> Tuple[ConstraintSpec, ...]:
    """The reference CLI's constraint set, in the cost layout's order; an
    optional constraint keeps its slot with an effectively infinite target."""
    big = 1e30
    return (
        ConstraintSpec("latency_p99", sla_p99_ms),
        ConstraintSpec("power", power_cap if power_cap and power_cap > 0 else big),
        ConstraintSpec("gpu_over", 0.0),
        ConstraintSpec("energy_total", energy_budget_j if energy_budget_j else big),
    )


def constraints_from_params(params) -> Tuple[ConstraintSpec, ...]:
    """The constraint set of a SimParams: the CMDP power target is
    ``power_cap_constraint`` when set, else ``power_cap``."""
    pcc = getattr(params, "power_cap_constraint", None)
    if pcc is None and params.power_cap > 0:
        pcc = params.power_cap
    return default_constraints(params.sla_p99_ms,
                               pcc if pcc and pcc > 0 else None,
                               params.energy_budget_j)
