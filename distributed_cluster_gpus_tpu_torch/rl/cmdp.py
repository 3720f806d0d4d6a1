"""The CMDP cost layout and the CLI's constraint set (constants only).

Counterpart of ``distributed_cluster_gpus_tpu/rl/cmdp.py``'s ``N_COSTS``,
``ConstraintSpec`` and ``default_constraints``.  The PID
Lagrange update that consumes them belongs to the SAC update, ROADMAP queue
B item B5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: fixed cost layout: [latency_p99_ms, power_W, gpu_over, energy_total_J]
N_COSTS = 4


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Static constraint description: name and target (the PID gains come
    with the Lagrange update, ROADMAP B5)."""

    name: str
    target: float


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
