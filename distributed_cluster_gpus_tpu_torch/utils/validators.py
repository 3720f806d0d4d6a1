"""Fleet configuration sanity checks: the CLI's start-up warnings.

Counterpart of ``distributed_cluster_gpus_tpu/utils/validators.py`` (a copy,
on the port's ``FleetSpec``): negative power values, sleep above idle,
alpha outside [1, 5], and TDP over- or under-shoot, with warn-or-raise
semantics.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..models.structs import FleetSpec


def validate_gpus(spec: FleetSpec, tdp: Optional[np.ndarray] = None,
                  strict: bool = False) -> List[str]:
    """Return a list of warnings; raise ValueError when strict and non-empty.

    ``tdp`` is an optional [n_dc] array of declared TDP/TBP Watts.
    """
    msgs: List[str] = []
    seen = set()
    for d, gpu in enumerate(spec.gpu_names):
        # repeated (model, TDP) pairs are checked once, but a DC whose own
        # declared TDP differs is checked on its own
        key = (gpu, None if tdp is None else float(tdp[d]))
        if key in seen:
            continue
        seen.add(key)
        prefix = f"[GPUType:{gpu}]"
        pi, pp, ps, al = (
            float(spec.p_idle[d]),
            float(spec.p_peak[d]),
            float(spec.p_sleep[d]),
            float(spec.gpu_alpha[d]),
        )
        if pi < 0 or pp < 0 or ps < 0:
            msgs.append(f"{prefix} negative power value (p_idle={pi}, p_peak={pp}, p_sleep={ps}).")
        if ps > pi + 1e-6:
            msgs.append(f"{prefix} p_sleep ({ps} W) > p_idle ({pi} W); check the config/measurements.")
        if not (1.0 <= al <= 5.0):
            msgs.append(f"{prefix} alpha={al} outside [1, 5]; should be fit from measured data.")
        if tdp is not None:
            total = pi + pp
            t = float(tdp[d])
            if total > t + 1e-6:
                msgs.append(
                    f"{prefix} p_idle + p_peak = {total:.1f} W > TDP {t:.1f} W. "
                    f"Set p_peak ~ (TDP - p_idle) for the baseline model."
                )
            if total < 0.5 * t:
                msgs.append(f"{prefix} p_idle + p_peak = {total:.1f} W << TDP {t:.1f} W (<=50%).")
    if strict and msgs:
        raise ValueError("GPU config validation failed:\n" + "\n".join(msgs))
    return msgs
