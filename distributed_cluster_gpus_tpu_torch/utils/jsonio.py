"""Strict-JSON artifact writing.

Counterpart of ``distributed_cluster_gpus_tpu/utils/jsonio.py`` (a copy: the
port imports nothing of the JAX package).  ``json.dump`` emits bare
``NaN``/``Infinity`` tokens for non-finite floats, which strict JSON readers
refuse; every artifact writer goes through :func:`clean_nan` (non-finite ->
null), so a NaN p99 from a short run never corrupts a downstream reader.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any


def clean_nan(obj: Any) -> Any:
    """Recursively replace non-finite floats with None (JSON null)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: clean_nan(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [clean_nan(v) for v in obj]
    return obj


def dump_json_atomic(path: str, obj: Any, **kwargs) -> None:
    """Strict-JSON atomic write: clean NaNs, write ``path.tmp``, rename.

    ``kwargs`` pass through to ``json.dump`` (default indent=2,
    default=float)."""
    kwargs.setdefault("indent", 2)
    kwargs.setdefault("default", float)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(clean_nan(obj), f, **kwargs)
    os.replace(tmp, path)
