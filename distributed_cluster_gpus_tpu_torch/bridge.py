"""Carry a fleet and a simulation state between the JAX package and the port.

This system's "weights" are its world (``FleetSpec``) and its state
(``SimState``).  Both packages hold them as trees of arrays with the same
field names, so the bridge works on nested dicts of numpy arrays: the JAX
side is turned into numpy by the caller (``tree_to_numpy`` with a leaf
function that unwraps PRNG keys), the port side by :func:`state_to_numpy`.
Fields the port does not carry yet (RL traces, bandit, fault, telemetry and
signal sub-states) are ignored on the way in and absent on the way out.

PRNG keys travel as their two uint32 threefry words; the port holds them in
int64 tensors (``ops/prng.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from .models.structs import (DCArrays, FleetSpec, JobSlab, LatWindow,
                             QueueRings, SimState)
from .ops.physics import LatencyCoeffs, PowerCoeffs

_KEY_FIELDS = ("key", "arr_key")


def tree_to_numpy(obj, leaf: Callable = np.asarray):
    """A dataclass tree (either package's state) as nested dicts of numpy
    arrays; ``None`` members are dropped, ``leaf`` converts each array."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is not None:
                out[f.name] = tree_to_numpy(v, leaf)
        return out
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {k: tree_to_numpy(v, leaf) for k, v in zip(obj._fields, obj)}
    return leaf(obj)


def _tensor_leaf(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def state_to_numpy(state: SimState) -> Dict:
    """The port's state as nested dicts of numpy (keys as uint32 words)."""
    tree = tree_to_numpy(state, _tensor_leaf)
    for k in _KEY_FIELDS:
        tree[k] = tree[k].astype(np.uint32)
    return tree


def _build(cls, tree, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = tree[f.name]
        kw[f.name] = torch.tensor(np.array(v), device=device)
    return cls(**kw)


def state_from_numpy(tree: Dict, device="cpu") -> SimState:
    """A port SimState on ``device`` from nested dicts of numpy arrays."""
    nested = {"dc": DCArrays, "jobs": JobSlab, "lat": LatWindow,
              "queues": QueueRings}
    kw = {}
    for f in dataclasses.fields(SimState):
        v = tree[f.name]
        if f.name in nested:
            kw[f.name] = _build(nested[f.name], v, device)
        elif f.name in _KEY_FIELDS:
            kw[f.name] = torch.tensor(np.asarray(v, np.uint32).astype(np.int64),
                                      device=device)
        else:
            kw[f.name] = torch.tensor(np.array(v), device=device)
    return SimState(**kw)


def fleet_from_numpy(src) -> FleetSpec:
    """A port FleetSpec from the JAX package's FleetSpec (or any object or
    dict with the same members, arrays as numpy)."""
    get = (src.__getitem__ if isinstance(src, dict)
           else lambda name: getattr(src, name))
    kw = {}
    for f in dataclasses.fields(FleetSpec):
        v = get(f.name)
        if f.name == "power":
            v = PowerCoeffs(*(np.asarray(a) for a in v))
        elif f.name == "latency":
            v = LatencyCoeffs(*(np.asarray(a) for a in v))
        elif isinstance(v, (tuple, int, str)):
            v = v
        else:
            v = np.asarray(v)
        kw[f.name] = v
    return FleetSpec(**kw)


def tree_mismatches(a: Dict, b: Dict, path: str = "") -> List[str]:
    """Paths of leaves that differ BITWISE between two nested-dict trees
    (dtype, shape and every bit; keys present in either tree count).
    Modelled on the JAX package's test comparator, but stricter: -0.0 and
    +0.0 differ here."""
    bad = []
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)):
            return [path or "."]
        for k in sorted(set(a) | set(b)):
            p = f"{path}.{k}" if path else k
            if k not in a or k not in b:
                bad.append(p)
            else:
                bad.extend(tree_mismatches(a[k], b[k], p))
        return bad
    x, y = np.asarray(a), np.asarray(b)
    if x.dtype != y.dtype or x.shape != y.shape:
        return [f"{path} ({x.dtype}{list(x.shape)} vs {y.dtype}{list(y.shape)})"]
    if x.tobytes() != y.tobytes():
        return [path]
    return bad
