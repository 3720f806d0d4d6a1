"""Batched rollouts: R independent worlds stacked along a leading lane axis.

Counterpart of ``distributed_cluster_gpus_tpu/parallel/rollout.py``'s
``batched_init`` and ``replicated_init`` (the JAX package vmaps them; here
the lane axis is written out).  ``Engine.run_chunk`` advances every lane of
such a state in one launch of the B1 event-scan kernel on the card (one
block per lane) and builds every lane's arrival tables in one B2 launch; on
the CPU the plain engine runs lane by lane.  Each lane is bit for bit the
single-lane run of its key.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.structs import FleetSpec, SimParams, SimState, stack_states
from ..ops import prng
from ..device import resolve_device
from ..sim.engine import init_state
from ..workload.compiler import compile_workload

#: the fold constant of the batched key chain (the JAX package's)
ROLLOUT_FOLD = 0x5EED


def rollout_keys(seed: int, n_rollouts: int, device="cuda") -> torch.Tensor:
    """[R, 2] key words: lane 0 the un-split ``key(seed)`` (the stream a
    single-world run of the seed sees), lanes 1..R-1
    ``split(fold_in(key(seed), 0x5eed), R - 1)``."""
    dev = resolve_device(device)
    base = prng.key(seed, dev)
    if n_rollouts == 1:
        return base[None]
    rest = prng.split(prng.fold_in(base, ROLLOUT_FOLD), n_rollouts - 1)
    return torch.cat([base[None], rest])


def batched_init(fleet: FleetSpec, params: SimParams, n_rollouts: int,
                 seed: Optional[int] = None, workload=None,
                 device="cuda") -> SimState:
    """R independent states stacked along a leading lane axis.

    ``workload``: pass ``engine.workload`` when an Engine exists."""
    dev = resolve_device(device)
    if workload is None:
        workload = compile_workload(fleet, params, dev)
    keys = rollout_keys(params.seed if seed is None else seed, n_rollouts, dev)
    return stack_states([init_state(keys[r].clone(), fleet, params,
                                    workload=workload, device=dev)
                         for r in range(n_rollouts)])


def replicated_init(fleet: FleetSpec, params: SimParams, n: int,
                    seed: Optional[int] = None, workload=None,
                    device="cuda") -> SimState:
    """``n`` IDENTICAL states stacked along a leading lane axis: every lane
    starts from the same key, so only what the caller varies per lane can
    make the lanes' trajectories diverge."""
    dev = resolve_device(device)
    if workload is None:
        workload = compile_workload(fleet, params, dev)
    st = init_state(prng.key(params.seed if seed is None else seed, dev),
                    fleet, params, workload=workload, device=dev)
    return stack_states([st] * n)
