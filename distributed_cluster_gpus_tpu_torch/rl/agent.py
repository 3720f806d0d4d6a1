"""CHSAC-AF facade: policy, replay ingest, the warm-up gate and the updates.

Counterpart of ``distributed_cluster_gpus_tpu/rl/agent.py``'s ``CHSAC_AF``.
It holds the learned state (``rl/sac.py``), the replay ring (``rl/
replay.py``) on the agent's device and the static ``SACConfig``; the engine
acts through ``policy_apply`` with ``sac`` as its parameters, and
:meth:`CHSAC_AF.train_steps` runs a chunk's updates (``sac_train_step``)
with the JAX package's key chain, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops import prng
from .cmdp import N_COSTS, default_constraints
from .replay import ReplayState, replay_add_chunk, replay_init
from .sac import (SACConfig, SACState, make_policy_apply, sac_init,
                  sac_train_step)

#: the agent's key chain is decorrelated from the simulation's (which also
#: starts from key(seed)) by this fold, as in the JAX package
AGENT_FOLD = 0x7A31


class CHSAC_AF:
    """Constrained hybrid-action SAC with action-feasibility masks."""

    def __init__(self, obs_dim: int, n_dc: int, n_g_choices: int,
                 sla_p99_ms: float = 500.0,
                 power_cap: Optional[float] = None,
                 energy_budget_j: Optional[float] = None,
                 buffer_capacity: int = 200_000,
                 batch: int = 256,
                 warmup: int = 1_000,
                 seed: int = 0,
                 constraints=None,
                 critic_arch: str = "onehot",
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = SACConfig(
            obs_dim=obs_dim, n_dc=n_dc, n_g=n_g_choices, batch=batch,
            constraints=(constraints if constraints is not None else
                         default_constraints(sla_p99_ms, power_cap,
                                             energy_budget_j)),
            critic_arch=critic_arch)
        self.warmup = warmup
        # the agent's threefry chain (the JAX package's derivation); the
        # weights come from a torch generator seeded from the same seed
        ks = prng.split(prng.fold_in(prng.key(seed, "cpu"), AGENT_FOLD), 2)
        self.key = ks[0].clone()
        gen = torch.Generator().manual_seed((int(seed) ^ AGENT_FOLD) & (2**63 - 1))
        self.sac: SACState = sac_init(self.cfg, gen, self.device)
        self.replay = replay_init(
            buffer_capacity, obs_dim, n_dc, n_g_choices, N_COSTS, self.device)
        self.policy_apply = make_policy_apply(self.cfg)

    @property
    def replay(self) -> ReplayState:
        return self._replay

    @replay.setter
    def replay(self, rb: ReplayState) -> None:
        self._replay = rb
        self._warm = None  # read the gate again

    def ingest_chunk(self, rl_emissions: Dict[str, torch.Tensor]) -> None:
        """Write one chunk's RL transition stream into the replay ring (the
        B6a kernel on the card, one launch per window; no host read inside
        it), then read the warm-up gate once for the chunk's updates."""
        replay_add_chunk(self.replay, rl_emissions)
        self._warm = self.ready

    @property
    def ready(self) -> bool:
        """Warmed up: ``n_seen`` (monotone, unlike ``size``) reached the
        warm-up count.  One host read."""
        return int(self.replay.n_seen) >= self.warmup

    def train_steps(self, n_train: int, max_steps: int = 256,
                    plain: bool = False,
                    ) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        """Up to ``min(n_train, max_steps)`` SAC updates once warmed up;
        returns (metrics of the last update or None, updates executed).
        The key chain is the JAX package's: ``self.key, k = split(key)``,
        ``keys = split(k, max_steps)``, update i samples with
        ``split(keys[i])[0]``, whatever the number of updates run.  The gate
        is the one :meth:`ingest_chunk` read (the replay does not change
        here), so nothing is read back from the card; the metrics stay on
        it.  ``plain`` runs the kernels' plain versions."""
        ks = prng.split(self.key, 2)
        self.key, k = ks[0].clone(), ks[1]
        warm = self._warm if self._warm is not None else self.ready
        n_done = min(n_train, max_steps) if warm and n_train > 0 else 0
        if n_done == 0:
            return None, 0
        keys = prng.split(k, max_steps)
        metrics = None
        for i in range(n_done):
            metrics = sac_train_step(self.cfg, self.sac, self.replay, keys[i],
                                     plain=plain)
        return metrics, n_done
