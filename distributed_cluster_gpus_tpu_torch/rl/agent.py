"""CHSAC-AF facade, acting side: policy, replay ingest and the warm-up gate.

Counterpart of ``distributed_cluster_gpus_tpu/rl/agent.py``'s ``CHSAC_AF``.
It holds the encoder/actor (``rl/sac.py``), the replay ring (``rl/
replay.py``) on the agent's device and the static ``SACConfig``; the engine
acts through ``policy_apply`` with ``sac`` as its parameters.  Updates are
the learning half, ROADMAP queue B item B5: :meth:`CHSAC_AF.train_steps`
raises ``NotImplementedError`` whenever an update falls due, and never skips
one silently.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops import prng
from .cmdp import N_COSTS, default_constraints
from .replay import ReplayState, replay_add_chunk, replay_init
from .sac import SACConfig, SACState, make_policy_apply, sac_init

#: the agent's key chain is decorrelated from the simulation's (which also
#: starts from key(seed)) by this fold, as in the JAX package
AGENT_FOLD = 0x7A31

B5_MESSAGE = ("SAC/CMDP updates are not ported yet (ROADMAP queue B item B5: "
              "sac_train_step, the critics and the Lagrange update); run with "
              "--rl-warmup above the run's transition count to act without "
              "learning")


class CHSAC_AF:
    """Constrained hybrid-action SAC with action-feasibility masks (acting)."""

    def __init__(self, obs_dim: int, n_dc: int, n_g_choices: int,
                 sla_p99_ms: float = 500.0,
                 power_cap: Optional[float] = None,
                 energy_budget_j: Optional[float] = None,
                 buffer_capacity: int = 200_000,
                 batch: int = 256,
                 warmup: int = 1_000,
                 seed: int = 0,
                 constraints=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = SACConfig(
            obs_dim=obs_dim, n_dc=n_dc, n_g=n_g_choices, batch=batch,
            constraints=(constraints if constraints is not None else
                         default_constraints(sla_p99_ms, power_cap,
                                             energy_budget_j)))
        self.warmup = warmup
        # the agent's threefry chain (the JAX package's derivation); the
        # weights come from a torch generator seeded from the same seed
        ks = prng.split(prng.fold_in(prng.key(seed, "cpu"), AGENT_FOLD), 2)
        self.key = ks[0].clone()
        gen = torch.Generator().manual_seed((int(seed) ^ AGENT_FOLD) & (2**63 - 1))
        self.sac: SACState = sac_init(self.cfg, gen, self.device)
        self.replay: ReplayState = replay_init(
            buffer_capacity, obs_dim, n_dc, n_g_choices, N_COSTS, self.device)
        self.policy_apply = make_policy_apply(self.cfg)

    def ingest_chunk(self, rl_emissions: Dict[str, torch.Tensor]) -> None:
        """Write one chunk's RL transition stream into the replay ring (the
        B6a kernel on the card, one launch per window; no host read)."""
        replay_add_chunk(self.replay, rl_emissions)

    @property
    def ready(self) -> bool:
        """Warmed up: ``n_seen`` (monotone, unlike ``size``) reached the
        warm-up count.  One host read."""
        return int(self.replay.n_seen) >= self.warmup

    def train_steps(self, n_train: int, max_steps: int = 256,
                    ) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        """Up to ``min(n_train, max_steps)`` SAC updates.  None fall due
        before warm-up or when ``n_train`` is 0: returns (None, 0).  Once one
        is due this raises, because the update is ROADMAP B5's."""
        self.key = prng.split(self.key, 2)[0].clone()
        if n_train > 0 and max_steps > 0 and self.ready:
            raise NotImplementedError(B5_MESSAGE)
        return None, 0
