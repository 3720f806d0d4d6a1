"""CHSAC-AF acting: config, policy state, action selection.

Counterpart of ``distributed_cluster_gpus_tpu/rl/sac.py``'s ``SACConfig``
(``:38``), ``select_action`` (``:150``) and ``make_policy_apply`` (``:166``),
with an encoder/actor initialisation of flax's default kind drawn from an
explicit ``torch.Generator`` (the same distribution as the JAX package's
``sac_init``, not the same bits).  The update (``sac_train_step``), the
critics and the optimizers are ROADMAP queue B item B5.

On the card the engine does not call :func:`select_action`: the policy runs
inside the B1 kernel (``csrc/event_scan.cu``, the B4 device code) from the
bf16 weights :func:`policy_weights` lays out once per chunk.  The plain step
(``sim/step.py``) calls it through ``policy_apply``, which is how the kernel
is held bit for bit against its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import prng
from .cmdp import ConstraintSpec
from .nets import BF16, HybridActor, MLPStateEncoder, init_modules


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """The acting half's static config (the JAX package's defaults); the
    learning hyperparameters come with the update, ROADMAP B5."""

    obs_dim: int
    n_dc: int
    n_g: int
    latent: int = 256
    batch: int = 256
    constraints: Tuple[ConstraintSpec, ...] = ()

    def __post_init__(self):
        assert self.constraints, "SACConfig needs at least one ConstraintSpec"


@dataclasses.dataclass
class SACState:
    """The acting half of the learned state: encoder and actor (float32
    params), and the count of updates taken (0 until B5 lands)."""

    enc: MLPStateEncoder
    actor: HybridActor
    step: int = 0

    def layers(self):
        """The six Dense layers in the kernel's order: encoder 0-2, actor
        hidden, DC head, GPU-count head."""
        return [*self.enc.layers, *self.actor.layers()]


def sac_init(cfg: SACConfig, gen: torch.Generator, device="cpu") -> SACState:
    """Fresh encoder and actor, initialised from ``gen`` (a CPU generator)
    as flax initialises them: lecun-normal kernels, zero biases."""
    enc = MLPStateEncoder(cfg.obs_dim, latent=cfg.latent)
    actor = HybridActor(cfg.latent, cfg.n_dc, cfg.n_g)
    init_modules([enc, actor], gen)
    for m in (enc, actor):
        m.requires_grad_(False)
    return SACState(enc=enc.to(device), actor=actor.to(device))


@torch.no_grad()
def policy_logp(sac: SACState, obs, mask_dc, mask_g):
    """(logp_dc, logp_g) of a batch ``obs`` [B, obs_dim]."""
    return sac.actor(sac.enc(obs), mask_dc, mask_g)


@torch.no_grad()
def select_action(cfg: SACConfig, sac: SACState, obs, mask_dc, mask_g, key,
                  greedy: bool = False):
    """One masked categorical sample per head (int32 0-d tensors); ``obs``
    is unbatched [obs_dim], ``key`` the step's action key (int64 [2]): the
    DC head samples with ``split(key)[0]``, the GPU-count head with
    ``split(key)[1]``, as ``jax.random.categorical`` does with them."""
    logp_dc, logp_g = policy_logp(sac, obs[None], mask_dc[None], mask_g[None])
    if greedy:
        return (torch.argmax(logp_dc[0]).to(torch.int32),
                torch.argmax(logp_g[0]).to(torch.int32))
    k = prng.split(key, 2)
    a_dc = prng.categorical(k[0], logp_dc[0])
    a_g = prng.categorical(k[1], logp_g[0])
    return a_dc.to(torch.int32), a_g.to(torch.int32)


def make_policy_apply(cfg: SACConfig, greedy: bool = False):
    """The engine's ``policy_apply(sac, obs, mask_dc, mask_g, key)``.  The
    B1 kernel runs this same policy on the card (``kernel_mode``); any
    other callable runs only on the plain step."""

    def policy_apply(sac, obs, mask_dc, mask_g, key):
        return select_action(cfg, sac, obs, mask_dc, mask_g, key, greedy=greedy)

    policy_apply.kernel_mode = "greedy" if greedy else "sample"
    policy_apply.cfg = cfg
    return policy_apply


def policy_weights(sac: SACState, device):
    """The kernel's operands: for each of the six layers the kernel
    transposed to [out, in] and the bias, both rounded to bf16 (the
    recipe's ``astype``), contiguous on ``device``.  Built once per chunk:
    0.43 MB at the published widths."""
    out = []
    for layer in sac.layers():
        out.append(layer.kernel.detach().to(device).to(BF16).t().contiguous())
        out.append(layer.bias.detach().to(device).to(BF16).contiguous())
    return out
