"""The CHSAC-AF policy networks, forward only, with a fixed bf16 recipe.

Counterpart of ``distributed_cluster_gpus_tpu/rl/nets.py``'s
``MLPStateEncoder`` and ``HybridActor`` (``:26``, ``:42``), 256 wide as
published.  The critics are ROADMAP queue B item B5 (the learning half).

Parameters are float32 with flax's layout and names (``kernel [in, out]``,
``bias [out]``), so ``bridge.sac_from_flax`` carries the JAX package's
weights across unchanged.  The forward follows one recipe, which the B4
device code in ``csrc/event_scan.cu`` repeats op for op so that the two
agree bit for bit on the card:

* operands in bfloat16, rounded to nearest even from the float32 params
  (``astype``);
* every product of two bf16 values exact in float32;
* each output's K products summed in float32 by :func:`tree_sum_last`
  (zero-padded to a power of two; element i + element i + p/2 per level);
* the sum rounded to bf16, then the bf16 bias added (in float32, rounded to
  bf16) and the ReLU applied, as flax's bf16 ``Dense`` does;
* the heads' logits masked at -1e9 and passed through a log-softmax whose
  sum of exponentials is the same fixed tree.

XLA's CPU dot accumulates in another order, so against the JAX package the
log-probabilities agree within a bf16 rounding of a layer's output (the
tolerance ``tests/test_torch_rl_policy.py`` states), not bitwise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.physics import tree_sum_last

BF16 = torch.bfloat16
NEG_MASK = -1e9


def bf16_dense(x, kernel, bias):
    """One bf16 ``Dense`` by the recipe: ``x`` [..., K] bf16, ``kernel``
    [K, N] and ``bias`` [N] bf16; returns the pre-activation [..., N] bf16."""
    prod = x.to(torch.float32)[..., :, None] * kernel.to(torch.float32)
    acc = tree_sum_last(prod.transpose(-1, -2))  # [..., N]
    y = acc.to(BF16)
    return (y.to(torch.float32) + bias.to(torch.float32)).to(BF16)


def relu(x):
    return torch.where(x > 0, x, torch.zeros_like(x))


def masked_log_softmax(logits, mask):
    """float32 log-probabilities with the infeasible logits at -1e9 (the
    exponential sum by the fixed tree)."""
    x = torch.where(mask, logits, torch.full_like(logits, NEG_MASK))
    m = x.max(dim=-1, keepdim=True).values
    sh = x - m
    lse = torch.log(tree_sum_last(torch.exp(sh)))
    return sh - lse[..., None]


class Dense(nn.Module):
    """float32 params with flax's names and layout: ``kernel [in, out]``."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def reset(self, gen: torch.Generator) -> None:
        """flax's default init: lecun_normal (a normal truncated at two
        standard deviations, variance 1/fan_in) and a zero bias."""
        fan_in = self.kernel.shape[0]
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            self.bias.zero_()

    def forward(self, x):
        return bf16_dense(x, self.kernel.to(BF16), self.bias.to(BF16))


class MLPStateEncoder(nn.Module):
    """obs [B, obs_dim] -> latent [B, latent] float32; 3-layer ReLU MLP."""

    def __init__(self, obs_dim: int, latent: int = 256,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        widths = [obs_dim, *hidden, latent]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in
                                    zip(widths[:-1], widths[1:]))

    def forward(self, obs):
        x = obs.to(BF16)
        for layer in self.layers:
            x = relu(layer(x))
        return x.to(torch.float32)


class HybridActor(nn.Module):
    """latent -> masked log-probabilities of the two discrete heads
    (destination DC, GPU count g where n = g + 1)."""

    def __init__(self, latent: int, n_dc: int, n_g: int, hidden: int = 256):
        super().__init__()
        self.hidden = Dense(latent, hidden)
        self.head_dc = Dense(hidden, n_dc)
        self.head_g = Dense(hidden, n_g)

    def layers(self):
        return [self.hidden, self.head_dc, self.head_g]

    def forward(self, latent, mask_dc, mask_g):
        x = relu(self.hidden(latent.to(BF16)))
        logit_dc = self.head_dc(x).to(torch.float32)
        logit_g = self.head_g(x).to(torch.float32)
        return (masked_log_softmax(logit_dc, mask_dc),
                masked_log_softmax(logit_g, mask_g))


def init_modules(modules, gen: Optional[torch.Generator]) -> None:
    """flax's default init for every Dense of ``modules``, in order."""
    for mod in modules:
        for sub in mod.modules():
            if isinstance(sub, Dense):
                sub.reset(gen)
