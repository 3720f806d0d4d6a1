"""The CHSAC-AF networks: encoder, actor and the twin quantile critics.

Counterpart of ``distributed_cluster_gpus_tpu/rl/nets.py``'s
``MLPStateEncoder``, ``HybridActor``, ``QuantileCritic`` (with
``all_actions``) and ``QuantileCriticHeads`` (``:26``, ``:42``, ``:70``,
``:115``), 256 wide as published.  Each network has two forwards of the
same float32 parameters: the acting recipe below, which the B4 device code
repeats bit for bit, and the training forward (:func:`mm_dense`), which the
SAC update differentiates.

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

The training forward cannot use that recipe: the one-hot critic's
``all_actions`` runs B x n_dc x n_g = 16,384 rows at the published shape,
and the recipe's product tensor would be [16,384, 512, 256] float32.  It is
instead what flax's bf16 ``Dense`` is: bf16 operands, ``torch.matmul`` with
float32 accumulation and one rounding of the sum to bf16, then the bf16
bias added (in float32, rounded to bf16); its backward is autograd's.  The
float32 accumulation is pinned: cuBLAS may otherwise reduce a split-K
product's partial sums in bf16
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
on by default), so :func:`pin_f32_accumulation` turns that off and
``rl/sac.py::sac_train_step`` calls it before every update.  The two
forwards of the same weights therefore agree to a bf16 rounding of a
layer's output, not bitwise: the matmul sums in cuBLAS's (or the CPU
BLAS's) order, the recipe by its tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import prng
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


def pin_f32_accumulation() -> None:
    """Make cuBLAS accumulate bf16 products (split-K partials included) in
    float32, as flax's bf16 ``Dense`` does."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def mm_dense(x, kernel, bias):
    """One bf16 ``Dense`` for training: ``x`` [..., K] bf16 times ``kernel``
    [K, N] bf16 by ``torch.matmul`` (float32 accumulation, the sum rounded
    once to bf16), plus the bf16 ``bias`` [N] (added in float32 and rounded,
    as torch's bf16 add does); differentiable."""
    return torch.matmul(x, kernel) + bias


def masked_log_softmax(logits, mask):
    """float32 log-probabilities with the infeasible logits at -1e9 (the
    exponential sum by the fixed tree; the max is held constant under
    differentiation, as flax's ``log_softmax`` stops its gradient)."""
    x = torch.where(mask, logits, torch.full_like(logits, NEG_MASK))
    m = x.max(dim=-1, keepdim=True).values.detach()
    sh = x - m
    lse = torch.log(tree_sum_last(torch.exp(sh)))
    return sh - lse[..., None]


class Dense(nn.Module):
    """float32 params with flax's names and layout: ``kernel [in, out]``."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def reset(self, key: torch.Tensor) -> None:
        """flax's default init from this Dense's ``kernel`` key (int64 [2],
        :func:`init_modules` derives it; drawn on the key's device):
        ``lecun_normal``, i.e.
        ``variance_scaling(1, "fan_in", "truncated_normal")`` =
        ``truncated_normal(-2, 2) * sqrt(1 / fan_in) / 0.8796...`` in
        float32, and a zero bias."""
        f32 = torch.float32
        fan_in = self.kernel.shape[0]
        std = torch.sqrt(torch.tensor(1.0 / fan_in, dtype=f32)) / torch.tensor(
            0.87962566103423978, dtype=f32)
        w = prng.truncated_normal(key, -2.0, 2.0, self.kernel.shape) * std.to(
            key.device)
        with torch.no_grad():
            self.kernel.copy_(w)
            self.bias.zero_()

    def forward(self, x):
        return bf16_dense(x, self.kernel.to(BF16), self.bias.to(BF16))

    def mm(self, x):
        """The training forward of this layer (:func:`mm_dense`)."""
        return mm_dense(x, self.kernel.to(BF16), self.bias.to(BF16))


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

    def train_forward(self, obs):
        x = obs.to(BF16)
        for layer in self.layers:
            x = torch.relu(layer.mm(x))
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

    def train_forward(self, latent, mask_dc, mask_g):
        x = torch.relu(self.hidden.mm(latent.to(BF16)))
        logit_dc = self.head_dc.mm(x).to(torch.float32)
        logit_g = self.head_g.mm(x).to(torch.float32)
        return (masked_log_softmax(logit_dc, mask_dc),
                masked_log_softmax(logit_g, mask_g))


def _mlp(layers, x):
    """bf16 ReLU MLP by the training forward; the last layer's output in
    float32 (flax's ``.astype(jnp.float32)``)."""
    for layer in layers[:-1]:
        x = torch.relu(layer.mm(x))
    return layers[-1].mm(x).to(torch.float32)


class QuantileCritic(nn.Module):
    """Twin quantile critics on (latent, onehot(a_dc), onehot(a_g)):
    [B, 2, n_quantiles].  Flax's compact names: twin 0 is ``Dense_0..2``,
    twin 1 ``Dense_3..5`` (``layers`` in that order).  Training forward only."""

    def __init__(self, latent: int, n_dc: int, n_g: int, n_quantiles: int = 32,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.n_dc, self.n_g, self.n_quantiles = n_dc, n_g, n_quantiles
        widths = [latent + n_dc + n_g, *hidden, n_quantiles]
        self.layers = nn.ModuleList(
            Dense(a, b) for _ in range(2)
            for a, b in zip(widths[:-1], widths[1:]))

    def twins(self):
        k = len(self.layers) // 2
        return [list(self.layers[:k]), list(self.layers[k:])]

    def forward(self, latent, a_dc, a_g):
        eye_dc = torch.eye(self.n_dc, dtype=torch.float32, device=latent.device)
        eye_g = torch.eye(self.n_g, dtype=torch.float32, device=latent.device)
        x0 = torch.cat([latent, eye_dc[a_dc.long()], eye_g[a_g.long()]],
                       dim=-1).to(BF16)
        return torch.stack([_mlp(t, x0) for t in self.twins()], dim=1)

    def all_actions(self, latent):
        """Quantiles of every joint action a = a_dc * n_g + a_g, in the JAX
        package's layout [B, 2, A, N] as a strided view of the [B, A, 2, N]
        product (the marginalization kernel takes either)."""
        B, A = latent.shape[0], self.n_dc * self.n_g
        acts = torch.arange(A, device=latent.device)
        q = self(latent.repeat_interleave(A, dim=0),
                 (acts // self.n_g).repeat(B), (acts % self.n_g).repeat(B))
        return q.reshape(B, A, 2, -1).permute(0, 2, 1, 3)


class QuantileCriticHeads(nn.Module):
    """Twin quantile critics with per-joint-action output heads: latent ->
    MLP -> Dense(n_dc * n_g * n_quantiles) per twin (``critic_arch =
    "heads"``).  Flax's setup names ``twins_i_j`` map to ``layers`` in the
    order twin 0 layers 0..2, twin 1 layers 0..2.  Training forward only."""

    def __init__(self, latent: int, n_dc: int, n_g: int, n_quantiles: int = 32,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.n_dc, self.n_g, self.n_quantiles = n_dc, n_g, n_quantiles
        widths = [latent, *hidden, n_dc * n_g * n_quantiles]
        self.layers = nn.ModuleList(
            Dense(a, b) for _ in range(2)
            for a, b in zip(widths[:-1], widths[1:]))

    def twins(self):
        k = len(self.layers) // 2
        return [list(self.layers[:k]), list(self.layers[k:])]

    def all_actions(self, latent):
        """[B, 2, A, N]: one forward per twin."""
        B, A = latent.shape[0], self.n_dc * self.n_g
        x = latent.to(BF16)
        return torch.stack([_mlp(t, x).reshape(B, A, self.n_quantiles)
                            for t in self.twins()], dim=1)

    def forward(self, latent, a_dc, a_g):
        """Taken-action quantiles [B, 2, N], gathered from the heads."""
        q = self.all_actions(latent)
        idx = (a_dc.long() * self.n_g + a_g.long())[:, None, None, None]
        return torch.gather(q, 2, idx.expand(q.shape[0], 2, 1, q.shape[-1]))[:, :, 0]


def dense_layers(module) -> list:
    """``module``'s Dense layers in the port's order."""
    return module.layers() if isinstance(module, HybridActor) else list(
        module.layers)


def flax_names(module) -> list:
    """flax's names of ``module``'s Dense layers, in the order of
    :func:`dense_layers`: ``Dense_k`` in ``nn.compact`` order (the encoder;
    the actor's hidden layer and its two heads; the one-hot critic's twin 0,
    then twin 1), ``twins_i_j`` for the heads critic's ``setup`` list."""
    if isinstance(module, QuantileCriticHeads):
        return [f"twins_{t}_{j}" for t in range(2) for j in range(3)]
    return [f"Dense_{k}" for k in range(len(dense_layers(module)))]


def init_modules(modules, keys) -> None:
    """flax's default init of every Dense of each module from that module's
    ``init`` key (``keys``, int64 [2] each): the kernel of the Dense named
    ``name`` draws from ``fold_in_static(key, (name, 1))``, the key flax's
    ``LazyRng`` gives the Dense's first ``make_rng("params")`` (its kernel;
    the bias takes the second and ignores it)."""
    for mod, key in zip(modules, keys):
        for name, layer in zip(flax_names(mod), dense_layers(mod)):
            layer.reset(prng.fold_in_static(key, (name, 1)))
