"""The CHSAC-AF networks: encoder, actor and the twin quantile critics.

Counterpart of ``distributed_cluster_gpus_tpu/rl/nets.py``'s
``MLPStateEncoder``, ``HybridActor``, ``QuantileCritic`` (with
``all_actions``) and ``QuantileCriticHeads`` (``:26``, ``:42``, ``:70``,
``:115``), 256 wide as published.  Each network has two forwards of the
same float32 parameters: the acting recipe below, which the B4 device code
repeats bit for bit, and the training forward (:func:`dense_forward`) with
its gradient, which the SAC update runs.

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
instead what flax's bf16 ``Dense`` is: bf16 operands, a product with
float32 accumulation and one rounding of the sum to bf16, then the bf16
bias added (in float32, rounded to bf16), the ReLU, and a network's last
layer widened to float32 (:func:`dense_forward`): on the card one B5d
kernel (tensor cores), in the plain version ``torch.matmul``.  The plain
version's float32 accumulation is pinned: cuBLAS may otherwise reduce a
split-K product's partial sums in bf16
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``, on
by default), so :func:`pin_f32_accumulation` turns that off and
``rl/sac.py::sac_train_step`` calls it before every update.  The two
forwards of the same weights therefore agree to a bf16 rounding of a
layer's output, not bitwise: the products sum in the tensor cores' (or
the CPU BLAS's) order, the recipe by its tree.

The training forward's gradient is written out by hand, not left to
autograd (:func:`dense_grads`, the modules' ``train_backward``): each
layer's bf16 gradient is masked by its ReLU, its bias gradient summed over
the rows by the fixed tree, its kernel gradient a bf16 ``torch.matmul``
into the group's bf16 staging buffer.  The update's fused regions run as
hand-written kernels on the card, each with its plain version here: B5d
each layer's product with its epilogue, and a hidden layer's dX product
with its mask and bias gradient (``kernels/dense.py``); B5e, the one-hot
critic's input rows, built inside the critic's first layer
(``dense.critic_first_fwd``); B5f's forward, the masked log-softmax of
both heads, in the epilogue of their one product
(``dense.actor_heads_fwd``), and its backward with the heads' own (the
bf16 cast and the bias gradients) in one launch
(``kernels/log_softmax.py::heads_backward``).
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


def masked_log_softmax(logits, mask):
    """float32 log-probabilities with the infeasible logits at -1e9 (the
    exponential sum by the fixed tree; the max is held constant under
    differentiation, as flax's ``log_softmax`` stops its gradient): the
    acting recipe's, and the plain version of B5f's forward in
    :func:`actor_heads_plain`."""
    x = torch.where(mask, logits, torch.full_like(logits, NEG_MASK))
    m = x.max(dim=-1, keepdim=True).values.detach()
    sh = x - m
    lse = torch.log(tree_sum_last(torch.exp(sh)))
    return sh - lse[..., None]


def masked_log_softmax_backward(logits, mask, g):
    """B5f backward's plain version: dL/dlogits of :func:`masked_log_softmax`
    from ``g`` = dL/dlogp, ``g + ((-T) / S) * exp(x - m)`` where ``mask``
    and 0 elsewhere, with T the tree's sum of g and S the forward's sum of
    exponentials (the max held constant)."""
    x = torch.where(mask, logits, torch.full_like(logits, NEG_MASK))
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    d_s = -tree_sum_last(g) / tree_sum_last(e)
    return torch.where(mask, g + d_s[..., None] * e, torch.zeros_like(g))


# ---------------------------------------------------------------------------
# The training forward and its gradient.  A layer is a bf16 product (float32
# accumulation) with its epilogue, one B5d kernel on the card
# (``kernels/dense.py::dense_fwd``); its gradient G the B5d backward, and
# dW = x^T G a bf16 ``torch.matmul`` into the group's staging buffer.  A top
# layer's G comes from its float32 (or bf16) incoming gradient
# (``dense_backward``); a hidden layer's from the layer above's G and
# kernel, whose product dX the kernel forms itself (``dense_dx``), so an
# incoming gradient is passed down as a tensor or as such a pair.  The
# weights ``w`` are a list of (kernel, bias) bf16 pairs, one per Dense
# layer: the state's shadows in an update (``rl/sac.py``), fresh casts of
# the float32 parameters otherwise (:func:`casts`); ``dw`` the matching
# (kernel, bias) views of the staging buffer.  ``plain`` runs the plain
# versions below in place of the kernels.
# ---------------------------------------------------------------------------

def dense_epilogue(y, bias, use_relu: bool, out32=None):
    """B5d forward's epilogue, in place on the product ``y`` (bf16 [R, N]):
    the bf16 ``bias`` added in float32 and rounded to bf16 (torch's bf16
    add), the ReLU where ``use_relu``, the float32 copy into ``out32`` where
    given (flax's ``.astype``)."""
    v = (y.to(torch.float32) + bias.to(torch.float32)).to(BF16)
    y.copy_(relu(v) if use_relu else v)
    if out32 is not None:
        out32.copy_(y)
    return y


def dense_fwd_plain(x, kernel, bias, use_relu: bool, out32=None):
    """B5d forward's plain version (``kernels/dense.py::dense_fwd``): ``x``
    [R, K] bf16 times ``kernel`` [K, N] bf16 by ``torch.matmul`` (float32
    accumulation, the sum rounded once to bf16), then
    :func:`dense_epilogue`."""
    return dense_epilogue(torch.matmul(x, kernel), bias, use_relu, out32)


def dense_backward(g, y, db, g2=None):
    """B5d backward's plain version: G = bf16(g) (or bf16(g + g2), summed in
    float32), zero where the layer's output ``y`` is not positive (a ReLU
    layer; ``y`` None for none), and ``db`` (bf16 [N]) = the tree's sum of G
    over its rows, rounded to bf16.  Returns G."""
    G = g.to(BF16) if g2 is None else (
        g.to(torch.float32) + g2.to(torch.float32)).to(BF16)
    if y is not None:
        G = torch.where(y > 0, G, torch.zeros_like(G))
    db.copy_(tree_sum_last(G.to(torch.float32).t()).to(BF16))
    return G


def heads_backward_plain(l_dc, l_g, mask_dc, mask_g, g_dc, g_g, db_dc, db_g):
    """The plain version of ``kernels/log_softmax.py::heads_backward``: for
    each head the logits' gradient (:func:`masked_log_softmax_backward`)
    then its top layer's backward (:func:`dense_backward`, no ReLU: the
    bf16 cast and the bias gradient into ``db``); returns (G_dc, G_g)."""
    return tuple(dense_backward(masked_log_softmax_backward(l_, m, g), None, db)
                 for l_, m, g, db in ((l_dc, mask_dc, g_dc, db_dc),
                                      (l_g, mask_g, g_g, db_g)))


def dense_dx_plain(g, w, y, db, g2=None, w2=None):
    """B5d's fused dX backward, plain (``kernels/dense.py::dense_dx``): the
    products ``g w^T`` (and ``g2 w2^T``) by ``torch.matmul``, each rounded
    to bf16, then :func:`dense_backward` (their float32 sum, the mask, the
    bias gradient's tree)."""
    d2 = None if g2 is None else torch.matmul(g2, w2.t())
    return dense_backward(torch.matmul(g, w.t()), y, db, d2)


def dense_forward(x, kernel, bias, use_relu: bool, out32=None,
                  plain: bool = False):
    """One bf16 ``Dense`` for training, B5d's forward: returns the bf16
    output [R, N] (see :func:`dense_fwd_plain`)."""
    from ..kernels.dense import dense_fwd

    return dense_fwd(x, kernel, bias, use_relu, out32, plain=plain)


def dense_grads(x, y, g, dkernel, dbias, plain: bool = False):
    """One layer's gradient G from the incoming ``g``: a tensor dL/dout
    (B5d's ``dense_backward``), or (G', W') or (G', W', G2, W2), the layer
    above's gradients and kernels whose products form dL/dout inside B5d's
    ``dense_dx``.  Writes ``dbias`` and ``dkernel`` = x^T G; returns G.
    ``y`` is the layer's output for a ReLU layer, None otherwise."""
    from ..kernels.dense import dense_backward as backward
    from ..kernels.dense import dense_dx

    if isinstance(g, torch.Tensor):
        G = backward(g, y, dbias, plain=plain)
    else:
        G = dense_dx(g[0], g[1], y, dbias, *g[2:], plain=plain)
    torch.matmul(x.t(), G, out=dkernel)
    return G


def mlp_forward(x, w, last_relu: bool, out32=None, plain: bool = False):
    """A ReLU MLP by the training forward: [x, y_1, ..., y_L], each layer's
    bf16 input and the last one's output; the last layer has a ReLU where
    ``last_relu`` and writes its float32 copy into ``out32`` where given."""
    acts = [x]
    for i, (kernel, bias) in enumerate(w):
        last = i == len(w) - 1
        acts.append(dense_forward(acts[-1], kernel, bias, last_relu or not last,
                                  out32 if last else None, plain))
    return acts


def mlp_backward(acts, w, dw, g, last_relu: bool, plain: bool = False):
    """The gradient of :func:`mlp_forward`'s MLP from ``g`` = dL/d(output)
    (a tensor, or a pair as :func:`dense_grads` takes it): every layer's
    into ``dw``; each layer below the top forms its dX in its backward
    kernel, the input's is not formed."""
    for i in reversed(range(len(w))):
        act = last_relu or i < len(w) - 1
        G = dense_grads(acts[i], acts[i + 1] if act else None, g, *dw[i],
                        plain=plain)
        g = (G, w[i][0])


def casts(module) -> list:
    """``module``'s weights for the training forward: each Dense layer's
    (kernel, bias) rounded to bf16 (``astype``), in :func:`dense_layers`'s
    order."""
    return [(layer.kernel.detach().to(BF16), layer.bias.detach().to(BF16))
            for layer in dense_layers(module)]


def _twins(w):
    k = len(w) // 2
    return [w[:k], w[k:]]


def critic_input(lat, n_dc: int, n_g: int, a_dc=None, a_g=None):
    """B5e's plain version: the one-hot critic's bf16 input rows [rows, L +
    n_dc + n_g] from ``lat`` (float32 [B, L]), the JAX package's concat and
    cast: every joint action a = a_dc * n_g + a_g in row b * A + a
    (``a_dc``, ``a_g`` None), or the taken actions (int [B]) in row b."""
    B, dev = lat.shape[0], lat.device
    if a_dc is None:
        acts = torch.arange(n_dc * n_g, device=dev)
        a_dc, a_g = (acts // n_g).repeat(B), (acts % n_g).repeat(B)
        lat = lat.repeat_interleave(n_dc * n_g, dim=0)
    oh_dc = a_dc[:, None] == torch.arange(n_dc, device=dev)
    oh_g = a_g[:, None] == torch.arange(n_g, device=dev)
    return torch.cat([lat, oh_dc.to(torch.float32), oh_g.to(torch.float32)],
                     dim=-1).to(BF16)


def critic_first_plain(lat, n_dc: int, n_g: int, kernel, bias, a_dc=None,
                       a_g=None):
    """The plain version of ``kernels/dense.py::critic_first_fwd``: the
    one-hot critic's first layer (with its ReLU) on :func:`critic_input`'s
    rows; returns (y, the rows)."""
    x0 = critic_input(lat, n_dc, n_g, a_dc, a_g)
    return dense_fwd_plain(x0, kernel, bias, True), x0


def actor_heads_plain(x, k_dc, b_dc, k_g, b_g, mask_dc, mask_g):
    """The plain version of ``kernels/dense.py::actor_heads_fwd``: each
    head's float32 logits (:func:`dense_fwd_plain` without a ReLU) and
    their :func:`masked_log_softmax`; returns (logp_dc, logp_g, l_dc,
    l_g)."""
    logits = []
    for kernel, bias in ((k_dc, b_dc), (k_g, b_g)):
        out = torch.empty((x.shape[0], kernel.shape[1]), dtype=torch.float32,
                          device=x.device)
        dense_fwd_plain(x, kernel, bias, False, out)
        logits.append(out)
    return (masked_log_softmax(logits[0], mask_dc),
            masked_log_softmax(logits[1], mask_g), *logits)


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

    def train_forward(self, obs, w=None, plain: bool = False):
        """(latent float32 [B, latent], the layers' bf16 activations, the
        last being the bf16 latent) by the training forward."""
        w = w or casts(self)
        lat = torch.empty((obs.shape[0], w[-1][0].shape[1]),
                          dtype=torch.float32, device=obs.device)
        return lat, mlp_forward(obs.to(BF16), w, True, lat, plain)

    def train_backward(self, acts, g, w, dw, plain: bool = False):
        """Every layer's gradient into ``dw`` from ``g`` = dL/dlatent: a
        tensor, or the actor's (G, kernel) of :meth:`HybridActor.hidden_grad`
        whose product the top layer's backward kernel forms."""
        mlp_backward(acts, w, dw, g, True, plain=plain)


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

    def train_forward(self, lat16, mask_dc, mask_g, w=None,
                      plain: bool = False):
        """(logp_dc, logp_g, saved) by the training forward from the bf16
        latent ``lat16``; ``saved`` is what :meth:`train_backward` needs.
        Both heads and their masked log-softmax are one launch
        (``actor_heads_fwd``)."""
        from ..kernels.dense import actor_heads_fwd

        (k_h, b_h), (k_dc, b_dc), (k_g, b_g) = w or casts(self)
        hid = dense_forward(lat16, k_h, b_h, True, plain=plain)
        logp_dc, logp_g, l_dc, l_g = actor_heads_fwd(
            hid, k_dc, b_dc, k_g, b_g, mask_dc, mask_g, plain=plain)
        return logp_dc, logp_g, (lat16, hid, l_dc, l_g, mask_dc, mask_g)

    def train_backward(self, saved, d_dc, d_g, w, dw, plain: bool = False):
        """Every layer's gradient into ``dw`` from dL/dlogp of each head;
        returns dL/dlat16 (bf16)."""
        G, kernel = self.hidden_grad(saved, d_dc, d_g, w, dw, plain)
        return torch.matmul(G, kernel.t())

    def hidden_grad(self, saved, d_dc, d_g, w, dw, plain: bool = False):
        """Every layer's gradient into ``dw`` from dL/dlogp of each head;
        returns the hidden layer's (G, kernel), whose product is dL/dlat16
        (the encoder's top layer forms it in its backward kernel).  Both
        heads' gradients (the log-softmax's, the cast, the bias gradients)
        are one launch (``heads_backward``); the hidden layer's backward
        forms both heads' dX products and sums them."""
        from ..kernels.log_softmax import heads_backward

        lat16, hid, l_dc, l_g, mask_dc, mask_g = saved
        G_dc, G_g = heads_backward(l_dc, l_g, mask_dc, mask_g, d_dc, d_g,
                                   dw[1][1], dw[2][1], plain=plain)
        torch.matmul(hid.t(), G_dc, out=dw[1][0])
        torch.matmul(hid.t(), G_g, out=dw[2][0])
        G = dense_grads(lat16, hid, (G_dc, w[1][0], G_g, w[2][0]), *dw[0],
                        plain=plain)
        return G, w[0][0]


class QuantileCritic(nn.Module):
    """Twin quantile critics on (latent, onehot(a_dc), onehot(a_g)):
    [B, 2, n_quantiles].  Flax's compact names: twin 0 is ``Dense_0..2``,
    twin 1 ``Dense_3..5`` (``layers`` in that order).  Training forward only;
    each twin's first layer builds the input rows itself
    (``critic_first_fwd``)."""

    def __init__(self, latent: int, n_dc: int, n_g: int, n_quantiles: int = 32,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.n_dc, self.n_g, self.n_quantiles = n_dc, n_g, n_quantiles
        widths = [latent + n_dc + n_g, *hidden, n_quantiles]
        self.layers = nn.ModuleList(
            Dense(a, b) for _ in range(2)
            for a, b in zip(widths[:-1], widths[1:]))

    def _twins_forward(self, latent, w, plain, a_dc=None, a_g=None):
        """Both twins on the critic's rows of the float32 ``latent``: every
        joint action (``a_dc``, ``a_g`` None) or the taken actions (int32
        [B]).  Returns ([rows, 2, N] float32, the twins' activations, each
        led by the taken actions' rows, which twin 0's first layer writes,
        or None)."""
        from ..kernels.dense import critic_first_fwd

        A = self.n_dc * self.n_g if a_dc is None else 1
        q = torch.empty((latent.shape[0] * A, 2, self.n_quantiles),
                        dtype=torch.float32, device=latent.device)
        acts, x0 = [], None
        for t, tw in enumerate(_twins(w)):
            y1, rows = critic_first_fwd(latent, self.n_dc, self.n_g, *tw[0],
                                        a_dc, a_g, keep_rows=(
                                            t == 0 and a_dc is not None),
                                        plain=plain)
            x0 = rows if t == 0 else x0
            acts.append([x0, *mlp_forward(y1, tw[1:], False, q[:, t], plain)])
        return q, acts

    def train_forward(self, latent, a_dc, a_g, w=None, plain: bool = False):
        """(taken-action quantiles [B, 2, N], saved) from the float32
        ``latent``; ``saved`` is what :meth:`train_backward` needs."""
        return self._twins_forward(latent, w or casts(self), plain,
                                   a_dc.to(torch.int32), a_g.to(torch.int32))

    def train_backward(self, saved, dq, w, dw, plain: bool = False):
        """Every layer's gradient into ``dw`` from ``dq`` = dL/dq [B, 2, N]
        (float32)."""
        for t, (acts, tw, tdw) in enumerate(zip(saved, _twins(w), _twins(dw))):
            mlp_backward(acts, tw, tdw, dq[:, t], False, plain=plain)

    def forward(self, latent, a_dc, a_g):
        return self.train_forward(latent, a_dc, a_g)[0]

    def all_actions(self, latent, w=None, plain: bool = False):
        """Quantiles of every joint action a = a_dc * n_g + a_g, in the JAX
        package's layout [B, 2, A, N] as a strided view of the [B, A, 2, N]
        product (the marginalization kernel takes either)."""
        B, A = latent.shape[0], self.n_dc * self.n_g
        q, _ = self._twins_forward(latent, w or casts(self), plain)
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

    def _forward(self, latent, w, plain):
        """([B, 2, A, N] float32, the twins' activations): one forward per
        twin, each writing its half of the output.  ``latent`` float32, or
        the encoder's bf16 latent (the update's: no cast launched)."""
        B, A = latent.shape[0], self.n_dc * self.n_g
        q = torch.empty((B, 2, A * self.n_quantiles), dtype=torch.float32,
                        device=latent.device)
        x = latent.to(BF16)
        acts = [mlp_forward(x, tw, False, q[:, t], plain)
                for t, tw in enumerate(_twins(w))]
        return q.view(B, 2, A, self.n_quantiles), acts

    def all_actions(self, latent, w=None, plain: bool = False):
        """[B, 2, A, N]: one forward per twin."""
        return self._forward(latent, w or casts(self), plain)[0]

    def train_forward(self, latent, a_dc, a_g, w=None, plain: bool = False):
        """(every joint action's quantiles [B, 2, A, N], saved): the update
        takes the taken action's (a = a_dc * n_g + a_g) inside B5a, which
        also scatters its gradient back into this shape
        (``rl/sac.py::quantile_huber_loss``'s ``take``)."""
        return self._forward(latent, w or casts(self), plain)

    def train_backward(self, saved, dq, w, dw, plain: bool = False):
        """Every layer's gradient into ``dw`` from ``dq`` = dL/dq [B, 2, A,
        N] (float32, zero but at the taken action's head: B5a's)."""
        d = dq.reshape(dq.shape[0], 2, -1)
        for t, (a, tw, tdw) in enumerate(zip(saved, _twins(w), _twins(dw))):
            mlp_backward(a, tw, tdw, d[:, t], False, plain=plain)

    def forward(self, latent, a_dc, a_g):
        """Taken-action quantiles [B, 2, N], gathered from the heads."""
        q = self.all_actions(latent)
        idx = (a_dc.long() * self.n_g + a_g.long())[:, None, None, None]
        return torch.gather(q, 2, idx.expand(q.shape[0], 2, 1, q.shape[-1]))[
            :, :, 0]


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
