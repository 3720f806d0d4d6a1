"""Clipped Adam and the Polyak target on flat parameter buffers (B5c's
plain version).

The port's own copy of what ``distributed_cluster_gpus_tpu/rl/sac.py``'s
``_tx`` (``:117``) takes from optax — ``chain(clip_by_global_norm(5.0),
adam(3e-4))`` — and of the Polyak target update (``:286-288``) and the
``alpha_max`` clamp (``:300-302``) that follow it in ``sac_train_step``.

Each optimizer group (critic, actor, encoder, log alpha) keeps its
parameters in ONE flat float32 buffer; the modules' ``nn.Parameter``s are
views of it (:func:`flatten_params`), so the update is one pass over one
buffer; the B5c kernel (``kernels/adam.py``) updates every group of an
update in two launches.  :func:`clip_adam_update` is the kernel's plain version and
follows optax's order step for step::

    g_norm = sqrt(sum g^2)                         (the blocked order below)
    g      = g if g_norm < max_norm else (g / g_norm) * max_norm
    mu     = (1 - b1) * g + b1 * mu
    nu     = (1 - b2) * (g * g) + b2 * nu
    count  = count + 1                             (saturating, int32)
    u      = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + 0) + eps)
    p      = p + u * (-lr)
    target = (1 - tau) * target + tau * p          (the critic's group)
    p      = min(p, clamp)                         (log alpha's group)
    shadow = bf16(p); target shadow = bf16(target) (the networks' groups)
    exp_out = exp(p)                               (log alpha's: the alpha metric)

A bf16 gradient (the networks' hand-written gradients are staged in bf16)
is widened to float32 first, exactly.  The shadows are B5g's casts of the
JAX package's update (flax's bf16 ``Dense`` rounds each parameter before
its product): written after the step, they are the casts of the
parameters the next update starts from.  Whatever writes a group's
parameters outside the update refreshes its shadow (``rl/sac.py``
``refresh_shadows``, B5g's kernel ``kernels/param_pack.py``, plain
:func:`pack_plain`).

Constants are float32 (optax's weak-typed Python floats become float32 the
same way).  ``b^count`` is taken in float64 and rounded to float32 (the
kernel's ``pow`` and torch's agree there; XLA's float32 ``pow`` may differ
from the correctly rounded value by an ulp, which the tests state).

The sum of squares has a fixed order that the kernel shares: the buffer,
zero-padded to ``K * R * THREADS * VEC`` elements, is read as [K, R,
THREADS, VEC]; each (block k, thread j) folds its R * VEC squares left to
right (a float4 load at a time), each block sums its THREADS partials by the
halving tree, and the K block sums are summed by the halving tree.  optax
sums each leaf and then the leaves in tree order, so ``g_norm`` agrees with
optax's to a few ulps, not bitwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np
import torch

from ..ops.physics import tree_sum_last

#: threads per block of the sum of squares, the floats each loads at a
#: time, and the most blocks (partials) a group uses
THREADS = 256
VEC = 4
MAX_BLOCKS = 1024
INT32_MAX = 2 ** 31 - 1


def f32(x: float) -> float:
    """``x`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """optax ``adam(lr)`` after ``clip_by_global_norm(max_norm)``."""

    lr: float = 3e-4
    max_norm: float = 5.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    #: the bias corrections in float64 (the float64 clock's run)
    x64: bool = False

    def constants(self):
        """The float32 constants of the elementwise pass, in the kernel's
        argument order: (1-b1, b1, 1-b2, b2, eps, -lr, max_norm)."""
        return tuple(f32(v) for v in (1.0 - self.b1, self.b1, 1.0 - self.b2,
                                      self.b2, self.eps, -self.lr,
                                      self.max_norm))


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` for one flat group: ``count`` int32 0-d,
    ``mu`` and ``nu`` float32 like the group's buffer."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def adam_init(flat: torch.Tensor) -> AdamState:
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=flat.device),
                     mu=torch.zeros_like(flat), nu=torch.zeros_like(flat))


def flatten_params(params: Iterable[torch.nn.Parameter]) -> torch.Tensor:
    """Move ``params`` into one new flat float32 buffer (in the given order)
    and make each a view of its slice; returns the buffer."""
    params = list(params)
    dev = params[0].device
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                       device=dev)
    off = 0
    with torch.no_grad():
        for p in params:
            n = p.numel()
            flat[off:off + n].copy_(p.reshape(-1))
            p.data = flat[off:off + n].view(p.shape)
            off += n
    return flat


def pack_plain(pairs) -> None:
    """B5g's plain version (``kernels/param_pack.py``): ``dst.copy_(src)``
    for each (src, dst) pair, float32 -> bf16 rounded to nearest even."""
    for src, dst in pairs:
        dst.copy_(src)


def norm_layout(n: int):
    """(K blocks, R float4s per thread) of the sum of squares over n."""
    per = THREADS * VEC
    r = max(1, math.ceil(n / (MAX_BLOCKS * per)))
    return max(1, math.ceil(n / (r * per))), r


def sum_squares(g: torch.Tensor) -> torch.Tensor:
    """sum g^2 over a flat float32 buffer in the fixed blocked order (a 0-d
    tensor)."""
    n = g.numel()
    k, r = norm_layout(n)
    x = torch.zeros(k * r * THREADS * VEC, dtype=torch.float32, device=g.device)
    x[:n] = g
    sq = (x * x).reshape(k, r, THREADS, VEC)
    acc = sq[:, 0, :, 0]
    for i in range(r):
        for v in range(VEC):
            if i or v:
                acc = acc + sq[:, i, :, v]
    return tree_sum_last(tree_sum_last(acc))


def bias_correction(decay: float, count: torch.Tensor,
                    x64: bool = False) -> torch.Tensor:
    """1 - decay^count as float32: the power of float32(decay) in float64,
    rounded once, then the float32 difference; with ``x64`` (optax under
    ``jax_enable_x64``) the power of the float64 decay and the difference
    both in float64, rounded once at the end."""
    if x64:
        d = torch.full((), decay, dtype=torch.float64, device=count.device)
        return (1.0 - torch.pow(d, count.to(torch.float64))).to(torch.float32)
    d = torch.full((), f32(decay), dtype=torch.float64, device=count.device)
    return 1 - torch.pow(d, count.to(torch.float64)).to(torch.float32)


def clip_adam_update(p: torch.Tensor, g: torch.Tensor, st: AdamState,
                     cfg: AdamConfig, target: Optional[torch.Tensor] = None,
                     tau: float = 0.0, clamp: Optional[float] = None,
                     shadow: Optional[torch.Tensor] = None,
                     target_shadow: Optional[torch.Tensor] = None,
                     exp_out: Optional[torch.Tensor] = None) -> None:
    """One clipped-Adam step of a flat group, in place (``p``, ``st`` and,
    for the critic, the Polyak ``target``), in optax's order (module note);
    ``g`` float32 or bf16 (widened exactly); ``clamp`` caps ``p`` after the
    step (log alpha's ``alpha_max``); ``shadow`` and ``target_shadow``
    receive bf16(p) and bf16(target) after it, ``exp_out`` exp(p)."""
    c1, b1, c2, b2, eps, neg_lr, max_norm = cfg.constants()
    g = g.to(torch.float32)
    g_norm = torch.sqrt(sum_squares(g))
    mx = torch.full((), max_norm, dtype=torch.float32, device=g.device)
    g = torch.where(g_norm < mx, g, (g / g_norm) * max_norm)
    mu = c1 * g + b1 * st.mu
    nu = c2 * (g * g) + b2 * st.nu
    count = torch.where(st.count < INT32_MAX, st.count + 1, st.count)
    u = (mu / bias_correction(cfg.b1, count, cfg.x64)) / (
        torch.sqrt(nu / bias_correction(cfg.b2, count, cfg.x64) + 0.0) + eps)
    p_new = p + u * neg_lr
    if target is not None:
        target.copy_(polyak(target, p_new, tau))
    if clamp is not None:
        p_new = torch.clamp_max(p_new, clamp)
    p.copy_(p_new)
    st.mu.copy_(mu)
    st.nu.copy_(nu)
    st.count.copy_(count)
    if shadow is not None:
        pack_plain([(p, shadow)])
    if target_shadow is not None:
        pack_plain([(target, target_shadow)])
    if exp_out is not None:
        exp_out.copy_(torch.exp(p).reshape(exp_out.shape))


def polyak(target: torch.Tensor, online: torch.Tensor, tau: float):
    """(1 - tau) * target + tau * online, with float32 constants."""
    return f32(1.0 - tau) * target + f32(tau) * online
