"""Distributional hybrid-action SAC (CHSAC-AF): config, state, acting and
the update.

Counterpart of ``distributed_cluster_gpus_tpu/rl/sac.py``: ``SACConfig``
(``:38``), ``SACState`` (``:96``), ``sac_init`` (``:122``),
``select_action`` (``:150``), ``make_policy_apply`` (``:166``),
``quantile_huber_loss`` (``:178``), ``_joint_policy`` (``:187``),
``sac_zero_metrics`` and ``sac_train_step`` (``:206``).  ``sac_init``
draws the JAX package's initial weights from the same threefry key (flax's
lecun-normal through the port's own threefry, ``ops/prng.py``).

Acting: on the card the engine does not call :func:`select_action`; the
policy runs inside the B1 kernel (``csrc/event_scan.cu``, the B4 device
code) from the bf16 weights :func:`policy_weights` lays out once per chunk.
The plain step (``sim/step.py``) calls it through ``policy_apply``, which is
how the kernel is held bit for bit against its plain version.

Learning: :func:`sac_train_step` is one update, in the JAX package's order,
on the agent's device (``rl/nets.py``'s training forward, its gradient
written out by hand).  The networks' forward and dX products are B5d's
kernels on the card, the kernel gradients bf16 ``torch.matmul``; the
regions XLA fused run as hand-written kernels on the card, each with its
plain version here or beside it:

* B6b, the replay sample: ``kernels/replay_sample.py`` (plain:
  ``rl/replay.py::replay_sample``);
* B5g, the bf16 parameter shadows and the gradients' widening: inside
  B5c (below), which reads the bf16 gradients and writes each group's
  shadow after its step; :func:`refresh_shadows` (``kernels/param_pack.py``,
  plain: ``rl/optim.py::pack_plain``) fills the shadows outside the
  update;
* B5d, each Dense layer's product with its epilogue, and its gradient
  (a hidden layer's fused into the dX product above it); B5e, the one-hot
  critic's input rows, built inside the critic's first layer; B5f's
  forward, the masked log-softmax of both heads, in the epilogue of their
  one product; B5f's backward with the heads' own top-layer backward in
  one launch: ``kernels/dense.py``, ``kernels/log_softmax.py`` (plain:
  ``rl/nets.py``);
* B5a, the quantile-Huber loss and its gradient: ``kernels/sac_update.py``
  (plain: :func:`quantile_huber_loss`);
* B5b, the exact marginalization over joint actions, the critic target and
  the actor term with its gradient: ``kernels/sac_update.py`` (plain:
  :func:`marginal_target` and :func:`marginal_actor`);
* B5c, clipped Adam with the Polyak target and the alpha clamp, and
  B5g's casts: ``kernels/adam.py`` (plain:
  ``rl/optim.py::clip_adam_update``).

The update's small tail (R1d: the temperature loss and its gradient, the
PID step, the metrics, the observations' casts, the update index's step,
and on the heads critic the taken action's gather and its gradient's
scatter) has no launch of its own: B6b casts the observations and advances
the index, B5a takes the taken action, scatters its gradient and takes
``q_mean``, B5b's target takes ``r_eff``'s mean and the PID step
(:class:`PidTail`), B5b's actor term the entropy's mean and the
temperature's loss and hand-written gradient (:class:`TempTail`), B5c
writes ``exp(log alpha)``; each writes its metric in place.  Their plain
versions take the batch means by :func:`batch_mean` (the kernels' tree
over b), not ``Tensor.mean``.

The sums of B5a, B5b, B5d and B5f follow the fixed halving tree of
:func:`tree_sum_last` (quantile-Huber: over M, then over N, then over B;
marginalization: over A, over N, over B; a bias gradient over the rows; a
head's exponentials and gradients), which their kernels repeat, so
each kernel is bitwise equal to its plain version on the card.  Against
XLA's own reduction orders they agree to float32 rounding.
``plain=True`` runs the plain versions on any device (the card's smoke
holds the two paths bitwise equal).  Nothing reads the card from the host
inside an update.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops import prng
from ..ops.physics import tree_sum_last
from .cmdp import (CMDPState, ConstraintSpec, _gains, cmdp_init,
                   effective_reward, update_lagrange)
from .nets import (BF16, HybridActor, MLPStateEncoder, QuantileCritic,
                   QuantileCriticHeads, dense_layers, init_modules,
                   pin_f32_accumulation)
from .optim import AdamConfig, AdamState, adam_init, f32, flatten_params


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """Static hyperparameters (the JAX package's defaults).  ``alpha_max``
    caps the temperature (a log-space clamp; None leaves it uncapped);
    ``critic_arch`` is "onehot" (the reference's critic on one-hot actions)
    or "heads" (per-joint-action output heads)."""

    obs_dim: int
    n_dc: int
    n_g: int
    n_quantiles: int = 32
    latent: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    alpha_init: float = 0.2
    target_entropy: float = -3.0
    alpha_max: Optional[float] = 10.0
    grad_clip: float = 5.0
    batch: int = 256
    constraints: Tuple[ConstraintSpec, ...] = ()
    critic_arch: str = "onehot"
    #: the reference's x64 numerics in the update (the float64 clock's
    #: run): B6b's uniform and B5c's bias corrections in float64
    x64: bool = False

    def __post_init__(self):
        if not self.constraints:
            raise ValueError("SACConfig needs at least one ConstraintSpec")
        if self.critic_arch not in ("onehot", "heads"):
            raise ValueError(f"critic_arch {self.critic_arch!r}: 'onehot' or "
                             "'heads'")
        if self.alpha_max is not None and not self.alpha_max > 0:
            raise ValueError("alpha_max must be positive (log-space clamp), "
                             f"got {self.alpha_max}")

    def adam(self) -> AdamConfig:
        return AdamConfig(lr=self.lr, max_norm=self.grad_clip, x64=self.x64)


#: the optimizer groups, in the update's order of application
GROUPS = ("critic", "actor", "enc", "alpha")
#: the groups the products read (bf16 shadows) and those with gradients
#: (bf16 staging buffers)
SHADOWED = ("enc", "actor", "critic", "target")
STAGED = ("critic", "actor", "enc")


class UpdateConsts:
    """A config's constants of the update on one device, built once with
    the state (building them inside an update would copy from the host):
    the quantile fractions ``taus`` [N], the PID gains (``cmdp._gains``) and
    the log-alpha cap (a float32 value, or None)."""

    def __init__(self, cfg: SACConfig, dev):
        N = cfg.n_quantiles
        self.taus = (torch.arange(N, dtype=torch.float32, device=dev) + 0.5) \
            / _count(N, dev)
        self.gains = _gains(cfg.constraints, dev)
        self.clamp = (None if cfg.alpha_max is None else float(
            torch.log(torch.tensor(cfg.alpha_max, dtype=torch.float32))))


@dataclasses.dataclass
class SACState:
    """All learned state.  Each group's parameters live in one flat float32
    buffer (``flat[group]``; the modules' parameters and ``log_alpha`` are
    views of it), as do the target critic's (``flat["target"]``).  The
    networks' groups also have a bf16 shadow (``shadow[group]`` =
    bf16(``flat[group]``): filled by :func:`assemble`, rewritten by each
    update's B5c step, and by :func:`refresh_shadows` after any other
    write of ``flat``) and, but the target, a bf16 gradient staging buffer
    (``stage[group]``), both in ``flat``'s layout (:meth:`views`).
    ``metrics`` holds the last update's metrics (written in place), and
    ``alpha_grad`` [1] the last update's temperature gradient (B5b's actor
    term writes it, B5c reads it).  ``step`` counts the updates taken (the
    host knows it without a read)."""

    enc: MLPStateEncoder
    actor: HybridActor
    critic: torch.nn.Module
    target_critic: torch.nn.Module
    log_alpha: torch.Tensor  # float32 0-d
    enc_opt: AdamState
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState
    cmdp: CMDPState
    flat: Dict[str, torch.Tensor]
    shadow: Dict[str, torch.Tensor]
    stage: Dict[str, torch.Tensor]
    consts: UpdateConsts
    metrics: Dict[str, torch.Tensor]
    step: int = 0
    alpha_grad: Optional[torch.Tensor] = None

    def layers(self):
        """The policy's six Dense layers in the kernel's order: encoder 0-2,
        actor hidden, DC head, GPU-count head."""
        return [*self.enc.layers, *self.actor.layers()]

    def views(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, list]:
        """For each group of ``bufs`` (flat buffers in ``flat``'s layout:
        ``shadow`` or ``stage``), each Dense layer's (kernel, bias) views of
        it at the offsets its parameters have in ``flat[group]``."""
        mods = {"enc": self.enc, "actor": self.actor, "critic": self.critic,
                "target": self.target_critic}
        out = {}
        for g, buf in bufs.items():
            flat, out[g] = self.flat[g], []
            for layer in dense_layers(mods[g]):
                pair = []
                for p in (layer.kernel, layer.bias):
                    off = (p.data_ptr() - flat.data_ptr()) // flat.element_size()
                    pair.append(buf[off:off + p.numel()].view(p.shape))
                out[g].append(tuple(pair))
        return out


def _critic_cls(cfg: SACConfig):
    return QuantileCriticHeads if cfg.critic_arch == "heads" else QuantileCritic


def sac_init(cfg: SACConfig, key: torch.Tensor, device="cuda") -> SACState:
    """Fresh networks initialised from the threefry ``key`` (int64 [2]) as
    the JAX package's ``sac_init`` draws them: ``k_e, k_a, k_c = split(key,
    3)`` are the encoder's, actor's and critic's flax ``init`` keys, each
    kernel lecun-normal from the key flax derives for its Dense
    (``rl/nets.py::init_modules``), the biases zero; the target critic a
    copy of the critic, ``log_alpha`` = log(alpha_init), zeroed Adam states
    and multipliers, on ``device`` (the card unless the caller asks for the
    CPU; raises without a GPU).  The weights are drawn on ``device``: the
    threefry bits are the same there, and the values differ from the CPU's
    only where torch's ``log1p`` does (inside XLA's ``erf_inv``
    polynomial), by an ulp or so (``chip_smoke.py`` measures it)."""
    device = resolve_device(device)
    enc = MLPStateEncoder(cfg.obs_dim, latent=cfg.latent)
    actor = HybridActor(cfg.latent, cfg.n_dc, cfg.n_g)
    critic = _critic_cls(cfg)(cfg.latent, cfg.n_dc, cfg.n_g, cfg.n_quantiles)
    init_modules([enc, actor, critic], prng.split(key.to(device), 3))
    return assemble(cfg, enc, actor, critic, copy.deepcopy(critic),
                    torch.log(torch.tensor(cfg.alpha_init, dtype=torch.float32)),
                    device)


def assemble(cfg: SACConfig, enc, actor, critic, target, log_alpha,
             device, opts: Optional[Dict[str, AdamState]] = None,
             cmdp: Optional[CMDPState] = None, step: int = 0) -> SACState:
    """A SACState on ``device`` from its modules (moved and flattened here)
    and, optionally, carried optimizer and CMDP states."""
    dev = torch.device(device)
    flat = {}
    for name, mod in (("enc", enc), ("actor", actor), ("critic", critic),
                      ("target", target)):
        mod.to(dev)
        flat[name] = flatten_params(mod.parameters())
        mod.requires_grad_(name != "target")
    shadow = {g: torch.empty_like(flat[g], dtype=BF16) for g in SHADOWED}
    stage = {g: torch.empty_like(flat[g], dtype=BF16) for g in STAGED}
    flat["alpha"] = log_alpha.detach().reshape(1).to(device=dev,
                                                     dtype=torch.float32).clone()
    opts = opts or {g: adam_init(flat[g]) for g in GROUPS}
    sac = SACState(enc=enc, actor=actor, critic=critic, target_critic=target,
                    log_alpha=flat["alpha"].view(()),
                    enc_opt=opts["enc"], actor_opt=opts["actor"],
                    critic_opt=opts["critic"], alpha_opt=opts["alpha"],
                    cmdp=cmdp if cmdp is not None else cmdp_init(
                        cfg.constraints, dev),
                    flat=flat, shadow=shadow, stage=stage,
                    consts=UpdateConsts(cfg, dev),
                    metrics=_metric_buffers(cfg, dev), step=step,
                    alpha_grad=torch.zeros(1, dtype=torch.float32, device=dev))
    refresh_shadows(sac)
    return sac


def refresh_shadows(sac: SACState) -> None:
    """Rewrite every bf16 shadow from its float32 group: ``shadow[g] =
    bf16(flat[g])`` (B5g's kernel, ``kernels/param_pack.py``, one launch on
    the card).  The update keeps the shadows in step itself (B5c writes
    them); whatever else writes a group's parameters (loading weights,
    perturbing them, replacing a shadow buffer) calls this before the next
    update."""
    from ..kernels.param_pack import param_pack

    param_pack([(sac.flat[g], sac.shadow[g]) for g in SHADOWED])


@torch.no_grad()
def policy_logp(sac: SACState, obs, mask_dc, mask_g):
    """(logp_dc, logp_g) of a batch ``obs`` [B, obs_dim] by the acting
    recipe."""
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


# ---------------------------------------------------------------------------
# The loss regions' plain versions (B5a, B5b) with their batch tails.  Each
# returns its value and the gradient its kernel writes
# (kernels/sac_update.py launches the kernels).
# ---------------------------------------------------------------------------

def _count(n, device) -> torch.Tensor:
    """``n`` as a float32 0-d tensor on ``device``: a divisor (torch on the
    card turns a division by a Python number into a reciprocal multiply).
    A fill, not a copy from the host."""
    return torch.full((), float(n), dtype=torch.float32, device=device)


def quantile_huber_loss(q, target, taus, kappa: float = 1.0, take=None,
                        loss_out=None, q_mean_out=None):
    """B5a's plain version, both twins at once: the QR-DQN loss of ``q``
    [B, 2, N] against ``target`` [B, M] at quantile fractions ``taus`` [N],
    ``l_0 + l_1`` with ``l_t = mean_b sum_i mean_j w * huber(td)``, ``td =
    target[b, j] - q[b, t, i]``, ``w = |tau_i - 1{td < 0}|``; and its gradient
    dL/dq [B, 2, N].  Sums by the tree: over j, then i, then b.

    With ``take`` = (a_dc, a_g, n_g), ``q`` holds every joint action [B, 2,
    A, N]: the loss is the taken action's (a = a_dc * n_g + a_g) and the
    gradient has q's shape, zero but at the taken action.  ``loss_out``
    receives the loss (and is returned), ``q_mean_out`` the taken
    quantiles' mean, ``(tree_b(tree_i(q_0)) + tree_b(tree_i(q_1))) / (2 B
    N)``."""
    q_shape = q.shape
    if take is not None:
        a_dc, a_g, n_g = take
        idx = (a_dc.long() * n_g + a_g.long())[:, None, None, None].expand(
            q.shape[0], 2, 1, q.shape[-1])
        q = torch.gather(q, 2, idx)[:, :, 0]
    B, M = q.shape[0], target.shape[-1]
    k = f32(kappa)
    td = target[:, None, None, :] - q[:, :, :, None]  # [B, 2, N, M]
    a = td.abs()
    small = a <= k
    huber = torch.where(small, 0.5 * (td * td), k * (a - f32(0.5 * kappa)))
    w = (taus[None, None, :, None] - (td < 0).to(torch.float32)).abs()
    m_t, b_t = _count(M, q.device), _count(B, q.device)
    rows = tree_sum_last(tree_sum_last(w * huber) / m_t)  # [B, 2]
    per_twin = tree_sum_last(rows.t()) / b_t  # [2]
    loss = per_twin[0] + per_twin[1]
    dh = torch.where(small, td, torch.where(td > 0, k, -k))
    grad = -((tree_sum_last(w * dh) / m_t) / b_t)
    if take is not None:
        full = torch.zeros(q_shape, dtype=grad.dtype, device=grad.device)
        grad = full.scatter_(2, idx, grad[:, :, None])
    if q_mean_out is not None:
        q_twin = tree_sum_last(tree_sum_last(q).t())
        q_mean_out.copy_((q_twin[0] + q_twin[1])
                         / _count(2 * B * q.shape[-1], q.device))
    if loss_out is not None:
        loss = loss_out.copy_(loss)
    return loss, grad


def _joint_policy(logp_dc, logp_g):
    """Joint log-probabilities over the n_dc x n_g action set [B, A] (a =
    a_dc * n_g + a_g)."""
    return (logp_dc[:, :, None] + logp_g[:, None, :]).reshape(
        logp_dc.shape[0], -1)


def _twin_min(q_all):
    """min over the twins of [B, 2, A, N] (torch's NaN-propagating minimum)."""
    return torch.minimum(q_all[:, 0], q_all[:, 1])


class PidTail(NamedTuple):
    """B5b target's batch tail: ``r_eff``'s batch mean into ``r_eff_mean``,
    and the PID step of ``rl/cmdp.py::update_lagrange`` on the batch's
    costs, in place on ``cmdp`` with ``gains`` (``cmdp._gains``), the new
    multipliers also into ``lam`` and the mean violation into
    ``violation`` (the update's metrics)."""

    cmdp: CMDPState
    gains: tuple
    r_eff_mean: torch.Tensor
    lam: torch.Tensor
    violation: torch.Tensor


class TempTail(NamedTuple):
    """B5b actor term's batch tail: the entropy's batch mean into
    ``entropy``, the temperature loss into ``alpha_loss`` and its gradient
    with respect to log alpha into ``alpha_grad`` (:func:`temperature`)."""

    target_entropy: float
    entropy: torch.Tensor
    alpha_loss: torch.Tensor
    alpha_grad: torch.Tensor


def batch_mean(x):
    """The mean over the last axis as the kernels' batch tails take it:
    ``tree_sum_last(x) / n``."""
    return tree_sum_last(x) / _count(x.shape[-1], x.device)


def pid_tail(pid: PidTail, r_eff, costs) -> None:
    """:class:`PidTail`'s plain version: r_eff's batch mean and the PID
    step, written in place."""
    pid.r_eff_mean.copy_(batch_mean(r_eff))
    new, viol = update_lagrange(pid.cmdp, pid.gains, costs)
    for name in ("lam", "integral", "prev_err"):
        getattr(pid.cmdp, name).copy_(getattr(new, name))
    pid.lam.copy_(new.lam)
    pid.violation.copy_(viol)


def temperature(ent, log_alpha, target_entropy: float):
    """(the entropy's batch mean, the temperature loss ``mean_b(exp(log
    alpha) * x_b)``, its gradient with respect to log alpha) with ``x_b =
    ent[b] + target_entropy`` (held constant), the gradient written out as
    the reverse pass of ``jax.value_and_grad`` takes it: the mean's
    cotangent 1 / B times x_b, summed over b, times exp's output.  Sums by
    the tree over b."""
    e = torch.exp(log_alpha)
    x = ent + f32(target_entropy)
    b_t = _count(ent.shape[0], ent.device)
    inv_b = _count(1, ent.device) / b_t
    return (tree_sum_last(ent) / b_t, tree_sum_last(e * x) / b_t,
            tree_sum_last(x * inv_b) * e)


def marginal_target(q1_all, logp_dc1, logp_g1, r, costs, lam, targets, done,
                    log_alpha, gamma: float, pid: Optional[PidTail] = None):
    """B5b's target, plain: (target_q [B, N], r_eff [B]) with ``r_eff`` the
    Lagrangian effective reward and ``target_q = r_eff + gamma * (1 - done)
    * v1``, ``v1 = sum_a pi(a) (min_twin q1 - alpha log pi(a))`` (the sum
    over A by the tree), ``alpha = exp(log_alpha)`` (a 0-d tensor).
    ``q1_all`` [B, 2, A, N] (any strides).  A masked action has pi = 0 and
    adds 0.  With ``pid``, then :func:`pid_tail`."""
    alpha = torch.exp(log_alpha)
    r_eff = effective_reward(r, costs, lam, targets)
    logpi = _joint_policy(logp_dc1, logp_g1)
    pi = torch.exp(logpi)
    soft = _twin_min(q1_all) - alpha * logpi[:, :, None]
    v1 = tree_sum_last((pi[:, :, None] * soft).transpose(1, 2))
    tq = r_eff[:, None] + (f32(gamma) * (1 - done))[:, None] * v1
    if pid is not None:
        pid_tail(pid, r_eff, costs)
    return tq, r_eff


def marginal_actor(q0_all, logp_dc, logp_g, log_alpha, loss_out=None,
                   temp: Optional[TempTail] = None):
    """B5b's actor term, plain: (loss, H [B], dloss/dlogp_dc, dloss/dlogp_g)
    with ``qm(a) = mean_i min_twin q0`` (held constant), ``H = -sum_a pi log
    pi``, ``loss = -mean_b(sum_a pi qm + alpha H)``, ``alpha =
    exp(log_alpha)``; the gradient of the loss through pi = exp(logp_dc +
    logp_g) is ``-pi (qm - alpha (log pi + 1)) / B`` per joint action,
    summed over the other head.  Sums by the tree: over N, over A, over B,
    and per head over the other head.  ``loss_out`` receives the loss (and
    is returned); with ``temp``, :func:`temperature`'s three values are
    written into it."""
    alpha = torch.exp(log_alpha)
    B, n_dc, n_g = logp_dc.shape[0], logp_dc.shape[1], logp_g.shape[1]
    n_t, b_t = (_count(q0_all.shape[-1], logp_dc.device),
                _count(B, logp_dc.device))
    qm = tree_sum_last(_twin_min(q0_all)) / n_t  # [B, A]
    logpi = _joint_policy(logp_dc, logp_g)
    pi = torch.exp(logpi)
    ent = -tree_sum_last(pi * logpi)
    val = tree_sum_last(pi * qm) + alpha * ent
    loss = -(tree_sum_last(val) / b_t)
    g = (pi * (qm - alpha * (logpi + 1))).reshape(B, n_dc, n_g)
    d_dc = -(tree_sum_last(g) / b_t)
    d_g = -(tree_sum_last(g.transpose(1, 2)) / b_t)
    if temp is not None:
        for out, v in zip((temp.entropy, temp.alpha_loss, temp.alpha_grad),
                          temperature(ent, log_alpha, temp.target_entropy)):
            out.copy_(v)
    if loss_out is not None:
        loss = loss_out.copy_(loss)
    return loss, ent, d_dc, d_g


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------

METRIC_KEYS = ("critic_loss", "actor_loss", "alpha_loss", "alpha", "entropy",
               "q_mean", "r_eff_mean", "lambda", "violation")


def _metric_buffers(cfg: SACConfig, dev) -> Dict[str, torch.Tensor]:
    """The update's metrics as tensors that persist across updates (each
    update writes them in place): 0-d float32, ``lambda`` and ``violation``
    [n_costs]."""
    n = len(cfg.constraints)
    return {k: torch.zeros(n if k in ("lambda", "violation") else (),
                           dtype=torch.float32, device=dev)
            for k in METRIC_KEYS}


def sac_zero_metrics(cfg: SACConfig, sac: SACState):
    """The metrics dict of :func:`sac_train_step` for no update."""
    z = torch.zeros((), dtype=torch.float32, device=sac.log_alpha.device)
    return {"critic_loss": z, "actor_loss": z, "alpha_loss": z,
            "alpha": torch.exp(sac.log_alpha), "entropy": z, "q_mean": z,
            "r_eff_mean": z, "lambda": sac.cmdp.lam,
            "violation": torch.zeros(len(cfg.constraints), dtype=torch.float32,
                                     device=z.device)}


def sac_train_step(cfg: SACConfig, sac: SACState, rb, key, plain: bool = False,
                   index: Optional[torch.Tensor] = None):
    """One CHSAC-AF update from a replay sample, in place on ``sac``;
    returns ``sac.metrics``, the JAX package's metrics (0-d tensors and the
    [n_costs] ``lambda``/``violation``, on the device), which the next
    update overwrites.  ``key`` (int64 [2]) is the update's threefry key,
    the sample drawing with ``split(key)[0]`` as the JAX update does; given
    ``index`` (an int32 0-d tensor on the device) ``key`` is the chunk's key
    and the update's is ``split(key, max_steps)[index]``, both read on the
    device (``CHSAC_AF.train_steps``), and the update advances ``index`` by
    one.  ``plain`` runs the regions' plain versions in place of their
    kernels.

    The networks run on the bf16 shadows of their groups (bf16 of the
    parameters the update starts from: B5c's step wrote them, or
    :func:`refresh_shadows`); their gradients are written out by hand into
    the bf16 staging buffers (``rl/nets.py``), which B5c reads, widening
    them, and its step writes the shadows of the new parameters (B5g's
    casts inside B5c).  The temperature's gradient is written out by hand
    too (:func:`temperature`): nothing goes through autograd.  The metrics,
    the CMDP step and the observations' casts run inside the regions'
    kernels (module note), so on the card the update launches nothing but
    its kernels and the dW products.

    Capturable as a CUDA graph: every tensor the next update reads (the
    parameters, moments, counts, the target, log alpha, the CMDP state, the
    metrics, the update index) is written in place, and nothing is read
    back to the host."""
    from ..kernels import sac_update as b5
    from ..kernels.adam import AdamGroup, adam_update
    from ..kernels.replay_sample import replay_sample

    pin_f32_accumulation()
    c, m = sac.consts, sac.metrics
    dev = rb.valid.device
    if index is None:
        key = prng.split(key, 2)[0].to(dev)
    # the sample, its observations in bf16 (the encoder's input cast); the
    # update index advances once the sample has read it
    batch = replay_sample(rb, key, cfg.batch, plain=plain, index=index,
                          bf16_obs=True, advance=index is not None,
                          x64=cfg.x64)
    w, dw = sac.views(sac.shadow), sac.views(sac.stage)
    huber = quantile_huber_loss if plain else b5.quantile_huber
    target_fn = marginal_target if plain else b5.marginal_target
    actor_fn = marginal_actor if plain else b5.marginal_actor
    la = sac.log_alpha
    # the heads critic reads the encoder's bf16 latent (its first layer's
    # input); the one-hot critic's first layer rounds the float32 latent
    heads = cfg.critic_arch == "heads"

    # critic target: exact marginalization over the next actions; the
    # batch tail takes r_eff's mean and the PID step
    lat1, acts1 = sac.enc.train_forward(batch["s1"], w["enc"], plain)
    logp_dc1, logp_g1, _ = sac.actor.train_forward(
        acts1[-1], batch["mask_dc"], batch["mask_g"], w["actor"], plain)
    q1_all = sac.target_critic.all_actions(acts1[-1] if heads else lat1,
                                           w["target"], plain)
    target_q, _ = target_fn(
        q1_all, logp_dc1, logp_g1, batch["r"], batch["costs"], sac.cmdp.lam,
        c.gains[0], batch["done"], la, cfg.gamma,
        PidTail(sac.cmdp, c.gains, m["r_eff_mean"], m["lambda"],
                m["violation"]))

    # critic loss and its gradient (the encoder is not differentiated here)
    lat0, acts0 = sac.enc.train_forward(batch["s0"], w["enc"], plain)
    q, saved = sac.critic.train_forward(acts0[-1] if heads else lat0,
                                        batch["a_dc"], batch["a_g"],
                                        w["critic"], plain)
    take = (batch["a_dc"], batch["a_g"], cfg.n_g) if heads else None
    _, dq = huber(q, target_q, c.taus, 1.0, take, m["critic_loss"],
                  m["q_mean"])
    sac.critic.train_backward(saved, dq, w["critic"], dw["critic"], plain)

    # actor + encoder loss and its gradient: exact expectation under the
    # masks at s0, the critic's quantiles held constant; the batch tail
    # takes the entropy's mean and the temperature loss with its gradient
    logp_dc, logp_g, saved = sac.actor.train_forward(
        acts0[-1], batch["mask_dc0"], batch["mask_g0"], w["actor"], plain)
    q0_all = sac.critic.all_actions(acts0[-1] if heads else lat0,
                                    w["critic"], plain)
    _, _, d_dc, d_g = actor_fn(
        q0_all, logp_dc, logp_g, la, m["actor_loss"],
        TempTail(cfg.target_entropy, m["entropy"], m["alpha_loss"],
                 sac.alpha_grad))
    g_lat = sac.actor.hidden_grad(saved, d_dc, d_g, w["actor"], dw["actor"],
                                  plain)
    sac.enc.train_backward(acts0, g_lat, w["enc"], dw["enc"], plain)

    with torch.no_grad():
        adam_update([
            AdamGroup(sac.flat["critic"], sac.stage["critic"], sac.critic_opt,
                      target=sac.flat["target"], tau=cfg.tau,
                      shadow=sac.shadow["critic"],
                      target_shadow=sac.shadow["target"]),
            AdamGroup(sac.flat["actor"], sac.stage["actor"], sac.actor_opt,
                      shadow=sac.shadow["actor"]),
            AdamGroup(sac.flat["enc"], sac.stage["enc"], sac.enc_opt,
                      shadow=sac.shadow["enc"]),
            AdamGroup(sac.flat["alpha"], sac.alpha_grad, sac.alpha_opt,
                      clamp=c.clamp, exp_out=m["alpha"])], cfg.adam(),
            plain=plain)
    sac.step += 1
    return m
