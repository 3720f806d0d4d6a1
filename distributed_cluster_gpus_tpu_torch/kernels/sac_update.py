"""B5a and B5b: the SAC update's loss regions — hand-written CUDA kernels
and their wrappers.

Replace the XLA-fused regions of the JAX package's ``sac_train_step``
(``distributed_cluster_gpus_tpu/rl/sac.py:206``):

* B5a, ``quantile_huber_loss`` (``:178``, called per twin at ``:242-243``)
  and its gradient: ``csrc/quantile_huber.cu``;
* B5b, the exact marginalization over joint actions: the critic target
  (``:223-236``, with ``rl/cmdp.py:59``'s effective reward) and the actor
  term (``:251-266``) with its gradient: ``csrc/marginal.cu``.

Each ``.cu`` head note gives its design and bound.  The wrappers
(:func:`quantile_huber`, :func:`marginal_target`, :func:`marginal_actor`)
launch the kernel for tensors on the card (built on first use) or raise,
and run the plain version (``rl/sac.py``) for tensors on the CPU; there is
no fallback.  Each counts its launches in ``<wrapper>.launches``.

Each kernel writes its gradient in the forward (B5a dL/dq; B5b's actor term
dL/dlogp of each head, the critic's quantiles held constant, JAX's
``stop_gradient``), which ``rl/sac.py::sac_train_step`` carries back by
hand; ``plain=True`` there calls the plain versions on any device.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

F32 = torch.float32
#: per device, the zeroed uint32 the loss kernels count their arrivals in
#: (B5a's warps, B5b's rows); the last to arrive sets it back to 0, so a
#: launch queues no memset
_counters = {}


def _counter(dev):
    c = _counters.get(dev)
    if c is None:
        c = _counters[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return c


P, I, LL, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: the kernels' envelope: B5a's batch rows and quantiles, B5b's joint
#: actions and head entries (each padded to a power of two), and the actor
#: term's batch rows (``csrc/quantile_huber.cu``, ``csrc/marginal.cu``)
HUBER_MAX_B, HUBER_MAX_Q = 4096, 64
MARGINAL_MAX_A, MARGINAL_MAX_HEAD, ACTOR_MAX_B = 1024, 256, 8192


def target_warps(A: int) -> int:
    """The warps a batch row of B5b's target takes for A joint actions: a
    warp per 4 of the padded actions (the tree's register levels over 4
    leaves: the fastest of 1 to 32 warps at the published 8 x 8 on the
    H100, PERF.md §6), at least 1, at most 32 (so at most 32 actions a
    warp)."""
    Ap = 1
    while Ap < A:
        Ap *= 2
    return min(32, max(1, Ap // 4))


def quantile_huber(q, target, taus, kappa: float = 1.0):
    """B5a: (loss, dloss/dq) of ``q`` [B, 2, N] against ``target`` [B, M] at
    ``taus`` [N]; the kernel on the card, ``rl.sac.quantile_huber_loss`` on
    the CPU."""
    from ..rl.optim import f32
    from ..rl.sac import quantile_huber_loss

    if not build.on_card("quantile_huber", q):
        return quantile_huber_loss(q, target, taus, kappa)
    dev = q.device
    B, _, N = q.shape
    M = target.shape[-1]
    build.check("quantile_huber", "q", q, F32, dev, (B, 2, N))
    build.check("quantile_huber", "target", target, F32, dev, (B, M))
    build.check("quantile_huber", "taus", taus, F32, dev, (N,))
    loss = torch.empty((), dtype=F32, device=dev)
    grad = torch.empty_like(q)
    partial = torch.empty(2 * B, dtype=F32, device=dev)
    counter = _counter(dev)
    fn = build.bind("quantile_huber", "quantile_huber_launch",
              [P, P, P, P, P, P, P, I, I, I, FL, FL, P])
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), target.data_ptr(), taus.data_ptr(),
                loss.data_ptr(), grad.data_ptr(), partial.data_ptr(),
                counter.data_ptr(), B, N, M, f32(kappa), f32(0.5 * kappa),
                build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed("quantile_huber", rc)
    quantile_huber.launches += 1
    return loss, grad


quantile_huber.launches = 0


def _q_view(op, q_all, dev):
    if q_all.dtype != F32 or q_all.device != dev or q_all.dim() != 4 \
            or q_all.shape[1] != 2 or q_all.stride(3) != 1:
        raise ValueError(f"{op}: q_all must be float32 [B, 2, A, N] on {dev} "
                         "with unit stride over N")
    return q_all.stride(0), q_all.stride(1), q_all.stride(2)


def marginal_target(q1_all, logp_dc1, logp_g1, r, costs, lam, targets, done,
                    alpha, gamma: float):
    """B5b's critic target: (target_q [B, N], r_eff [B]); the kernel on the
    card (:func:`target_warps` a row), and ``rl.sac.marginal_target`` on
    the CPU."""
    from ..rl import sac as rsac
    from ..rl.optim import f32

    if not build.on_card("marginal_target", q1_all):
        return rsac.marginal_target(q1_all, logp_dc1, logp_g1, r, costs, lam,
                                    targets, done, alpha, gamma)
    dev = q1_all.device
    B, _, A, N = q1_all.shape
    n_dc, n_g = logp_dc1.shape[1], logp_g1.shape[1]
    K = costs.shape[1]
    if n_dc * n_g != A:
        raise ValueError(f"marginal_target: {n_dc} x {n_g} heads for {A} actions")
    sb, st, sa = _q_view("marginal_target", q1_all, dev)
    op = "marginal_target"
    for name, t, shape in (("logp_dc", logp_dc1, (B, n_dc)),
                           ("logp_g", logp_g1, (B, n_g)), ("r", r, (B,)),
                           ("costs", costs, (B, K)), ("lam", lam, (K,)),
                           ("targets", targets, (K,)), ("done", done, (B,)),
                           ("alpha", alpha, ())):
        build.check(op, name, t, F32, dev, shape)
    tq = torch.empty((B, N), dtype=F32, device=dev)
    r_eff = torch.empty(B, dtype=F32, device=dev)
    fn = build.bind("marginal", "marginal_target_launch",
              [P, LL, LL, LL, P, P, P, P, P, P, P, P, FL, P, P, I, I, I, I, I,
               I, P])
    with torch.cuda.device(dev):
        rc = fn(q1_all.data_ptr(), sb, st, sa, logp_dc1.data_ptr(),
                logp_g1.data_ptr(), r.data_ptr(), costs.data_ptr(),
                lam.data_ptr(), targets.data_ptr(), done.data_ptr(),
                alpha.data_ptr(), f32(gamma), tq.data_ptr(), r_eff.data_ptr(),
                B, n_dc, n_g, N, K, target_warps(A),
                build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    marginal_target.launches += 1
    return tq, r_eff


marginal_target.launches = 0


def marginal_actor(q0_all, logp_dc, logp_g, alpha):
    """B5b's actor term: (loss, H [B], dloss/dlogp_dc, dloss/dlogp_g); the
    kernel on the card, ``rl.sac.marginal_actor`` on the CPU."""
    from ..rl import sac as rsac

    if not build.on_card("marginal_actor", q0_all):
        return rsac.marginal_actor(q0_all, logp_dc, logp_g, alpha)
    dev = q0_all.device
    B, _, A, N = q0_all.shape
    n_dc, n_g = logp_dc.shape[1], logp_g.shape[1]
    if n_dc * n_g != A:
        raise ValueError(f"marginal_actor: {n_dc} x {n_g} heads for {A} actions")
    sb, st, sa = _q_view("marginal_actor", q0_all, dev)
    op = "marginal_actor"
    for name, t, shape in (("logp_dc", logp_dc, (B, n_dc)),
                           ("logp_g", logp_g, (B, n_g)), ("alpha", alpha, ())):
        build.check(op, name, t, F32, dev, shape)
    loss = torch.empty((), dtype=F32, device=dev)
    ent = torch.empty(B, dtype=F32, device=dev)
    d_dc = torch.empty((B, n_dc), dtype=F32, device=dev)
    d_g = torch.empty((B, n_g), dtype=F32, device=dev)
    partial = torch.empty(B, dtype=F32, device=dev)
    counter = _counter(dev)
    fn = build.bind("marginal", "marginal_actor_launch",
              [P, LL, LL, LL, P, P, P, P, P, P, P, P, P, I, I, I, I, P])
    with torch.cuda.device(dev):
        rc = fn(q0_all.data_ptr(), sb, st, sa, logp_dc.data_ptr(),
                logp_g.data_ptr(), alpha.data_ptr(), loss.data_ptr(),
                ent.data_ptr(), d_dc.data_ptr(), d_g.data_ptr(),
                partial.data_ptr(), counter.data_ptr(), B, n_dc, n_g, N,
                build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    marginal_actor.launches += 1
    return loss, ent, d_dc, d_g


marginal_actor.launches = 0
