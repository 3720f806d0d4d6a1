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

The update's last plain-torch region runs inside these kernels' batch tails
(each writes into the caller's tensors, the update's metric buffers and its
CMDP state): B5a takes the taken action from every joint action's
quantiles, scatters its gradient and takes ``q_mean``; B5b's target takes
``r_eff``'s mean and the PID step (``rl.sac.PidTail``); B5b's actor term
takes the entropy's mean and the temperature's loss and hand-written
gradient (``rl.sac.TempTail``); both read log alpha, not alpha.
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


def _scalar_out(op, name, t, dev):
    if t is None:
        return torch.empty((), dtype=F32, device=dev)
    build.check(op, name, t, F32, dev)
    if t.numel() != 1:
        raise ValueError(f"{op}: {name} must hold one float")
    return t


def quantile_huber(q, target, taus, kappa: float = 1.0, take=None,
                   loss_out=None, q_mean_out=None):
    """B5a: (loss, dloss/dq) of ``q`` [B, 2, N] (or, with ``take`` = (a_dc,
    a_g, n_g), every joint action's [B, 2, A, N], read at the taken action
    and the gradient of q's shape) against ``target`` [B, M] at ``taus``
    [N]; the loss into ``loss_out`` and the taken quantiles' mean into
    ``q_mean_out`` where given; the kernel on the card,
    ``rl.sac.quantile_huber_loss`` on the CPU."""
    from ..rl.optim import f32
    from ..rl.sac import quantile_huber_loss

    if not build.on_card("quantile_huber", q):
        return quantile_huber_loss(q, target, taus, kappa, take, loss_out,
                                   q_mean_out)
    op = "quantile_huber"
    dev = q.device
    B, N = q.shape[0], q.shape[-1]
    A, n_g, a_dc, a_g = 1, 1, None, None
    if take is None:
        build.check(op, "q", q, F32, dev, (B, 2, N))
    else:
        a_dc, a_g, n_g = take
        A = q.shape[2]
        build.check(op, "q", q, F32, dev, (B, 2, A, N))
        build.check(op, "a_dc", a_dc, torch.int32, dev, (B,))
        build.check(op, "a_g", a_g, torch.int32, dev, (B,))
        if A % n_g:
            raise ValueError(f"{op}: {A} joint actions for heads of {n_g}")
    M = target.shape[-1]
    build.check(op, "target", target, F32, dev, (B, M))
    build.check(op, "taus", taus, F32, dev, (N,))
    loss = _scalar_out(op, "loss_out", loss_out, dev)
    if q_mean_out is not None:
        _scalar_out(op, "q_mean_out", q_mean_out, dev)
    grad = torch.empty_like(q)
    partial = torch.empty(4 * B, dtype=F32, device=dev)
    counter = _counter(dev)
    fn = build.bind("quantile_huber", "quantile_huber_launch",
              [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, FL, FL, P])
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), target.data_ptr(), taus.data_ptr(),
                loss.data_ptr(),
                None if q_mean_out is None else q_mean_out.data_ptr(),
                grad.data_ptr(), partial.data_ptr(), counter.data_ptr(),
                None if a_dc is None else a_dc.data_ptr(),
                None if a_g is None else a_g.data_ptr(), A, n_g, B, N, M,
                f32(kappa), f32(0.5 * kappa), build.stream_of(dev))
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
                    log_alpha, gamma: float, pid=None):
    """B5b's critic target: (target_q [B, N], r_eff [B]); with ``pid`` (an
    ``rl.sac.PidTail``) also r_eff's batch mean and the PID step in place;
    the kernel on the card (:func:`target_warps` a row), and
    ``rl.sac.marginal_target`` on the CPU."""
    from ..rl import sac as rsac
    from ..rl.optim import f32

    if not build.on_card("marginal_target", q1_all):
        return rsac.marginal_target(q1_all, logp_dc1, logp_g1, r, costs, lam,
                                    targets, done, log_alpha, gamma, pid)
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
                           ("log_alpha", log_alpha, ())):
        build.check(op, name, t, F32, dev, shape)
    tq = torch.empty((B, N), dtype=F32, device=dev)
    r_eff = torch.empty(B, dtype=F32, device=dev)
    counter, ptrs = None, None
    if pid is not None:
        if B > ACTOR_MAX_B:
            raise ValueError(f"{op}: the PID tail takes at most {ACTOR_MAX_B} "
                             "rows")
        gains = pid.gains
        vecs = (*gains, pid.cmdp.lam, pid.cmdp.integral, pid.cmdp.prev_err)
        for i, t in enumerate((*vecs, pid.lam, pid.violation)):
            build.check(op, f"pid[{i}]", t, F32, dev, (K,))
        build.check(op, "r_eff_mean", pid.r_eff_mean, F32, dev, ())
        counter = _counter(dev).data_ptr()
        ptrs = (ctypes.c_uint64 * 11)(
            *(t.data_ptr() for t in (*vecs, pid.r_eff_mean, pid.lam,
                                     pid.violation)))
    fn = build.bind("marginal", "marginal_target_launch",
              [P, LL, LL, LL, P, P, P, P, P, P, P, P, FL, P, P, I, I, I, I, I,
               I, P, P, P])
    with torch.cuda.device(dev):
        rc = fn(q1_all.data_ptr(), sb, st, sa, logp_dc1.data_ptr(),
                logp_g1.data_ptr(), r.data_ptr(), costs.data_ptr(),
                lam.data_ptr(), targets.data_ptr(), done.data_ptr(),
                log_alpha.data_ptr(), f32(gamma), tq.data_ptr(),
                r_eff.data_ptr(), B, n_dc, n_g, N, K, target_warps(A), counter,
                ptrs, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    marginal_target.launches += 1
    return tq, r_eff


marginal_target.launches = 0


def marginal_actor(q0_all, logp_dc, logp_g, log_alpha, loss_out=None,
                   temp=None):
    """B5b's actor term: (loss, H [B], dloss/dlogp_dc, dloss/dlogp_g), the
    loss into ``loss_out`` where given; with ``temp`` (an
    ``rl.sac.TempTail``) also the entropy's mean and the temperature's loss
    and gradient; the kernel on the card, ``rl.sac.marginal_actor`` on the
    CPU."""
    from ..rl import sac as rsac
    from ..rl.optim import f32

    if not build.on_card("marginal_actor", q0_all):
        return rsac.marginal_actor(q0_all, logp_dc, logp_g, log_alpha,
                                   loss_out, temp)
    dev = q0_all.device
    B, _, A, N = q0_all.shape
    n_dc, n_g = logp_dc.shape[1], logp_g.shape[1]
    if n_dc * n_g != A:
        raise ValueError(f"marginal_actor: {n_dc} x {n_g} heads for {A} actions")
    sb, st, sa = _q_view("marginal_actor", q0_all, dev)
    op = "marginal_actor"
    for name, t, shape in (("logp_dc", logp_dc, (B, n_dc)),
                           ("logp_g", logp_g, (B, n_g)),
                           ("log_alpha", log_alpha, ())):
        build.check(op, name, t, F32, dev, shape)
    loss = _scalar_out(op, "loss_out", loss_out, dev)
    outs = (None, None, None)
    if temp is not None:
        outs = tuple(_scalar_out(op, name, getattr(temp, name), dev)
                     for name in ("entropy", "alpha_loss", "alpha_grad"))
    ent = torch.empty(B, dtype=F32, device=dev)
    d_dc = torch.empty((B, n_dc), dtype=F32, device=dev)
    d_g = torch.empty((B, n_g), dtype=F32, device=dev)
    partial = torch.empty(B, dtype=F32, device=dev)
    counter = _counter(dev)
    fn = build.bind("marginal", "marginal_actor_launch",
              [P, LL, LL, LL, P, P, P, P, P, P, P, P, P, FL, P, P, P, I, I, I,
               I, P])
    with torch.cuda.device(dev):
        rc = fn(q0_all.data_ptr(), sb, st, sa, logp_dc.data_ptr(),
                logp_g.data_ptr(), log_alpha.data_ptr(), loss.data_ptr(),
                ent.data_ptr(), d_dc.data_ptr(), d_g.data_ptr(),
                partial.data_ptr(), counter.data_ptr(),
                f32(temp.target_entropy) if temp is not None else 0.0,
                *(None if t is None else t.data_ptr() for t in outs),
                B, n_dc, n_g, N, build.stream_of(dev))
    if rc != 0:
        raise build.launch_failed(op, rc)
    marginal_actor.launches += 1
    return loss, ent, d_dc, d_g


marginal_actor.launches = 0
