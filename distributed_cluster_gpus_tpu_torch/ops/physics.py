"""DVFS power / latency / energy models as broadcastable torch functions.

Counterpart of ``distributed_cluster_gpus_tpu/ops/physics.py``:

    P_gpu(f)  = alpha_p * f^3 + beta_p * f + gamma_p          [W per GPU]
    P_task    = n * P_gpu(f)                                  [W]
    T(n, f)   = alpha_t + beta_t / f               (n == 1)   [s per unit]
              = (alpha_t + beta_t / f + gamma_t*n) / n  (n>1)
    E(n, f)   = P_task * T                                    [J per unit]

Every value rounds exactly as the JAX package rounds it: products go
through :func:`fmul_pinned` (one rounding, and the same signed zero),
``f**3`` is ``(f*f)*f`` and division by ``f`` is ``b * (1/f)``.  Eager
torch never contracts ``a*b + c`` into a fused multiply-add, so none of
the fused ops (``addcmul``, ``lerp``) may appear at these sites.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PowerCoeffs(NamedTuple):
    """P(f) = alpha_p * f^3 + beta_p * f + gamma_p  (W per GPU)."""

    alpha_p: torch.Tensor
    beta_p: torch.Tensor
    gamma_p: torch.Tensor


class LatencyCoeffs(NamedTuple):
    """T(n, f) = alpha_t + beta_t / f + gamma_t * n  (s per unit)."""

    alpha_t: torch.Tensor
    beta_t: torch.Tensor
    gamma_t: torch.Tensor


def fmul_pinned(a, b):
    """``a * b`` rounded once, plus the JAX package's ``a * 0`` fence.

    The fence add changes no finite product but does decide the sign of a
    zero product (``-0 + +0 == +0``), so it is kept literally for
    bit-identity with the reference."""
    prod = a * b
    return prod + a * torch.zeros((), dtype=prod.dtype, device=prod.device)


def fdiv_pinned(a, b):
    """``a / b`` as ``a * (1/b)``, the reference's one definition."""
    return fmul_pinned(a, 1.0 / b)


def gpu_power_w(f, pc: PowerCoeffs):
    """Per-GPU power draw at normalised frequency ``f``."""
    f = torch.clamp(f, min=0.0)
    return (fmul_pinned(pc.alpha_p, (f * f) * f) + fmul_pinned(pc.beta_p, f)
            + pc.gamma_p)


def task_power_w(n, f, pc: PowerCoeffs):
    """Power of an n-GPU job: n * P_gpu(f); n clamped to >= 0."""
    n = torch.clamp(n, min=0)
    return fmul_pinned(n, gpu_power_w(f, pc))


def step_time_s(n, f, tc: LatencyCoeffs):
    """Seconds per work unit for an n-GPU job at frequency f (no scale-out
    penalty for n == 1, as in the reference)."""
    n = torch.clamp(n, min=1)
    f = torch.clamp(f, min=1e-9)
    base = tc.alpha_t + fdiv_pinned(tc.beta_t, f)
    return torch.where(n == 1, base, (base + fmul_pinned(tc.gamma_t, n)) / n)
