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

import math
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


def tree_sum_last(x):
    """Sum over the last axis with the reference's fixed halving-tree
    association (zero-padded to a power of two).  Never ``torch.sum`` on
    floats here: its order is not the reference's."""
    n = x.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.cat([x, torch.zeros(x.shape[:-1] + (p - n,), dtype=x.dtype,
                                      device=x.device)], dim=-1)
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


def fma_f32(a, b, c):
    """``a * b + c`` on float32 tensors rounded ONCE, as a fused multiply-add
    rounds it (XLA's CPU code contracts some products into FMAs; CUDA's
    ``__fmaf_rn``).  Computed in float64, where the product of two float32
    values is exact; the one case where rounding the float64 sum to float32
    would round twice (the sum landing exactly on a float32 midpoint while
    the float64 addition itself was inexact) is decided by the sign of the
    addition's exact error term, so the result equals a true FMA."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    toward = torch.where(s >= r.double(), torch.full_like(r, math.inf),
                         torch.full_like(r, -math.inf))
    other = torch.nextafter(r, toward)
    mid = s == (r.double() + other.double()) * 0.5
    fix = mid & (err != 0) & torch.isfinite(r)
    # at a midpoint the exact value lies on err's side of s
    pick = torch.where((err > 0) == (other > r), other, r)
    return torch.where(fix, pick, r)


def fma_f64(a, b, c):
    """``a * b + c`` on float64 tensors rounded once, as a fused
    multiply-add rounds it (XLA's CPU code contracts some float64 products
    into FMAs too; CUDA's ``fma``), by Boldo and Melquiond's emulation: the
    exact product (Veltkamp's split), the exact sum with ``c``, the two
    error terms added with rounding to odd, then one rounding to nearest.
    Exact for finite operands whose product neither overflows nor
    underflows (the clock's values)."""
    def split(x):
        t = x * 134217729.0  # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = c + p
    sb = s - c
    se = (c - (s - sb)) + (p - sb)
    v = se + pe
    vb = v - se
    ve = (se - (v - vb)) + (pe - vb)
    # round to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact value
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(ve > 0, torch.full_like(v, math.inf),
                         torch.full_like(v, -math.inf))
    v = torch.where((ve != 0) & even, torch.nextafter(v, toward), v)
    return s + v


def fma(a, b, c):
    """:func:`fma_f32` or :func:`fma_f64` by the operands' dtype."""
    return fma_f64(a, b, c) if a.dtype == torch.float64 else fma_f32(a, b, c)


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
