"""Stochastic workload generators (sinusoid / Poisson arrivals, job sizes).

Counterpart of ``distributed_cluster_gpus_tpu/ops/arrivals.py``.  The
samplers draw from ``ops/prng.py`` (jax's threefry stream), so a seed gives
the reference's arrival process; the transcendental functions (log1p, pow,
exp, sin/cos) are torch's and may differ from XLA's by an ulp or so, which
the tests bound.  Per-chunk tables are built in ``workload/compiler.py``
(and on the card by ``kernels/arrival_tables.py``); this module holds the
scalar and vectorised pieces they share.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import prng

MODE_OFF = 0
MODE_POISSON = 1
MODE_SINUSOID = 2

JTYPE_INFERENCE = 0

#: Pareto shape of inference sizes and its inverse exponent as float32 sees it
PARETO_ALPHA = 1.8
#: log-normal training sizes: max(0.1, exp(ln 50000 + 0.4 z))
LOGNORM_MU_ARG = 50000.0
LOGNORM_SIGMA = 0.4
N_BISECT = 30


class ArrivalParams(NamedTuple):
    """One stream's arrival process: int mode (MODE_*) and float32 shape."""

    mode: int
    rate: float
    amp: float
    period: float


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def tmod(a, b):
    """``a % b`` with Python/jnp semantics (sign of the divisor), exact."""
    r = torch.fmod(a, b)
    b_t = torch.as_tensor(b, dtype=r.dtype, device=r.device)
    fix = (r != 0) & ((r < 0) != (b_t < 0))
    return torch.where(fix, r + b_t, r)


def lambda_t(p: ArrivalParams, t):
    """Instantaneous rate lambda(t) >= 0 of one stream (float32 ``t``)."""
    dev = t.device
    if p.mode == MODE_POISSON:
        return torch.full_like(t, float(p.rate))
    if p.mode != MODE_SINUSOID:
        return torch.zeros_like(t)
    period = _f32(p.period, dev)
    ph = (2.0 * math.pi) * tmod(t, period) / period
    sin_rate = _f32(p.rate, dev) * (1.0 + _f32(p.amp, dev) * torch.sin(ph))
    return torch.clamp(sin_rate, min=0.0)


def _exponential_safe(k, lam: float):
    """Exp(lam) sample; +inf when lam <= 0."""
    u = prng.exponential(k)
    if lam > 0:
        return u / _f32(max(lam, 1e-30), k.device)
    return torch.full_like(u, math.inf)


def next_interarrival(k, p: ArrivalParams, t) -> torch.Tensor:
    """Next inter-arrival gap of one stream at absolute time ``t`` (scalar).

    Poisson: one Exp(rate) draw.  Sinusoid: Ogata thinning against
    ``lam_max = rate * (1 + |amp|)`` — each candidate splits the key into
    three, draws an Exp(lam_max) gap and a uniform, and accepts when
    ``u <= lambda(t + w) / lam_max``.  Only draw #0 of each stream comes
    from here (``WorkloadProgram.init_clocks``), so the accept flag is read
    back to the host once per candidate."""
    dev = k.device
    f32 = lambda x: _f32(x, dev)  # noqa: E731
    lam_max = float(f32(p.rate) * (1.0 + abs(f32(p.amp))))
    if p.mode == MODE_POISSON:
        return _exponential_safe(k, p.rate)
    if p.mode != MODE_SINUSOID:
        return f32(math.inf)
    if not lam_max > 0:
        return f32(math.inf)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    w = f32(0.0)
    lam_max_t = f32(lam_max)
    denom = f32(max(lam_max, 1e-30))
    for _ in range(1 << 22):
        ks = prng.split(k, 3)
        k, k_w, k_u = ks[0], ks[1], ks[2]
        gap = prng.exponential(k_w) / torch.maximum(lam_max_t, f32(1e-30))
        w = w + gap
        u = prng.uniform(k_u)
        if bool(u <= lambda_t(p, t + w) / denom):
            break
    return torch.where(torch.isfinite(w), w, f32(math.inf))


def sinusoid_gap_from_cum(p: ArrivalParams, t0, s):
    """Inversion sampling of the sinusoid NHPP: ``delta >= 0`` with
    ``integral of lambda over (t0, t0 + delta] == s``, for |amp| <= 1, by a
    fixed 30-step bisection on the closed-form integrated rate (vectorised
    over ``s``; ``t0`` a float32 scalar tensor)."""
    dev = s.device
    f32 = lambda x: _f32(x, dev)  # noqa: E731
    r = f32(p.rate)
    a_signed = f32(p.amp)
    a = a_signed.abs()
    period = f32(p.period)
    # a tensor numerator: ``scalar / tensor`` is reciprocal-then-multiply
    w = f32(2.0 * math.pi) / period
    phase0 = w * tmod(t0, period)
    cos0 = torch.cos(phase0)
    coef = r * a_signed / w

    def gap_integral(d):
        return r * d + coef * (cos0 - torch.cos(phase0 + w * d))

    lo = s / torch.clamp(r * (1.0 + a), min=1e-30)
    hi = torch.minimum(s / torch.clamp(r * (1.0 - a), min=1e-9),
                       (s / torch.clamp(r * period, min=1e-30) + 1.0) * period)
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        under = gap_integral(mid) < s
        lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
    return 0.5 * (lo + hi)


def stream_draw_keys(arr_key, stream: int, count):
    """(k_size, k_gap) for arrival ``count`` (int or [n] tensor) of stream
    ``stream``: ``split(fold_in(fold_in(arr_key, stream), count))``."""
    k = prng.fold_in(prng.fold_in(arr_key, stream), count)
    ks = prng.split(k, 2)
    return ks[..., 0, :], ks[..., 1, :]


def sample_job_size(k, jtype: int):
    """Job sizes (work units) for keys ``k`` [..., 2] of one job type.

    inference: Pareto(x_m=1, alpha=1.8) by inverse CDF on u in (0, 1];
    training: max(0.1, LogNormal(ln 50000, 0.4))."""
    ks = prng.split(k, 2)
    k_u, k_n = ks[..., 0, :], ks[..., 1, :]
    dev = k.device
    if jtype == JTYPE_INFERENCE:
        u = torch.clamp(1.0 - prng.uniform(k_u), min=1e-9)
        return 1.0 / torch.pow(u, _f32(1.0 / PARETO_ALPHA, dev))
    z = prng.normal(k_n)
    mu = torch.log(_f32(LOGNORM_MU_ARG, dev))
    return torch.clamp(torch.exp(mu + LOGNORM_SIGMA * z), min=0.1)
