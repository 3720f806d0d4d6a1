"""UCB1 DVFS bandit as tensor state (the ``bandit`` algorithm).

Counterpart of ``distributed_cluster_gpus_tpu/ops/bandit.py``: one arm per
(dc, jtype, frequency level); every arm is pulled once in ladder order,
then UCB1 ``mean + sqrt(2 ln t / n)`` picks the arm (ties to the lowest
index), with reward ``-cost_per_unit``.  The state's tensors are updated in
place.

``ln t`` is :func:`xla_log_f32`, the polynomial XLA's CPU code evaluates
for a float32 ``log`` (a Cephes-style range reduction and degree-8
polynomial, its products contracted into fused multiply-adds), so the UCB
term and the chosen arm are bit for bit the JAX package's
(``tests/test_torch_bandit.py`` holds it to ``jnp.log`` over every float32
in [1, 2^24]); torch's own ``log`` differs from it by an ulp at about one
integer in a hundred.
"""

from __future__ import annotations

import dataclasses
import struct

import torch

from .physics import fma_f32


@dataclasses.dataclass
class BanditState:
    N: torch.Tensor  # [n_dc, 2, n_f] int32 pull counts
    S: torch.Tensor  # [n_dc, 2, n_f] f32 summed rewards
    t: torch.Tensor  # int32: select calls


def bandit_init(n_dc: int, n_f: int, device) -> BanditState:
    return BanditState(
        N=torch.zeros((n_dc, 2, n_f), dtype=torch.int32, device=device),
        S=torch.zeros((n_dc, 2, n_f), dtype=torch.float32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device))


#: the polynomial's coefficients as float32 bit patterns, in evaluation order
#: (p0..p8 of the mantissa polynomial, then the split ln 2 = q2 - q1)
_LOG_BITS = {
    "p0": 0x3D9021BB, "p1": 0xBDEBD1B8, "p2": 0x3DEF251A,
    "p3": 0xBDFE5D4F, "p4": 0x3E11E9BF, "p5": 0xBE2AAE50,
    "p6": 0x3E4CCEAC, "p7": 0xBE7FFFFC, "p8": 0x3EAAAAAA,
    "q1": 0xB95E8083, "q2": 0x3F318000,
}
SQRT_HALF_BITS = 0x3F3504F3
MIN_NORMAL_BITS = 0x00800000


def f32_of_bits(b: int) -> float:
    return struct.unpack("<f", struct.pack("<I", b))[0]


LOG_CONSTS = {k: f32_of_bits(v) for k, v in _LOG_BITS.items()}


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """``log`` of a positive finite float32 tensor exactly as XLA's CPU code
    computes it: its lowered IR op for op (frexp-style range reduction to
    m in [sqrt(0.5), sqrt(2)), the polynomial in Horner pairs, ``e * ln 2``
    in two parts), with every ``a * b + c`` whose product feeds only that
    sum rounded once, as the CPU backend contracts it into a fused
    multiply-add (:func:`~.physics.fma_f32`).  Inputs <= 0, inf and NaN are
    not this module's (the bandit takes the log of a count >= 1)."""
    f32 = torch.float32
    dev = x.device
    c = {k: torch.tensor(v, dtype=f32, device=dev) for k, v in LOG_CONSTS.items()}
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    x = torch.maximum(x.to(f32), torch.tensor(f32_of_bits(MIN_NORMAL_BITS),
                                              dtype=f32, device=dev))
    bits = x.view(torch.int32)
    e = (torch.bitwise_right_shift(bits, 23) - 127).to(f32)
    mb = torch.bitwise_or(torch.bitwise_and(bits, -2139095041), 1056964608)
    m = mb.view(f32)  # mantissa in [0.5, 1)
    e = one + e
    small = m < torch.tensor(f32_of_bits(SQRT_HALF_BITS), dtype=f32, device=dev)
    e = e - torch.where(small, one, zero)
    x = (m - one) + torch.where(small, m, zero)
    x2 = x * x
    x3 = x2 * x
    y = fma_f32(x, c["p0"], c["p1"])
    y1 = fma_f32(x, c["p3"], c["p4"])
    y2 = fma_f32(x, c["p6"], c["p7"])
    y = fma_f32(y, x, c["p2"])
    y1 = fma_f32(y1, x, c["p5"])
    y2 = fma_f32(y2, x, c["p8"])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, c["q1"] * e)
    r = fma_f32(torch.tensor(-0.5, dtype=f32, device=dev), x2, x) + y
    return fma_f32(c["q2"], e, r)


def bandit_select(state: BanditState, dc, jtype, init_explore: int = 1):
    """(f_idx, t + 1) for (dc, jtype): the first under-explored arm in ladder
    order, else the first maximum of the UCB.  The caller commits the new
    select count (``state.t``) only where the start fires."""
    t = state.t + 1
    N = state.N[dc, jtype]
    S = state.S[dc, jtype]
    under = N < init_explore
    first_under = torch.argmax(under.to(torch.int32))
    n_safe = torch.clamp(N, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=N.device)
    mean = torch.where(N > 0, S / n_safe, zero)
    lt = xla_log_f32(torch.clamp(t.to(torch.float32), min=1.0))
    ucb = mean + torch.sqrt((lt * 2.0) / n_safe)
    best = torch.argmax(ucb)
    f_idx = torch.where(under.any(), first_under, best).to(torch.int32)
    return f_idx, t


def bandit_update(state: BanditState, dc, jtype, f_idx, cost_per_unit) -> None:
    """Record reward ``-cost_per_unit`` for arm (dc, jtype, f_idx), in place."""
    state.N[dc, jtype, f_idx] += 1
    state.S[dc, jtype, f_idx] -= cost_per_unit
