"""Threefry-2x32 keys and samplers, bit-compatible with ``jax.random``.

The JAX package draws every random number from ``jax.random`` with the
partitionable threefry implementation (``jax_threefry_partitionable``, the
default since jax 0.5).  The port reproduces that stream so the same seed
realizes the same workload and routing:

* a key is an ``int64`` tensor ``[..., 2]`` holding two 32-bit words.  Words
  live in int64 and are masked with ``0xFFFFFFFF`` after every add and
  shift, because torch's uint32 shift/xor coverage on CUDA is partial;
* ``key(seed)`` is ``(seed >> 32, seed & 0xFFFFFFFF)`` (jax ``threefry_seed``);
* ``fold_in(k, d)`` and ``split(k, n)[i]`` are both one threefry block on
  the counter ``(0, d)`` / ``(0, i)`` (jax ``threefry_fold_in`` and
  ``_threefry_split_foldlike``);
* 32 random bits for a scalar draw are the xor of the two output words of
  the block on counter ``(0, 0)`` (jax ``_threefry_random_bits_partitionable``).

Key words, random bits, ``uniform`` and ``randint`` are bit-exact with
jax.  ``exponential`` and ``normal`` go through ``log1p`` (and for the
normal, XLA's single-precision ``erf_inv`` polynomial, reproduced here with
its fused multiply-adds emulated in float64); ``log1p`` differs from XLA's
by at most an ulp on some inputs, which ``tests/test_torch_ops.py``
measures and bounds.  ``truncated_normal`` and flax's static fold-in
(``fold_in_static``) derive the networks' initial weights as flax's
``lecun_normal`` draws them (``rl/nets.py``).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ..device import resolve_device

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(k1, k2, c1, c2):
    """The Threefry-2x32 block (20 rounds) on int64-held 32-bit words.

    All four arguments broadcast; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (c1 + ks[0]) & MASK
    x1 = (c2 + ks[1]) & MASK
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.key(seed)``'s two words as an int64 [2] tensor on
    ``device`` (the card unless the caller asks for the CPU)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _block(k, counter):
    """Threefry block of key(s) ``k`` [..., 2] on counter ``(0, counter)``."""
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    return threefry2x32(k[..., 0], k[..., 1], zero, counter)


def fold_in(k, data):
    """``jax.random.fold_in``; ``data`` an int or an int tensor (batched)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    o0, o1 = _block(k, d)
    return torch.stack([o0, o1], dim=-1)


def split(k, num: int = 2):
    """``jax.random.split(k, num)``: keys ``[..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    o0, o1 = _block(k[..., None, :], i)
    return torch.stack([o0, o1], dim=-1)


def random_bits(k):
    """32 random bits (int64) for a scalar draw from each key ``[..., 2]``."""
    o0, o1 = _block(k, torch.zeros((), dtype=torch.int64, device=k.device))
    return o0 ^ o1


def bits_to_unit_float(bits):
    """jax ``_uniform``'s mantissa trick: a float32 in [0, 1)."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(k, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(k, (), float32, minval, maxval)`` per key."""
    f = bits_to_unit_float(random_bits(k))
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform_vec(k, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(k, (n,), float32, minval, maxval)``: element i
    from the bits of the block on counter ``(0, i)``; ``[..., n]``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    o0, o1 = _block(k[..., None, :], i)
    f = bits_to_unit_float(o0 ^ o1)
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


#: float32's smallest normal number (the Gumbel sampler's uniform floor)
TINY_F32 = float(np.finfo(np.float32).tiny)


def gumbel(k, n: int):
    """``jax.random.gumbel(k, (n,))`` in jax's default ("low") mode:
    ``-log(-log(u))``, ``u`` uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform_vec(k, n, TINY_F32, 1.0)))


def categorical(k, logits):
    """``jax.random.categorical(k, logits)`` over the last axis (Gumbel-max,
    the first maximum wins): int64 indices.  ``torch.log`` may differ from
    XLA's by an ulp, so the action agrees with jax's except where the two
    largest perturbed logits lie within an ulp or so of each other
    (``tests/test_torch_rl_policy.py`` states the margin)."""
    return torch.argmax(gumbel(k, logits.shape[-1]) + logits, dim=-1)


def exponential(k):
    """``jax.random.exponential(k)``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(k))


# ---------------------------------------------------------------------------
# float64 draws (the float64 clock: jax under ``jax_enable_x64`` draws its
# unpinned samples in float64).  The 64 random bits of a scalar draw are
# ``(o0 << 32) | o1`` of the same threefry block whose 32-bit draw is
# ``o0 ^ o1`` (jax ``_threefry_random_bits_partitionable``), so a float64
# draw costs no more rounds than a float32 one.
# ---------------------------------------------------------------------------

_ONE_F64_BITS = 0x3FF0000000000000


def random_bits64(k):
    """64 random bits for a scalar draw from each key ``[..., 2]``, as the
    pair of 32-bit words (hi, lo) held in int64."""
    return _block(k, torch.zeros((), dtype=torch.int64, device=k.device))


def words_to_unit_double(hi, lo):
    """jax ``_uniform``'s mantissa trick in float64: the top 52 of the 64
    bits ``hi:lo`` under the exponent of 1.0, less 1: a float64 in [0, 1)."""
    mant = (hi << 20) | (lo >> 12)
    return (mant | _ONE_F64_BITS).view(torch.float64) - 1.0


def uniform64(k, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(k, (), float64, minval, maxval)`` per key."""
    f = words_to_unit_double(*random_bits64(k))
    lo = torch.tensor(minval, dtype=torch.float64, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float64, device=k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform_vec64(k, n: int):
    """``jax.random.uniform(k, (n,), float64)``: element i from the 64 bits
    of the block on counter ``(0, i)``; ``[..., n]``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    return words_to_unit_double(*_block(k[..., None, :], i))


def exponential64(k):
    """``jax.random.exponential(k, (), float64)``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform64(k))


#: XLA's double-precision ``erf_inv`` (Giles' three-branch polynomial, read
#: from the optimized HLO of ``jax.scipy.special.erfinv`` on float64): the
#: coefficients for w < 6.25 (23), w < 16 (19) and w >= 16 (17)
ERFINV64_SMALL = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
    6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
    1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027)
ERFINV64_MID = (
    2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
    0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
    -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
    3.0838856104922208)
ERFINV64_LARGE = (
    -2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
    7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.8499064014085844)


def erfinv_f64(x):
    """XLA's double-precision ``erf_inv``: ``w = -log1p(-x*x)``, then Horner
    on ``w - 3.125`` (w < 6.25), ``sqrt(w) - 3.25`` (w < 16) or
    ``sqrt(w) - 5``, each step ``c + p*w`` rounded twice (no fused
    multiply-add, as ``csrc/arrival_tables.cu`` computes it under
    ``-fmad=false``); ``x * inf`` at |x| = 1.  XLA's CPU code may contract
    some steps, so this agrees with ``jnp``'s to the ulps
    ``tests/test_torch_clock64_draws.py`` states."""
    f64 = dict(dtype=torch.float64, device=x.device)
    w = -torch.log1p(-(x * x))
    small = w < 6.25
    mid = w < 16.0
    z = torch.where(small, w - 3.125,
                    torch.sqrt(w) - torch.where(mid, torch.tensor(3.25, **f64),
                                                torch.tensor(5.0, **f64)))

    def coef(i):
        c_s = torch.tensor(ERFINV64_SMALL[i], **f64)
        c_m = torch.tensor(ERFINV64_MID[i], **f64) if i < 19 else c_s
        c_l = torch.tensor(ERFINV64_LARGE[i], **f64) if i < 17 else c_m
        return torch.where(small, c_s, torch.where(mid, c_m, c_l))

    p = coef(0)
    for i in range(1, 23):
        step = coef(i) + p * z
        # past a branch's last coefficient its value stands
        if i >= 19:
            step = torch.where(small, step, p)
        elif i >= 17:
            step = torch.where(mid, step, p)
        p = step
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO64 = float(np.nextafter(np.float64(-1.0), np.float64(0.0)))
_SQRT2_F64 = float(np.sqrt(2.0))


def normal64(k):
    """``jax.random.normal(k, (), float64)``: ``sqrt(2) * erf_inv(u)``, u
    in (-1, 1)."""
    return _SQRT2_F64 * erfinv_f64(uniform64(k, _NORMAL_LO64, 1.0))


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x):
    """XLA's single-precision ``erf_inv`` (Giles' polynomial).

    ``torch.erfinv`` uses another approximation and lands hundreds of ulps
    away from XLA's; this is the same polynomial with each Horner step
    ``c + p*w`` rounded once, as XLA's fused multiply-add rounds it (the
    product of two float32 values is exact in float64)."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    w64 = w.double()
    p = coef[0]
    for c in coef[1:]:
        p = (c.double() + p.double() * w64).float()
    out = p * x
    big = torch.tensor(np.finfo(np.float32).max, dtype=torch.float32,
                       device=x.device)
    return torch.where(x.abs() == 1.0, x * big, out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def normal(k):
    """``jax.random.normal(k)``: ``sqrt(2) * erf_inv(u)``, u in (-1, 1)."""
    u = uniform(k, _NORMAL_LO, 1.0)
    return erfinv_f32(u) * _SQRT2_F32


def truncated_normal(k, lower: float, upper: float, shape):
    """``jax.random.truncated_normal(k, lower, upper, shape)`` in float32, on
    ``k``'s device: ``a = erf(lower / sqrt2)``, ``b = erf(upper / sqrt2)``,
    ``u`` uniform in [a, b) (element i from the block on counter ``(0, i)``
    of the flattened shape; bit-exact), ``sqrt2 * erf_inv(u)`` clamped to
    ``[nextafter(lower, +inf), nextafter(upper, -inf)]``.  The values go
    through XLA's ``erf_inv`` (:func:`erfinv_f32`) and agree with jax's to
    the ulps ``tests/test_torch_rl_init.py`` states."""
    f32 = torch.float32
    sqrt2 = torch.tensor(_SQRT2_F32, dtype=f32)
    lo = torch.tensor(lower, dtype=f32)
    hi = torch.tensor(upper, dtype=f32)
    a, b = float(torch.erf(lo / sqrt2)), float(torch.erf(hi / sqrt2))
    inf = torch.tensor(float("inf"), dtype=f32)
    lo_in = float(torch.nextafter(lo, inf))
    hi_in = float(torch.nextafter(hi, -inf))
    n = 1
    for d in shape:
        n *= int(d)
    # jax's uniform in [a, b): XLA contracts ``f * (b - a) + a`` into one
    # fused multiply-add, emulated in float64 (the product and the sum are
    # exact there, so the one rounding is the FMA's)
    span = float(np.float32(b) - np.float32(a))
    f = uniform_vec(k, n).double()
    u = torch.clamp_min((f * span + a).to(f32), a).reshape(tuple(shape))
    out = erfinv_f32(u) * _SQRT2_F32
    return torch.clamp(out, lo_in, hi_in)


def fold_in_static(k, parts, separator: bool = False):
    """flax's ``LazyRng`` fold of static data (``flax/core/scope.py``
    ``_fold_in_static``): SHA-1 over ``parts`` (a string as UTF-8, an int
    as its minimal big-endian bytes; each part preceded by a zero byte when
    flax's ``flax_fix_rng_separator`` is set, off by default), the digest's
    first 4 bytes read big-endian, then :func:`fold_in`.  With no parts the
    key is returned as it is."""
    if not parts:
        return k
    m = hashlib.sha1()
    for x in parts:
        if separator:
            m.update(b"\0")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"fold_in_static: expected int or str, got {x!r}")
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def _randint_reduce(hi, lo, maxval: int):
    span = max(int(maxval), 1)
    mult = (2 ** 16 % span) ** 2 % span
    return ((hi % span) * mult + lo % span) % span


def randint(k, maxval: int):
    """``jax.random.randint(k, (), 0, maxval, int32)``: two 32-bit draws
    reduced modulo the span (jax ``_randint``), bit-exact."""
    ks = split(k, 2)
    off = _randint_reduce(random_bits(ks[..., 0, :]),
                          random_bits(ks[..., 1, :]), maxval)
    return off.to(torch.int32)


# ---------------------------------------------------------------------------
# Host scalar forms.  The event loop's per-event key chain is a handful of
# scalar blocks; on the host they cost microseconds, where the tensor form
# would launch some sixty tiny kernels per event.  Same function, Python
# ints (tests hold the two forms equal).
# ---------------------------------------------------------------------------

def threefry2x32_int(k1: int, k2: int, c1: int, c2: int):
    """:func:`threefry2x32` on Python ints."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (c1 + ks[0]) & MASK
    x1 = (c2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def split_int(k, num: int = 2):
    """:func:`split` of a key given as a pair of ints; a list of pairs."""
    return [threefry2x32_int(k[0], k[1], 0, i) for i in range(num)]


def randint_int(k, maxval: int) -> int:
    """:func:`randint` of a key given as a pair of ints."""
    (a0, a1), (b0, b1) = split_int(k, 2)
    hi = threefry2x32_int(a0, a1, 0, 0)
    lo = threefry2x32_int(b0, b1, 0, 0)
    return _randint_reduce(hi[0] ^ hi[1], lo[0] ^ lo[1], maxval)
