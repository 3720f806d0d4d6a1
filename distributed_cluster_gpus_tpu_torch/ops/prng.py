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
measures and bounds.
"""

from __future__ import annotations

import numpy as np
import torch

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


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s two words as an int64 [2] tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


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


def exponential(k):
    """``jax.random.exponential(k)``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(k))


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
