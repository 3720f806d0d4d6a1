"""B2: per-chunk arrival tables — a hand-written CUDA kernel and its plain
torch version.

Replaces the XLA-fused region ``WorkloadProgram.tables``
(``distributed_cluster_gpus_tpu/workload/compiler.py:218-384``) for the
families this slice ports (``off``, ``poisson``, ``sin_inv``).  Given the
workload key, each stream's draw cursor ``c0``, clock ``t0``, cumulative
Exp sum ``cum0`` and epoch, it returns ``sizes``, ``tnext`` and ``cum``
([S, n] float32), exactly what the JAX function returns.

:func:`arrival_tables` is the wrapper every caller uses: a CPU tensor takes
:func:`arrival_tables_reference`; a CUDA tensor launches
``csrc/arrival_tables.cu`` (built on first use) or raises.  The source's
head note gives the kernel's bound on the card and its design.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops import prng
from ..ops.arrivals import (ArrivalParams, MODE_SINUSOID, sample_job_size,
                            sinusoid_gap_from_cum, stream_draw_keys)

FAM_OFF, FAM_POISSON, FAM_SIN_INV = 0, 1, 2
#: sparams columns
RATE, AMP, PERIOD, PHASE = 0, 1, 2, 3

_argtypes = None


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"arrival_tables: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"arrival_tables: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"arrival_tables: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"arrival_tables: {name} must be contiguous")


def _validate(arr_key, c0, t0, cum0, epoch, family, sparams):
    S = int(c0.shape[0])
    dev = c0.device
    _check("arr_key", arr_key, torch.int64, (2,), dev)
    _check("c0", c0, torch.int32, (S,), dev)
    for name, t in (("t0", t0), ("cum0", cum0), ("epoch", epoch)):
        _check(name, t, torch.float32, (S,), dev)
    _check("family", family, torch.int32, (S,), dev)
    _check("sparams", sparams, torch.float32, (S, 4), dev)
    return S, dev


def arrival_tables_reference(arr_key, c0, t0, cum0, epoch, family, sparams,
                             n: int, with_aux: bool = False):
    """Plain torch version: the same draws, fold and inversion, op by op.

    Returns {"sizes", "tnext", "cum"} ([S, n] float32), plus with ``with_aux``
    "aux_key" ([S, n, 2] int32, each entry's k_gap key words) and "aux_u"
    ([S, n] float32, its uniform draw) — the kernel's debug outputs."""
    S, dev = _validate(arr_key, c0, t0, cum0, epoch, family, sparams)
    fam = family.tolist()
    sp = sparams.tolist()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    counts = c0.to(torch.int64)[:, None] + torch.arange(n, device=dev)
    sizes = torch.zeros((S, n), dtype=torch.float32, device=dev)
    inc = torch.zeros((S, n), dtype=torch.float32, device=dev)
    aux_key = torch.zeros((S, n, 2), dtype=torch.int32, device=dev)
    aux_u = torch.zeros((S, n), dtype=torch.float32, device=dev)
    for s in range(S):
        if fam[s] == FAM_OFF:
            continue
        k_size, k_gap = stream_draw_keys(arr_key, s, counts[s])
        sizes[s] = sample_job_size(k_size, s % 2)
        u = prng.uniform(k_gap)
        e = -torch.log1p(-u)
        if fam[s] == FAM_POISSON:
            rate = f32(sp[s][RATE])
            # e * (1/rate): XLA turns the division by the (constant) rate
            # into a multiply by its float32 reciprocal
            inc[s] = torch.where(rate > 0, e * (1.0 / torch.clamp(rate, min=1e-30)),
                                 f32(math.inf))
        else:
            inc[s] = e
        aux_key[s] = k_gap.to(torch.int32)
        aux_u[s] = u
    # the left fold, one add per entry (never a parallel cumsum: chunk
    # invariance needs exactly this association)
    carry = torch.where(family == FAM_SIN_INV, cum0, t0)
    cum = torch.empty((S, n), dtype=torch.float32, device=dev)
    for i in range(n):
        carry = carry + inc[:, i]
        cum[:, i] = carry
    tnext = torch.full((S, n), math.inf, dtype=torch.float32, device=dev)
    for s in range(S):
        if fam[s] == FAM_POISSON:
            tnext[s] = cum[s]
        elif fam[s] == FAM_SIN_INV:
            rate, amp, period, phase = sp[s]
            arr_p = ArrivalParams(MODE_SINUSOID, rate, amp, period)
            delta = sinusoid_gap_from_cum(arr_p, epoch[s] + f32(phase), cum[s])
            delta = torch.where(f32(rate) > 0, delta, f32(math.inf))
            tnext[s] = epoch[s] + delta
    out = {"sizes": sizes, "tnext": tnext, "cum": cum}
    if with_aux:
        out.update(aux_key=aux_key, aux_u=aux_u)
    return out


def _lib():
    global _argtypes
    from . import build

    lib = build.load("arrival_tables")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.arrival_tables_launch.argtypes = [P, P, P, P, P, P, P, I, I,
                                              P, P, P, P, P, P]
        lib.arrival_tables_launch.restype = ctypes.c_int
        _argtypes = True
    return lib


def arrival_tables(arr_key, c0, t0, cum0, epoch, family, sparams, n: int,
                   with_aux: bool = False):
    """The B2 wrapper: kernel on a CUDA tensor, plain version on a CPU one.

    Counts each kernel launch in ``arrival_tables.launches``."""
    S, dev = _validate(arr_key, c0, t0, cum0, epoch, family, sparams)
    if dev.type == "cpu":
        return arrival_tables_reference(arr_key, c0, t0, cum0, epoch, family,
                                        sparams, n, with_aux=with_aux)
    if dev.type != "cuda":
        raise ValueError(f"arrival_tables: unsupported device {dev}")
    if n <= 0:
        raise ValueError("arrival_tables: n must be positive")
    lib = _lib()
    sizes = torch.empty((S, n), dtype=torch.float32, device=dev)
    tnext = torch.empty((S, n), dtype=torch.float32, device=dev)
    cum = torch.empty((S, n), dtype=torch.float32, device=dev)
    aux_key = aux_u = None
    if with_aux:
        aux_key = torch.empty((S, n, 2), dtype=torch.int32, device=dev)
        aux_u = torch.empty((S, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.arrival_tables_launch(
            arr_key.data_ptr(), c0.data_ptr(), t0.data_ptr(), cum0.data_ptr(),
            epoch.data_ptr(), family.data_ptr(), sparams.data_ptr(), S, n,
            sizes.data_ptr(), tnext.data_ptr(), cum.data_ptr(),
            aux_key.data_ptr() if with_aux else None,
            aux_u.data_ptr() if with_aux else None, stream)
    if rc != 0:
        raise RuntimeError(f"arrival_tables kernel launch failed: cudaError {rc}")
    arrival_tables.launches += 1
    out = {"sizes": sizes, "tnext": tnext, "cum": cum}
    if with_aux:
        out.update(aux_key=aux_key, aux_u=aux_u)
    return out


arrival_tables.launches = 0
