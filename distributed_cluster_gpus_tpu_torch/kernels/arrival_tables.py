"""B2: per-chunk arrival tables — a hand-written CUDA kernel and its plain
torch version.

Replaces the XLA-fused region ``WorkloadProgram.tables``
(``distributed_cluster_gpus_tpu/workload/compiler.py:218-384``) for the
families this slice ports (``off``, ``poisson``, ``sin_inv``).  Given the
workload key, each stream's draw cursor ``c0``, clock ``t0``, cumulative
Exp sum ``cum0`` and epoch, it returns ``sizes``, ``tnext`` and ``cum``
([S, n] float32), exactly what the JAX function returns; clocks in float64
(the float64 clock) take the kernel's double instance, as the JAX package
under ``jax_enable_x64`` draws them (float64 samplers, ``tnext`` and
``cum`` float64, ``sizes`` float32).  With a leading
lane axis (``arr_key`` [R, 2], the per-stream inputs [R, S]) one launch
builds every rollout lane's tables ([R, S, n]); each lane's are bit for bit
its single-lane tables.

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
    """(lanes, S, device); ``lanes`` is () or (R,), the leading axis of
    the per-lane inputs."""
    if c0.dim() not in (1, 2):
        raise ValueError(f"arrival_tables: c0 must be [S] or [R, S], got "
                         f"{tuple(c0.shape)}")
    lanes = tuple(c0.shape[:-1])
    S = int(c0.shape[-1])
    dev = c0.device
    _check("arr_key", arr_key, torch.int64, lanes + (2,), dev)
    _check("c0", c0, torch.int32, lanes + (S,), dev)
    td = t0.dtype
    if td not in (torch.float32, torch.float64):
        raise TypeError(f"arrival_tables: the clocks must be float32 or float64, "
                        f"got {td}")
    for name, t in (("t0", t0), ("cum0", cum0), ("epoch", epoch)):
        _check(name, t, td, lanes + (S,), dev)
    _check("family", family, torch.int32, (S,), dev)
    _check("sparams", sparams, torch.float32, (S, 4), dev)
    return lanes, S, dev


def arrival_tables_reference(arr_key, c0, t0, cum0, epoch, family, sparams,
                             n: int, with_aux: bool = False):
    """Plain torch version: the same draws, fold and inversion, op by op
    (the draws and the inversion lane by lane when the inputs carry a lane
    axis, the fold every lane at once: each entry's adds are the same).

    Returns {"sizes", "tnext", "cum"} ([S, n], [R, S, n] with lanes: sizes
    float32, the others in the clocks' dtype), plus with ``with_aux``
    "aux_key" ([..., S, n, 2] int32, each entry's k_gap key words) and
    "aux_u" ([..., S, n], its uniform draw) — the kernel's debug outputs."""
    lanes, _, dev = _validate(arr_key, c0, t0, cum0, epoch, family, sparams)
    fam = family.tolist()
    sp = sparams.tolist()
    td = t0.dtype
    if lanes:
        per = [_draws(arr_key[r], c0[r], fam, sp, n, td)
               for r in range(lanes[0])]
        draws = {k: torch.stack([d[k] for d in per]) for k in per[0]}
    else:
        draws = _draws(arr_key, c0, fam, sp, n, td)
    # the left fold, one add per entry (never a parallel cumsum: chunk
    # invariance needs exactly this association)
    inc = draws.pop("inc")
    carry = torch.where(family == FAM_SIN_INV, cum0, t0)
    cum = torch.empty(inc.shape, dtype=td, device=dev)
    for i in range(n):
        carry = carry + inc[..., i]
        cum[..., i] = carry
    tnext = (torch.stack([_tnext(cum[r], epoch[r], fam, sp)
                          for r in range(lanes[0])]) if lanes
             else _tnext(cum, epoch, fam, sp))
    out = {"sizes": draws["sizes"], "tnext": tnext, "cum": cum}
    if with_aux:
        out.update(aux_key=draws["aux_key"], aux_u=draws["aux_u"])
    return out


def _draws(arr_key, c0, fam, sp, n: int, td):
    """One lane's entries: sizes, the fold's increments and the gap draws'
    key words and uniforms ([S, n] each, the keys [S, n, 2])."""
    S, dev = len(fam), c0.device
    uniform = prng.uniform64 if td == torch.float64 else prng.uniform
    counts = c0.to(torch.int64)[:, None] + torch.arange(n, device=dev)
    sizes = torch.zeros((S, n), dtype=torch.float32, device=dev)
    inc = torch.zeros((S, n), dtype=td, device=dev)
    aux_key = torch.zeros((S, n, 2), dtype=torch.int32, device=dev)
    aux_u = torch.zeros((S, n), dtype=td, device=dev)
    for s in range(S):
        if fam[s] == FAM_OFF:
            continue
        k_size, k_gap = stream_draw_keys(arr_key, s, counts[s])
        sizes[s] = sample_job_size(k_size, s % 2, td).to(torch.float32)
        u = uniform(k_gap)
        e = -torch.log1p(-u)
        if fam[s] == FAM_POISSON:
            rate = torch.tensor(sp[s][RATE], dtype=torch.float32, device=dev)
            # e * (1/rate): XLA turns the division by the (constant) rate
            # into a multiply by its reciprocal, in the draw's dtype (the
            # float32 rate widened under the float64 clock)
            inc[s] = torch.where(
                rate > 0, e * (1.0 / torch.clamp(rate, min=1e-30).to(td)),
                torch.tensor(math.inf, dtype=td, device=dev))
        else:
            inc[s] = e
        aux_key[s] = k_gap.to(torch.int32)
        aux_u[s] = u
    return {"sizes": sizes, "inc": inc, "aux_key": aux_key, "aux_u": aux_u}


def _tnext(cum, epoch, fam, sp):
    """One lane's next arrivals from its folded clocks ([S, n])."""
    td, dev = cum.dtype, cum.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    tnext = torch.full(cum.shape, math.inf, dtype=td, device=dev)
    for s in range(len(fam)):
        if fam[s] == FAM_POISSON:
            tnext[s] = cum[s]
        elif fam[s] == FAM_SIN_INV:
            rate, amp, period, phase = sp[s]
            arr_p = ArrivalParams(MODE_SINUSOID, rate, amp, period)
            delta = sinusoid_gap_from_cum(arr_p, epoch[s] + f32(phase).to(td),
                                          cum[s])
            delta = torch.where(f32(rate) > 0, delta,
                                torch.tensor(math.inf, dtype=td, device=dev))
            tnext[s] = epoch[s] + delta
    return tnext


def _lib():
    global _argtypes
    from . import build

    lib = build.load("arrival_tables")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.arrival_tables_launch, lib.arrival_tables64_launch):
            fn.argtypes = [P, P, P, P, P, P, P, I, I, I, P, P, P, P, P, P]
            fn.restype = ctypes.c_int
        _argtypes = True
    return lib


def arrival_tables(arr_key, c0, t0, cum0, epoch, family, sparams, n: int,
                   with_aux: bool = False):
    """The B2 wrapper: kernel on a CUDA tensor, plain version on a CPU one.

    Counts each kernel launch in ``arrival_tables.launches``."""
    lanes, S, dev = _validate(arr_key, c0, t0, cum0, epoch, family, sparams)
    if dev.type == "cpu":
        return arrival_tables_reference(arr_key, c0, t0, cum0, epoch, family,
                                        sparams, n, with_aux=with_aux)
    if dev.type != "cuda":
        raise ValueError(f"arrival_tables: unsupported device {dev}")
    if n <= 0:
        raise ValueError("arrival_tables: n must be positive")
    R = lanes[0] if lanes else 1
    if R > 65535:
        raise ValueError("arrival_tables: at most 65,535 lanes per launch")
    lib = _lib()
    td = t0.dtype
    shape = lanes + (S, n)
    sizes = torch.empty(shape, dtype=torch.float32, device=dev)
    tnext = torch.empty(shape, dtype=td, device=dev)
    cum = torch.empty(shape, dtype=td, device=dev)
    aux_key = aux_u = None
    if with_aux:
        aux_key = torch.empty(shape + (2,), dtype=torch.int32, device=dev)
        aux_u = torch.empty(shape, dtype=td, device=dev)
    x64 = td == torch.float64
    launch = lib.arrival_tables64_launch if x64 else lib.arrival_tables_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            arr_key.data_ptr(), c0.data_ptr(), t0.data_ptr(), cum0.data_ptr(),
            epoch.data_ptr(), family.data_ptr(), sparams.data_ptr(), R, S, n,
            sizes.data_ptr(), tnext.data_ptr(), cum.data_ptr(),
            aux_key.data_ptr() if with_aux else None,
            aux_u.data_ptr() if with_aux else None, stream)
    if rc != 0:
        raise RuntimeError(f"arrival_tables kernel launch failed: cudaError {rc}")
    arrival_tables.launches += 1
    arrival_tables.x64_launches += x64
    out = {"sizes": sizes, "tnext": tnext, "cum": cum}
    if with_aux:
        out.update(aux_key=aux_key, aux_u=aux_u)
    return out


arrival_tables.launches = 0
#: launches of the double instance (the float64 clock)
arrival_tables.x64_launches = 0
