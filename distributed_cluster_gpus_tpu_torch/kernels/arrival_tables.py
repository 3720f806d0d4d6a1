"""B2: per-chunk arrival tables — a hand-written CUDA kernel and its plain
torch version.

Replaces the XLA-fused region ``WorkloadProgram.tables``
(``distributed_cluster_gpus_tpu/workload/compiler.py:218-470``) for every
stream family: ``off``, ``poisson``, ``sin_inv`` (the sinusoid's
inversion), ``trace`` (cursor gathers of replayed arrival times and
sizes), ``rate_timeline`` (the inversion of a piecewise-constant rate's
integrated rate) and ``thinning`` (the sinusoid with |amp| > 1: a
sequential replay of the rejection loop).  Given the workload key, each
stream's draw cursor ``c0``, clock ``t0``, cumulative Exp sum ``cum0`` and
epoch, and the per-stream constants of the trace and timeline families
(:class:`StreamConsts`, one packed buffer with per-stream offsets), it
returns ``sizes``, ``tnext`` and ``cum`` ([S, n] float32), exactly what
the JAX function returns; clocks in float64
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
from typing import NamedTuple, Optional

import torch

from ..ops import prng
from ..ops.physics import fma
from ..ops.arrivals import (ArrivalParams, MODE_SINUSOID, sample_job_size, tmod,
                            sinusoid_gap_from_cum, stream_draw_keys)

FAM_OFF, FAM_POISSON, FAM_SIN_INV, FAM_TRACE, FAM_RATE_TL, FAM_THIN = range(6)
#: the families whose fold carry is the cumulative Exp sum (``arr_cum``)
CUM_FAMILIES = (FAM_SIN_INV, FAM_RATE_TL)
#: the families that read :class:`StreamConsts`
CONST_FAMILIES = (FAM_TRACE, FAM_RATE_TL, FAM_THIN)
#: sparams columns
RATE, AMP, PERIOD, PHASE = 0, 1, 2, 3
#: StreamConsts.meta columns: the stream's offset into ``cbuf``, its length
#: (trace entries, timeline bins), its offset into ``sbuf`` and a flag (a
#: trace's explicit sizes, a periodic timeline)
M_OFF, M_LEN, M_SOFF, M_FLAG = 0, 1, 2, 3


class StreamConsts(NamedTuple):
    """The per-stream constants of the trace, rate_timeline and thinning
    families, packed for one launch.  ``cbuf`` [L] in the clock's dtype:
    a trace's times (rounded once from float64, as the reference's
    ``jnp.asarray`` rounds them under the float32 clock); a timeline's
    ``qc`` [T+1] (the float64 cumulative rate rounded once, not a float32
    cumsum), its ``rates`` [T], its ``bin_s`` and the wrap's span ``T *
    bin_s``; a thinning stream's phase.
    ``sbuf`` [M] float32: the traces' explicit sizes.  ``meta`` [S, 4]
    int32 (``M_*`` columns).  Build with :func:`pack_consts`."""

    cbuf: torch.Tensor
    sbuf: torch.Tensor
    meta: torch.Tensor


def pack_consts(families, streams, tdtype, device) -> StreamConsts:
    """Pack the per-stream constants of ``streams`` (``StreamSpec`` of each
    flat stream, ``families`` their ``FAM_*`` codes) on ``device``."""
    import numpy as np

    np_td = np.float64 if tdtype == torch.float64 else np.float32
    cbuf, sbuf, meta = [], [], []
    nc = ns = 0
    for fam, st in zip(families, streams):
        row = [nc, 0, ns, 0]
        if fam == FAM_TRACE:
            times = np.asarray(st.times, np.float64).reshape(-1)
            cbuf.append(times.astype(np_td))
            row[M_LEN] = times.size
            if st.sizes is not None and times.size:
                sbuf.append(np.asarray(st.sizes, np.float32).reshape(-1))
                row[M_FLAG] = 1
                ns += times.size
        elif fam == FAM_RATE_TL:
            rates = np.asarray(st.rates, np.float64).reshape(-1)
            qc = np.concatenate([[0.0], np.cumsum(rates * st.bin_s)])
            # the wrap's span T * bin_s is the reference's Python product,
            # rounded once to the clock's dtype
            cbuf += [qc.astype(np_td), rates.astype(np_td),
                     np.asarray([st.bin_s, rates.size * st.bin_s], np_td)]
            row[M_LEN] = rates.size
            row[M_FLAG] = int(bool(st.periodic))
        elif fam == FAM_THIN:
            cbuf.append(np.asarray([st.phase_s], np_td))
        nc = sum(a.size for a in cbuf)
        meta.append(row)
    flat = np.concatenate(cbuf) if cbuf else np.zeros(1, np_td)
    sz = np.concatenate(sbuf) if sbuf else np.zeros(1, np.float32)
    return StreamConsts(
        cbuf=torch.from_numpy(np.ascontiguousarray(flat)).to(device),
        sbuf=torch.from_numpy(np.ascontiguousarray(sz)).to(device),
        meta=torch.tensor(meta, dtype=torch.int32, device=device).reshape(-1, 4))

_argtypes = None


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"arrival_tables: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"arrival_tables: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"arrival_tables: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"arrival_tables: {name} must be contiguous")


def _validate(arr_key, c0, t0, cum0, epoch, family, sparams, consts):
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
    if consts is not None:
        _check("consts.cbuf", consts.cbuf, td, None, dev)
        _check("consts.sbuf", consts.sbuf, torch.float32, None, dev)
        _check("consts.meta", consts.meta, torch.int32, (S, 4), dev)
    return lanes, S, dev


def _host_consts(family, consts):
    """The families and the host copy of the constants (one read each)."""
    fam = family.tolist()
    if any(f in CONST_FAMILIES for f in fam) and consts is None:
        raise ValueError("arrival_tables: trace, rate_timeline and thinning "
                         "streams need their StreamConsts (pack_consts)")
    return fam, consts


def arrival_tables_reference(arr_key, c0, t0, cum0, epoch, family, sparams,
                             n: int, with_aux: bool = False,
                             consts: Optional[StreamConsts] = None):
    """Plain torch version: the same draws, fold, gathers, inversions and
    thinning replay, op by op (the inversions lane by lane when the inputs
    carry a lane axis, the fold and the thinning replay every lane at once,
    the draws too on the card: each entry's ops are the same).

    Returns {"sizes", "tnext", "cum"} ([S, n], [R, S, n] with lanes: sizes
    float32, the others in the clocks' dtype), plus with ``with_aux``
    "aux_key" ([..., S, n, 2] int32, each entry's k_gap key words) and
    "aux_u" ([..., S, n], its uniform draw) — the kernel's debug outputs
    (zero for the trace and thinning families, which draw no gap)."""
    lanes, _, dev = _validate(arr_key, c0, t0, cum0, epoch, family, sparams,
                              consts)
    fam, consts = _host_consts(family, consts)
    sp = sparams.tolist()
    td = t0.dtype
    keys, cur = arr_key.reshape(-1, 2), c0.reshape(-1, c0.shape[-1])
    if dev.type == "cpu":
        # lane by lane: the CPU's vectorized pow/exp round a SIMD body and
        # its scalar tail apart, so a lane's draws would depend on its
        # place in the batch (the card's elementwise ops do not)
        per = [_draws(keys[r:r + 1], cur[r:r + 1], fam, sp, n, td, consts)
               for r in range(keys.shape[0])]
        draws = {k: torch.cat([d[k] for d in per]) for k in per[0]}
    else:
        draws = _draws(keys, cur, fam, sp, n, td, consts)
    if not lanes:
        draws = {k: v[0] for k, v in draws.items()}
    # the left fold, one add per entry (never a parallel cumsum: chunk
    # invariance needs exactly this association)
    inc = draws.pop("inc")
    uses_cum = (family == FAM_SIN_INV) | (family == FAM_RATE_TL)
    carry = torch.where(uses_cum, cum0, t0)
    cum = torch.empty(inc.shape, dtype=td, device=dev)
    for i in range(n):
        carry = carry + inc[..., i]
        cum[..., i] = carry
    if lanes:
        tnext = torch.stack([_tnext(cum[r], epoch[r], fam, sp, c0[r], n,
                                    consts) for r in range(lanes[0])])
    else:
        tnext = _tnext(cum, epoch, fam, sp, c0, n, consts)
    thin = [s for s, f in enumerate(fam) if f == FAM_THIN]
    if thin:
        # every lane's thinning rows in one replay (a row per lane and stream)
        R = lanes[0] if lanes else 1
        rows = torch.tensor(thin, dtype=torch.int64, device=dev)
        keys = arr_key.reshape(R, 1, 2).expand(R, len(thin), 2).reshape(-1, 2)
        phase = torch.stack([consts.cbuf[_meta(consts, s)[M_OFF]] for s in thin])
        out_rows = thinning_replay(
            keys, rows.repeat(R), c0.reshape(R, -1)[:, rows].reshape(-1),
            t0.reshape(R, -1)[:, rows].reshape(-1), [sp[s] for s in thin] * R,
            phase.repeat(R), n)
        tnext.reshape(R, len(fam), n)[:, rows] = out_rows.reshape(R, len(thin), n)
    out = {"sizes": draws["sizes"], "tnext": tnext, "cum": cum}
    if with_aux:
        out.update(aux_key=draws["aux_key"], aux_u=draws["aux_u"])
    return out


def _meta(consts, s):
    return consts.meta[s].tolist() if consts is not None else [0, 0, 0, 0]


def _draws(arr_key, c0, fam, sp, n: int, td, consts):
    """Every lane's entries (``arr_key`` [R, 2], ``c0`` [R, S]): sizes, the
    fold's increments and the gap draws' key words and uniforms ([R, S, n]
    each, the keys [R, S, n, 2])."""
    R, S, dev = c0.shape[0], len(fam), c0.device
    uniform = prng.uniform64 if td == torch.float64 else prng.uniform
    counts = c0.to(torch.int64)[..., None] + torch.arange(n, device=dev)
    keys = arr_key[:, None, :]
    sizes = torch.zeros((R, S, n), dtype=torch.float32, device=dev)
    inc = torch.zeros((R, S, n), dtype=td, device=dev)
    aux_key = torch.zeros((R, S, n, 2), dtype=torch.int32, device=dev)
    aux_u = torch.zeros((R, S, n), dtype=td, device=dev)
    for s in range(S):
        if fam[s] == FAM_OFF:
            continue
        off, length, soff, flag = _meta(consts, s)
        k_size, k_gap = stream_draw_keys(keys, s, counts[:, s])
        if fam[s] == FAM_TRACE and flag:
            # explicit sizes, read at count - 1 (the reference's index: the
            # draw cursor counts draw #0, spent by init_clocks)
            idx = torch.clamp(counts[:, s] - 1, 0, length - 1)
            sizes[:, s] = consts.sbuf[soff:soff + length][idx]
        else:
            # only streams that consume keys draw them (an explicit-size
            # trace draws nothing)
            sizes[:, s] = sample_job_size(k_size, s % 2, td).to(torch.float32)
        if fam[s] in (FAM_TRACE, FAM_THIN):
            continue  # no gap draw: the clock comes from the gathers / replay
        u = uniform(k_gap)
        e = -torch.log1p(-u)
        if fam[s] == FAM_POISSON:
            rate = torch.tensor(sp[s][RATE], dtype=torch.float32, device=dev)
            # e * (1/rate): XLA turns the division by the (constant) rate
            # into a multiply by its reciprocal, in the draw's dtype (the
            # float32 rate widened under the float64 clock)
            inc[:, s] = torch.where(
                rate > 0, e * (1.0 / torch.clamp(rate, min=1e-30).to(td)),
                torch.tensor(math.inf, dtype=td, device=dev))
        else:
            inc[:, s] = e
        aux_key[:, s] = k_gap.to(torch.int32)
        aux_u[:, s] = u
    return {"sizes": sizes, "inc": inc, "aux_key": aux_key, "aux_u": aux_u}


def _tnext(cum, epoch, fam, sp, c0, n, consts):
    """One lane's next arrivals from its folded clocks ([S, n]; a thinning
    stream's come from :func:`thinning_replay`, over every lane at once)."""
    td, dev = cum.dtype, cum.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    inf = torch.tensor(math.inf, dtype=td, device=dev)
    tnext = torch.full(cum.shape, math.inf, dtype=td, device=dev)
    for s in range(len(fam)):
        off, length, _, flag = _meta(consts, s)
        if fam[s] == FAM_POISSON:
            tnext[s] = cum[s]
        elif fam[s] == FAM_SIN_INV:
            rate, amp, period, phase = sp[s]
            arr_p = ArrivalParams(MODE_SINUSOID, rate, amp, period)
            delta = sinusoid_gap_from_cum(arr_p, epoch[s] + f32(phase).to(td),
                                          cum[s])
            delta = torch.where(f32(rate) > 0, delta, inf)
            tnext[s] = epoch[s] + delta
        elif fam[s] == FAM_TRACE and length:
            idx = c0[s].to(torch.int64) + torch.arange(n, device=dev)
            times = consts.cbuf[off:off + length]
            tnext[s] = torch.where(idx < length,
                                   times[torch.clamp(idx, 0, length - 1)], inf)
        elif fam[s] == FAM_RATE_TL:
            tnext[s] = invert_timeline(consts.cbuf[off:off + 2 * length + 3],
                                       length, bool(flag), cum[s])
    return tnext


def invert_timeline(tl, T: int, periodic: bool, svals):
    """Lambda^{-1}(s) of a piecewise-constant rate timeline, elementwise
    over ``svals`` (the folded cumulative Exp sums, in the clock's dtype),
    as the JAX package's ``WorkloadProgram._invert_timeline`` computes it
    under XLA (read from its optimized CPU HLO): ``tl`` holds ``qc``
    [T+1], ``rates`` [T], ``bin_s`` and ``T * bin_s`` in the clock's dtype.

    XLA folds the timeline's total ``qc[T]`` and ``T * bin_s`` into
    constants, so ``floor(s / total)`` is ``floor(s * fl(1 / total))``;
    its CPU code contracts the wrap's remainder ``s - wraps * total`` and
    the final ``wraps * fl(T * bin_s) + t_in`` into fused multiply-adds
    (both clocks; measured against the JAX package, while ``b * bin_s +
    step`` stays two roundings); ``(srem - qc[b]) / rate`` divides by a
    gathered rate, a true division; ``b * bin_s`` multiplies the int32 bin
    converted to the clock's dtype.  A non-periodic timeline's
    ``0 + t_in`` is ``t_in``.  ``searchsorted``
    (side="right") puts a value equal to a boundary in the bin above it;
    a zero-rate landing bin gives ``b * bin_s`` when the value sits on its
    lower boundary, else inf; past a non-periodic timeline's end, inf."""
    td, dev = svals.dtype, svals.device
    qc, rates = tl[:T + 1], tl[T + 1:2 * T + 1]
    bs, span = tl[2 * T + 1], tl[2 * T + 2]
    inf = torch.tensor(math.inf, dtype=td, device=dev)
    if periodic:
        total = qc[T]
        wraps = torch.floor(svals * (torch.ones((), dtype=td, device=dev) / total))
        srem = fma(-wraps, total.expand_as(wraps), svals)
    else:
        srem = svals
    b = torch.clamp(torch.searchsorted(qc, srem.contiguous(), right=True) - 1,
                    0, T - 1)
    rb = rates[b]
    qb = qc[b]
    bt = b.to(td) * bs
    t_in = bt + (srem - qb) / torch.clamp(rb, min=1e-30)
    t_in = torch.where(rb > 0, t_in, torch.where(srem <= qb, bt, inf))
    if not periodic:
        return torch.where(srem > qc[T], inf, t_in)
    return fma(wraps, span.expand_as(t_in), t_in)


#: candidates the plain thinning replay draws at once per entry (a block;
#: more blocks only for an entry none of whose candidates accepted)
THIN_BLOCK = 32
#: the rejection loop's bound (the reference's ``1 << 22``)
THIN_MAX_CANDIDATES = 1 << 22


def thinning_replay(arr_key, streams, c0, t0, sps, phase, n: int):
    """The sequential thinning replay of the given sinusoid streams (the
    JAX package's ``WorkloadProgram._thinning_replay``): for each entry i,
    ``t' = t + next_interarrival(k_gap(c0 + i), p, t + phase)`` by Ogata's
    rejection loop against ``lam_max = rate (1 + |amp|)``, each candidate
    splitting its key into three (an Exp(lam_max) gap and a uniform that
    accepts when ``u <= lambda(t + phase + w) / lam_max``), at most 2^22
    candidates an entry.

    A candidate's draws and its gap's left fold ``w_j = w_(j-1) + gap_j``
    do not depend on the clock, so they are drawn for every entry at once,
    ``THIN_BLOCK`` candidates deep (a block more only when some entry has
    accepted none); the entries then run in order, each testing its
    candidates at once against the clock the entry before left and taking
    the first that accepts: every value is the sequential loop's, op for
    op.  ``arr_key`` [2] or a row's [M, 2], ``streams`` [M] int64, ``c0``
    [M] int32, ``t0`` and ``phase`` [M] in the clock's dtype, ``sps`` the
    rows' sparams; returns [M, n] in the clock's dtype."""
    td, dev = t0.dtype, t0.device
    x64 = td == torch.float64
    uniform = prng.uniform64 if x64 else prng.uniform
    exponential = prng.exponential64 if x64 else prng.exponential
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    rate = f32([p[RATE] for p in sps])
    amp = f32([p[AMP] for p in sps])
    period = f32([p[PERIOD] for p in sps])
    lam_max = rate * (1.0 + torch.abs(amp))
    denom = torch.clamp(lam_max, min=1e-30).to(td)
    period_t = period.to(td)[:, None]
    live = lam_max > 0
    inf = torch.tensor(math.inf, dtype=td, device=dev)
    M = len(sps)
    counts = c0.to(torch.int64)[:, None] + torch.arange(n, device=dev)
    ks = prng.fold_in(arr_key, streams)
    key = prng.split(prng.fold_in(ks[:, None, :], counts), 2)[..., 1, :]
    blocks = {"gap_sum": [], "u": [], "key": key,
              "w": torch.zeros((M, n), dtype=td, device=dev)}

    def more():
        """The next THIN_BLOCK candidates of every entry: [M, n, B] folds
        and uniforms."""
        ws, us = [], []
        k, w = blocks["key"], blocks["w"]
        for _ in range(THIN_BLOCK):
            kk = prng.split(k, 3)
            k = kk[..., 0, :]
            w = w + exponential(kk[..., 1, :]) / denom[:, None]
            ws.append(w)
            us.append(uniform(kk[..., 2, :]))
        blocks["key"], blocks["w"] = k, w
        blocks["gap_sum"].append(torch.stack(ws, -1))
        blocks["u"].append(torch.stack(us, -1))

    more()
    out = torch.empty((M, n), dtype=td, device=dev)
    t = t0.clone()
    rows = torch.arange(M, device=dev)

    def entry(i):
        """Entry i from the clock ``t`` (advanced in place), as many blocks
        of candidates deep as its rows need."""
        tq = (t + phase)[:, None]
        w_i = torch.zeros_like(t)
        done = ~live
        b = 0
        while True:
            if b == len(blocks["gap_sum"]):
                more()
            wc = blocks["gap_sum"][b][:, i]
            u = blocks["u"][b][:, i]
            acc = _accepts(tq, wc, u, period_t, rate, amp, denom) & ~done[:, None]
            hit = acc.any(-1)
            last = (b + 1) * THIN_BLOCK >= THIN_MAX_CANDIDATES
            if last:  # the bound: an entry still rejecting takes its last
                hit = ~done
                acc = acc | (~done[:, None] & (torch.arange(
                    THIN_BLOCK, device=dev) == THIN_BLOCK - 1))
            first = torch.argmax(acc.to(torch.int8), dim=-1)
            w_i = torch.where(hit, wc[rows, first], w_i)
            done = done | hit
            b += 1
            if last or bool(done.all()):
                break
        t.copy_(t + torch.where(live & torch.isfinite(w_i), w_i, inf))
        out[:, i] = t

    for i in range(n):
        entry(i)
    return out


def _accepts(tq, wc, u, period_t, rate, amp, denom):
    """[M, B] acceptance of the candidates at folds ``wc`` of entries whose
    clock plus phase is ``tq`` ([M, 1]): ``u <= lambda(tq + w) /
    lam_max``, lambda the clamped sinusoid at ``(2 pi mod(x, period)) /
    period`` (``ops.arrivals.lambda_t``'s ops)."""
    x = tq + wc
    ph = (2.0 * math.pi) * tmod(x, period_t) / period_t
    lam = torch.clamp(rate[:, None] * (1.0 + amp[:, None] * torch.sin(ph)),
                      min=0.0)
    return u <= lam / denom[:, None]


def _lib():
    global _argtypes
    from . import build

    lib = build.load("arrival_tables")
    if _argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.arrival_tables_launch, lib.arrival_tables64_launch):
            fn.argtypes = [P, P, P, P, P, P, P, I, I, I, P, P, P, P, P, P, P,
                           P, P]
            fn.restype = ctypes.c_int
        _argtypes = True
    return lib


def arrival_tables(arr_key, c0, t0, cum0, epoch, family, sparams, n: int,
                   with_aux: bool = False,
                   consts: Optional[StreamConsts] = None):
    """The B2 wrapper: kernel on a CUDA tensor, plain version on a CPU one.

    ``consts`` (:func:`pack_consts`) carries the trace, rate_timeline and
    thinning streams' constants; a launch with such a stream and no consts
    raises.  Counts each kernel launch in ``arrival_tables.launches``."""
    lanes, S, dev = _validate(arr_key, c0, t0, cum0, epoch, family, sparams,
                              consts)
    if dev.type == "cpu":
        return arrival_tables_reference(arr_key, c0, t0, cum0, epoch, family,
                                        sparams, n, with_aux=with_aux,
                                        consts=consts)
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
    cptr = (lambda t: t.data_ptr() if consts is not None else None)  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            arr_key.data_ptr(), c0.data_ptr(), t0.data_ptr(), cum0.data_ptr(),
            epoch.data_ptr(), family.data_ptr(), sparams.data_ptr(), R, S, n,
            sizes.data_ptr(), tnext.data_ptr(), cum.data_ptr(),
            aux_key.data_ptr() if with_aux else None,
            aux_u.data_ptr() if with_aux else None,
            cptr(consts.cbuf) if consts is not None else None,
            cptr(consts.sbuf) if consts is not None else None,
            cptr(consts.meta) if consts is not None else None, stream)
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
